"""Recurrent layers: LSTM, GravesLSTM (peepholes), GravesBidirectionalLSTM.

Port of deeplearning4j_tpu/nn/layers/recurrent.py. All four gates come
from ONE [*, 4H] matmul per step, the input projection x.W for all
timesteps is hoisted out of the time loop, and gate order in the packed
4H axis is [i, f, g(cell), o].

Dispatch of `scan_sequence`, as in the JAX package: an eligible sequence
(no mask, sigmoid gates, tanh activation, float32 or bfloat16; see
`ops.lstm.fused_lstm_available`) runs through `ops.lstm.LSTMCore`, which
launches the hand-written kernel `csrc/lstm_scan.cu` for CUDA tensors
and its plain twin for CPU tensors. A masked or otherwise ineligible
sequence runs the plain per-step loop with autograd through it, the
JAX package's `lax.scan` path. `wavefront_scan_stack` runs a stack of
unidirectional LSTM layers as one plain-torch wavefront schedule; the
instance switch `MultiLayerNetwork.lstm_wavefront` is the only switch
(the JAX package's DL4JTPU_WAVEFRONT has no counterpart).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch

from deeplearning4j_tpu_torch.nn.activations import get_activation
from deeplearning4j_tpu_torch.nn.conf import inputs as it
from deeplearning4j_tpu_torch.nn.conf.serde import register
from deeplearning4j_tpu_torch.nn.layers.base import BaseLayer
from deeplearning4j_tpu_torch.nn.weights import init_weights
from deeplearning4j_tpu_torch.ops.lstm import (fused_lstm_available,
                                               fused_lstm_scan)

Tensor = torch.Tensor


@register
@dataclass
class LSTM(BaseLayer):
    """Standard LSTM (no peepholes) over [B, T, F] -> [B, T, H]."""
    n_in: Optional[int] = None
    n_out: Optional[int] = None
    forget_gate_bias_init: float = 1.0
    gate_activation: str = "sigmoid"

    peephole: bool = False

    @property
    def family(self) -> str:
        return "rnn"

    def update_input_type(self, input_type):
        if isinstance(input_type, it.InputTypeRecurrent):
            if self.n_in is None:
                self.n_in = input_type.size
            return it.InputType.recurrent(self.n_out,
                                          input_type.time_series_length)
        raise ValueError(f"{type(self).__name__} needs recurrent input, "
                         f"got {input_type}")

    def init_params(self, gen, dtype=torch.float32, device=None
                    ) -> Dict[str, Tensor]:
        h = self.n_out
        scheme = self.weight_init or "xavier"
        w = init_weights(gen, (self.n_in, 4 * h), self.n_in, h, scheme,
                         self.dist, dtype, device)
        rw = init_weights(gen, (h, 4 * h), h, h, scheme, self.dist, dtype,
                          device)
        b = torch.zeros((4 * h,), dtype=dtype, device=device)
        # forget-gate bias init (reference: conf field forgetGateBiasInit)
        b[h:2 * h] = self.forget_gate_bias_init
        params = {"W": w, "RW": rw, "b": b}
        if self.peephole:
            for k in ("pI", "pF", "pO"):
                params[k] = torch.zeros((h,), dtype=dtype, device=device)
        return params

    def weight_param_keys(self):
        return ("W", "RW")

    def _gates(self, params, xw_t, h_prev, c_prev):
        """One step's gate math. xw_t: [B, 4H] precomputed input
        projection."""
        z = xw_t + torch.matmul(h_prev, params["RW"]) + params["b"]
        return self._gates_from_z(params, z, c_prev)

    def _gates_from_z(self, params, z, c_prev):
        """Gate math from a fully-formed pre-activation z [B, 4H] (input
        projection + recurrence + bias already summed): the entry point
        the cross-layer wavefront shares with the per-layer loop."""
        zi, zf, zg, zo = torch.chunk(z, 4, dim=-1)
        gate = get_activation(self.gate_activation)
        act = get_activation(self.activation or "tanh")
        if self.peephole:
            i = gate(zi + c_prev * params["pI"])
            f = gate(zf + c_prev * params["pF"])
        else:
            i = gate(zi)
            f = gate(zf)
        g = act(zg)
        c = f * c_prev + i * g
        if self.peephole:
            o = gate(zo + c * params["pO"])
        else:
            o = gate(zo)
        h = o * act(c)
        return h, c

    # Unidirectional LSTMs carry (h, c) across rnn_time_step calls and
    # TBPTT chunks; bidirectional overrides this to False (its backward
    # pass needs the full sequence).
    supports_streaming = True

    def initial_carry(self, batch: int, dtype=torch.float32, device=None):
        h = torch.zeros((batch, self.n_out), dtype=dtype, device=device)
        c = torch.zeros((batch, self.n_out), dtype=dtype, device=device)
        return (h, c)

    def scan_sequence(self, params, x, carry=None, mask=None, reverse=False):
        """Run the full sequence: x [B, T, F] -> (outputs [B, T, H],
        carry). The input projection for ALL timesteps is one matmul
        outside the time loop."""
        b = x.shape[0]
        if carry is None:
            carry = self.initial_carry(b, x.dtype, x.device)
        if fused_lstm_available(x, self.n_out, mask, self.gate_activation,
                                self.activation or "tanh"):
            return fused_lstm_scan(params, x, carry, reverse=reverse)
        xw_t = torch.matmul(x, params["W"]).transpose(0, 1)  # [T, B, 4H]
        mask_t = (None if mask is None
                  else mask.to(x.dtype).transpose(0, 1)[..., None])
        h_prev, c_prev = carry
        t = xw_t.shape[0]
        ys = [None] * t
        for s in (range(t - 1, -1, -1) if reverse else range(t)):
            h, c = self._gates(params, xw_t[s], h_prev, c_prev)
            if mask_t is not None:
                # masked steps pass state through unchanged, output 0
                m = mask_t[s]
                ys[s] = m * h
                h = m * h + (1 - m) * h_prev
                c = m * c + (1 - m) * c_prev
            else:
                ys[s] = h
            h_prev, c_prev = h, c
        return torch.stack(ys, dim=1), (h_prev, c_prev)

    def apply(self, params, state, x, *, train=False, key=None, mask=None
              ) -> Tuple[Tensor, Dict]:
        ys, _ = self.scan_sequence(params, x, mask=mask)
        return ys, state

    def step(self, params, carry, x_t):
        """Single-timestep inference (reference: rnnTimeStep)."""
        xw_t = torch.matmul(x_t, params["W"])
        h_prev, c_prev = carry
        h, c = self._gates(params, xw_t, h_prev, c_prev)
        return (h, c), h


def wavefront_scan_stack(layers, plist, x, carries=None):
    """Run a STACK of unidirectional LSTM layers as one wavefront scan.

    Schedule: T + n - 1 steps; at step s, layer j advances to time s - j,
    consuming h_{j-1}[s-j], exactly the carry layer j-1 holds BEFORE its
    own update this step. Layer j's recurrence and layer j+1's input
    projection therefore share one operand and fuse into a single
    [B,H]x[H,8H] GEMM per layer. An exact reordering of the per-layer
    scans: each layer's cell math runs through its own _gates_from_z, and
    a layer off the wavefront keeps its state, so states and final
    carries equal the sequential schedule's.

    x: [B, T, F] -> (outputs of the LAST layer [B, T, H_last],
    [per-layer (h, c) final carries]).
    """
    n = len(layers)
    b, t = x.shape[0], x.shape[1]
    xw0t = torch.matmul(x, plist[0]["W"]).transpose(0, 1)  # [T, B, 4H0]
    if carries is None:
        carries = [l.initial_carry(b, x.dtype, x.device) for l in layers]
    fused_w = []
    for j in range(n):
        if j + 1 < n:
            fused_w.append(torch.cat([plist[j]["RW"], plist[j + 1]["W"]],
                                     dim=1))
        else:
            fused_w.append(plist[j]["RW"])
    state = [tuple(c) for c in carries]
    ys = []
    for s in range(t + n - 1):
        hs = [c[0] for c in state]
        gem = [torch.matmul(hs[j], fused_w[j]) for j in range(n)]
        new = []
        for j, lay in enumerate(layers):
            if not (j <= s < t + j):        # off the wavefront: keep
                new.append(state[j])
                continue
            h4 = 4 * lay.n_out
            inp = (xw0t[s] if j == 0
                   else gem[j - 1][:, 4 * layers[j - 1].n_out:])
            z = inp + gem[j][:, :h4] + plist[j]["b"]
            new.append(lay._gates_from_z(plist[j], z, state[j][1]))
        state = new
        if s >= n - 1:
            ys.append(state[-1][0])
    return torch.stack(ys, dim=1), list(state)


def wavefront_eligible_run(layers, names, start, *, train, mask,
                           carries, preprocessors, enabled=True):
    """Longest run of fusable LSTM layers beginning at ``start`` (>=2
    indices, else []). Fusable: plain unidirectional LSTM/GravesLSTM
    (supports_streaming), no mask, no inter-layer preprocessor or
    (train-time) dropout inside the run, and the streaming-carries dict
    either covers the whole run or none of it. ``enabled=False`` (the
    instance switch MultiLayerNetwork.lstm_wavefront) disables."""
    if not enabled or mask is not None:
        return []

    def fusable(lay):
        return isinstance(lay, LSTM) and lay.supports_streaming
    if not fusable(layers[start]):
        return []
    run = [start]
    for j in range(start + 1, len(layers)):
        lay = layers[j]
        if not fusable(lay):
            break
        if preprocessors.get(str(j)) is not None:
            break
        if train and (lay.dropout or 0.0) > 0:
            break
        run.append(j)
    if len(run) < 2:
        return []
    if carries is not None:
        inside = [names[j] in carries for j in run]
        if any(inside) and not all(inside):
            return []
    return run


@register
@dataclass
class GravesLSTM(LSTM):
    """LSTM with peephole connections (the reference's Graves
    formulation); the peepholes are separate [H] vectors pI, pF, pO."""

    def __post_init__(self):
        self.peephole = True

    def weight_param_keys(self):
        return ("W", "RW")


@register
@dataclass
class GravesBidirectionalLSTM(LSTM):
    """Bidirectional Graves LSTM. ``mode``='add' sums forward and backward
    activations (the reference's behavior); 'concat' concatenates
    (doubling output size)."""
    mode: str = "add"

    supports_streaming = False  # backward direction needs the full sequence

    def __post_init__(self):
        self.peephole = True

    def update_input_type(self, input_type):
        out = super().update_input_type(input_type)
        if self.mode == "concat":
            return it.InputType.recurrent(2 * self.n_out,
                                          out.time_series_length)
        return out

    def init_params(self, gen, dtype=torch.float32, device=None
                    ) -> Dict[str, Tensor]:
        fwd = super().init_params(gen, dtype, device)
        bwd = super().init_params(gen, dtype, device)
        params = {f"F{k}": v for k, v in fwd.items()}
        params.update({f"B{k}": v for k, v in bwd.items()})
        return params

    def weight_param_keys(self):
        return ("FW", "FRW", "BW", "BRW")

    def _split_dir(self, params, prefix):
        return {k[1:]: v for k, v in params.items() if k.startswith(prefix)}

    def apply(self, params, state, x, *, train=False, key=None, mask=None
              ) -> Tuple[Tensor, Dict]:
        fwd_p = self._split_dir(params, "F")
        bwd_p = self._split_dir(params, "B")
        ys_f, _ = self.scan_sequence(fwd_p, x, mask=mask, reverse=False)
        ys_b, _ = self.scan_sequence(bwd_p, x, mask=mask, reverse=True)
        if self.mode == "concat":
            return torch.cat([ys_f, ys_b], dim=-1), state
        return ys_f + ys_b, state

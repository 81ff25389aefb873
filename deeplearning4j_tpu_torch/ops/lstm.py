"""Fused LSTM scan: the Hopper kernel, its plain twin and their autograd.

Port of deeplearning4j_tpu/ops/lstm.py. The Pallas `_lstm_step_kernel`
(the Graves peephole LSTM forward over all T steps) becomes
`csrc/lstm_scan.cu`, one launch per layer and sequence, in one of two
variants: "tc" (`csrc/lstm_scan_tc.cuh`: a thread-block cluster holds RW
in shared memory and runs the recurrent product on the tensor cores) for
a bfloat16 RW whose cluster slice fits, "simt" otherwise; see the
source's header for their design and what bounds them on the card.

- `lstm_scan_reference`: the plain twin of the TPU `_forward`, a Python
  loop over T with the same casts and gate order, returning the float32
  (hs, cs, gates) reserve.
- `lstm_scan_split_reference`: the same with the "tc" kernel's arithmetic
  for the recurrent product (h as three bf16 parts).
- `_lstm_variant`: which kernel a call takes, from dtypes and shape alone.
- `lstm_scan_cuda`: launches the kernel; counts its launches (in all and
  per variant).
- `lstm_scan`: CUDA tensors take the kernel (or raise for what it does not
  take); CPU tensors take the twin.
- `LSTMCore`: the autograd Function of `_lstm_core`. Forward: `lstm_scan`.
  Backward: `_core_bwd`'s reverse loop in float32 over the saved reserve;
  the per-step elementwise factors and the parameter sums are taken over
  all T at once, outside the loop. The JAX backward is a `lax.scan`, not a
  Pallas kernel, so it has no kernel here either.
- `fused_lstm_available`, `fused_lstm_scan`: the layer-level dispatch of
  `nn/layers/recurrent.py`.
"""
from __future__ import annotations

from typing import Tuple

import torch

from deeplearning4j_tpu_torch.ops import _build

Tensor = torch.Tensor

# 28 * rows * H bytes of shared memory a CTA (h twice, c, z), in the 227 KB
# a block may use
_SMEM_LIMIT = 232448
# the largest H of the "tc" kernel: csrc/lstm_scan_tc.cuh's MAX_H, where a
# static_assert holds that its cluster slice fits at every B (the kernel
# picks its own cluster and row tiles from B and H)
_TC_MAX_H = 352


def _scan(xw_t, h0, c0, rw, b, pi, pf, po, dtype, product
          ) -> Tuple[Tensor, Tensor, Tensor]:
    """The peephole LSTM over T in `dtype`, the recurrent term h.RW formed
    by `product(h, RW)` (both in `dtype`)."""
    t, bsz, h4 = xw_t.shape
    hdim = h4 // 4
    rw_d = rw.to(dtype)
    b_d = b.to(dtype).reshape(1, h4)
    pi_d, pf_d, po_d = (p.to(dtype).reshape(1, hdim) for p in (pi, pf, po))
    h = h0.to(dtype)
    c = c0.to(dtype)
    hs = torch.empty((t, bsz, hdim), dtype=dtype, device=xw_t.device)
    cs = torch.empty_like(hs)
    gates = torch.empty((t, bsz, h4), dtype=dtype, device=xw_t.device)
    for s in range(t):
        z = xw_t[s].to(dtype) + product(h, rw_d) + b_d
        zi, zf, zg, zo = torch.split(z, hdim, dim=-1)
        i = torch.sigmoid(zi + c * pi_d)
        f = torch.sigmoid(zf + c * pf_d)
        g = torch.tanh(zg)
        c = f * c + i * g
        o = torch.sigmoid(zo + c * po_d)
        h = o * torch.tanh(c)
        hs[s] = h
        cs[s] = c
        gates[s] = torch.cat([i, f, g, o], dim=-1)
    return hs, cs, gates


def lstm_scan_reference(xw_t, h0, c0, rw, b, pi, pf, po,
                        dtype=torch.float32
                        ) -> Tuple[Tensor, Tensor, Tensor]:
    """Plain twin of the kernel: xw_t [T, B, 4H] (the hoisted x.W, gate
    order [i, f, g, o]), carries h0, c0 [B, H], RW [H, 4H], b [4H] and
    peepholes [H] -> (hs [T, B, H], cs [T, B, H], gates [T, B, 4H]), all
    float32, with every input cast to float32 first (the TPU kernel's
    :57-81). `dtype` float64 runs the same math in float64, the exact
    function that tests anchor to."""
    return _scan(xw_t, h0, c0, rw, b, pi, pf, po, dtype, torch.matmul)


def _split3(h: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    """float32 h as three bf16 parts, hi + mid + lo = h (each part holds
    the next 8 significant bits)."""
    hi = h.bfloat16()
    r = h - hi.float()
    mid = r.bfloat16()
    return hi, mid, (r - mid.float()).bfloat16()


def _split_product(h: Tensor, rw: Tensor) -> Tensor:
    hi, mid, lo = (x.float() for x in _split3(h))
    return torch.matmul(hi, rw) + (torch.matmul(mid, rw)
                                   + torch.matmul(lo, rw))


def lstm_scan_split_reference(xw_t, h0, c0, rw, b, pi, pf, po
                              ) -> Tuple[Tensor, Tensor, Tensor]:
    """`lstm_scan_reference` with the "tc" kernel's recurrent product:
    h_prev split by `_split3`, z = xw + (hi.RW + (mid.RW + lo.RW)) + b,
    each part's product with the bf16-valued RW exact, summed in float32.
    RW must hold bf16 values (the kernel takes it in bfloat16)."""
    if not torch.equal(rw.float(), rw.bfloat16().float()):
        raise ValueError("lstm_scan_split_reference: RW must hold "
                         "bfloat16 values")
    return _scan(xw_t, h0, c0, rw, b, pi, pf, po, torch.float32,
                 _split_product)


def _lstm_variant(x_dtype, w_dtype, bsz: int, t: int, hdim: int) -> str:
    """The kernel a call takes, from dtypes and shape alone: "tc" for a
    bfloat16 RW at H up to _TC_MAX_H (where its cluster slice fits in
    shared memory at every B), "simt" otherwise (a float32 RW, a larger
    H). Neither the xw dtype nor B nor T changes the pick."""
    del x_dtype, bsz, t
    return "tc" if w_dtype == torch.bfloat16 and hdim <= _TC_MAX_H \
        else "simt"


def _rows_per_cta(bsz: int, hdim: int) -> int:
    """Batch rows a CTA owns: 8, or the smallest power of two holding a
    smaller batch, lowered until the CTA's shared memory fits."""
    rows = 8
    while rows > 1 and rows // 2 >= bsz:
        rows //= 2
    while rows > 1 and 28 * rows * hdim > _SMEM_LIMIT:
        rows //= 2
    return rows


def lstm_scan_cuda(xw_t, h0, c0, rw, b, pi, pf, po, variant=None
                   ) -> Tuple[Tensor, Tensor, Tensor]:
    """Launch csrc/lstm_scan.cu: one launch for the whole sequence.
    Takes xw_t and RW in float32 or bfloat16 (each its own dtype) and any
    B, T, H >= 1 whose CTA fits in shared memory (H <= 8301); the
    carries, bias and peepholes go in as float32 (exact for bf16 values).
    Raises for anything else. The kernel is `_lstm_variant`'s pick;
    `variant` names one instead, for comparing the two on the same inputs
    (a "tc" past its H or with a float32 RW raises). The "tc" kernel reads
    xw by 8-byte copies and refuses an xw that is not 8-byte aligned.
    Counts its launches, in all (`launches`) and per variant
    (`launches_tc`, `launches_simt`)."""
    if xw_t.ndim != 3 or not xw_t.is_cuda:
        raise ValueError(f"lstm_scan: xw_t must be a CUDA [T, B, 4H] "
                         f"tensor, got {tuple(xw_t.shape)} on "
                         f"{xw_t.device}")
    t, bsz, h4 = xw_t.shape
    hdim = h4 // 4
    if h4 % 4 or t < 1 or bsz < 1 or hdim < 1:
        raise ValueError(f"lstm_scan: bad xw_t shape {tuple(xw_t.shape)}")
    if tuple(h0.shape) != (bsz, hdim) or tuple(c0.shape) != (bsz, hdim):
        raise ValueError(f"lstm_scan: carries {tuple(h0.shape)}, "
                         f"{tuple(c0.shape)} do not match B={bsz}, "
                         f"H={hdim}")
    if tuple(rw.shape) != (hdim, h4) or b.numel() != h4 or \
            any(p.numel() != hdim for p in (pi, pf, po)):
        raise ValueError(f"lstm_scan: RW {tuple(rw.shape)}, b "
                         f"{tuple(b.shape)} or peepholes do not match "
                         f"H={hdim}")
    for x in (h0, c0, rw, b, pi, pf, po):
        if x.device != xw_t.device:
            raise ValueError("lstm_scan: every input must be on "
                             f"{xw_t.device}, got one on {x.device}")
    for name, x in (("xw_t", xw_t), ("RW", rw)):
        if x.dtype not in (torch.float32, torch.bfloat16):
            raise TypeError(f"lstm_scan kernel takes {name} in float32 or "
                            f"bfloat16, got {x.dtype}")
    if variant is None:
        variant = _lstm_variant(xw_t.dtype, rw.dtype, bsz, t, hdim)
    if variant not in ("tc", "simt"):
        raise ValueError(f"lstm_scan: unknown variant {variant!r}")
    if variant == "tc" and (rw.dtype != torch.bfloat16 or
                            hdim > _TC_MAX_H):
        raise ValueError(f"lstm_scan tc kernel takes a bfloat16 RW at H <= "
                         f"{_TC_MAX_H}, got {rw.dtype} at H={hdim}")
    rows = _rows_per_cta(bsz, hdim)
    if variant == "simt" and 28 * rows * hdim > _SMEM_LIMIT:
        raise ValueError(f"lstm_scan kernel: H={hdim} needs "
                         f"{28 * hdim} bytes of shared memory a batch row, "
                         f"over the {_SMEM_LIMIT} a block may use")
    f32 = torch.float32
    xw = xw_t.contiguous()
    if variant == "tc" and xw.data_ptr() % 8:
        raise ValueError("lstm_scan tc kernel: xw_t must start on an 8-byte "
                         "boundary (it is read by 8-byte copies)")
    rwc = rw.contiguous()
    h0f, c0f = (x.to(f32).contiguous() for x in (h0, c0))
    bf, pif, pff, pof = (x.to(f32).reshape(-1).contiguous()
                         for x in (b, pi, pf, po))
    hs = torch.empty((t, bsz, hdim), dtype=f32, device=xw.device)
    cs = torch.empty_like(hs)
    gates = torch.empty((t, bsz, h4), dtype=f32, device=xw.device)
    fn = _build.load("lstm_scan")
    err = fn(xw.data_ptr(), h0f.data_ptr(), c0f.data_ptr(), rwc.data_ptr(),
             bf.data_ptr(), pif.data_ptr(), pff.data_ptr(), pof.data_ptr(),
             hs.data_ptr(), cs.data_ptr(), gates.data_ptr(), t, bsz, hdim,
             _build.dtype_code(xw.dtype), _build.dtype_code(rwc.dtype), rows,
             int(variant == "tc"), _build.stream_ptr(xw.device))
    _build.check(err, f"lstm_scan ({variant})")
    lstm_scan_cuda.launches += 1
    if variant == "tc":
        lstm_scan_cuda.launches_tc += 1
    else:
        lstm_scan_cuda.launches_simt += 1
    return hs, cs, gates


lstm_scan_cuda.launches = 0
lstm_scan_cuda.launches_tc = 0
lstm_scan_cuda.launches_simt = 0


def lstm_scan(xw_t, h0, c0, rw, b, pi, pf, po
              ) -> Tuple[Tensor, Tensor, Tensor]:
    """The float32 (hs, cs, gates) of the peephole LSTM over xw_t
    [T, B, 4H]: the kernel for CUDA tensors, the plain twin for CPU
    tensors."""
    if xw_t.is_cuda:
        return lstm_scan_cuda(xw_t, h0, c0, rw, b, pi, pf, po)
    return lstm_scan_reference(xw_t, h0, c0, rw, b, pi, pf, po)


def _zeros_if_none(g, like):
    return torch.zeros_like(like) if g is None else g


class LSTMCore(torch.autograd.Function):
    """(xw_t, h0, c0, RW, b, pI, pF, pO) -> (ys_t [T, B, H], h_T, c_T) in
    xw_t's dtype (the `_lstm_core` custom_vjp). The reserve (hs, cs,
    gates) stays float32 for the backward. Gradients reach every input,
    h0 and c0 included; the TBPTT chunk stops them at the caller."""

    @staticmethod
    def forward(ctx, xw_t, h0, c0, rw, b, pi, pf, po):
        hs, cs, gates = lstm_scan(xw_t, h0, c0, rw, b, pi, pf, po)
        ctx.save_for_backward(hs, cs, gates, h0, c0, rw, b, pi, pf, po)
        ctx.xw_dtype = dt = xw_t.dtype
        return hs.to(dt), hs[-1].to(dt).clone(), cs[-1].to(dt).clone()

    @staticmethod
    def backward(ctx, dys, dh_last, dc_last):
        hs, cs, gates, h0, c0, rw, b, pi, pf, po = ctx.saved_tensors
        f32 = torch.float32
        t, bsz, hdim = hs.shape
        dys = _zeros_if_none(dys, hs).to(f32)
        dh = _zeros_if_none(dh_last, h0).to(f32)
        dc = _zeros_if_none(dc_last, c0).to(f32)
        rw32 = rw.to(f32)
        pi32, pf32, po32 = (p.to(f32).reshape(1, hdim) for p in (pi, pf, po))
        h_prevs = torch.cat([h0.to(f32)[None], hs[:-1]], dim=0)
        c_prevs = torch.cat([c0.to(f32)[None], cs[:-1]], dim=0)
        i_s, f_s, g_s, o_s = torch.split(gates, hdim, dim=-1)
        # step-independent factors of _core_bwd's step, for all T at once
        tanh_c = torch.tanh(cs)
        k_o = tanh_c * (o_s * (1 - o_s))          # dzo = dh * k_o
        k_c = o_s * (1 - tanh_c * tanh_c)         # dc += dh * k_c
        k_i = g_s * (i_s * (1 - i_s))             # dzi = dc * k_i
        k_f = c_prevs * (f_s * (1 - f_s))         # dzf = dc * k_f
        k_g = i_s * (1 - g_s * g_s)               # dzg = dc * k_g
        dzs = torch.empty_like(gates)
        dzi_s, dzf_s, dzg_s, dzo_s = torch.split(dzs, hdim, dim=-1)
        rw_t = rw32.t()
        for s in range(t - 1, -1, -1):
            dh = dys[s] + dh
            dzo = torch.mul(dh, k_o[s], out=dzo_s[s])
            dc = dh * k_c[s] + dc + dzo * po32
            dzi = torch.mul(dc, k_i[s], out=dzi_s[s])
            dzf = torch.mul(dc, k_f[s], out=dzf_s[s])
            torch.mul(dc, k_g[s], out=dzg_s[s])
            dc = dc * f_s[s] + dzi * pi32 + dzf * pf32
            dh = torch.matmul(dzs[s], rw_t)
        flat = dzs.reshape(t * bsz, 4 * hdim)
        d_rw = torch.matmul(h_prevs.reshape(t * bsz, hdim).t(), flat)
        d_b = flat.sum(dim=0)
        d_pi = (dzs[..., :hdim] * c_prevs).sum(dim=(0, 1))
        d_pf = (dzs[..., hdim:2 * hdim] * c_prevs).sum(dim=(0, 1))
        d_po = (dzs[..., 3 * hdim:] * cs).sum(dim=(0, 1))
        return (dzs.to(ctx.xw_dtype), dh.to(h0.dtype), dc.to(c0.dtype), d_rw.to(rw.dtype),
                d_b.to(b.dtype), d_pi.to(pi.dtype), d_pf.to(pf.dtype),
                d_po.to(po.dtype))


def fused_lstm_available(x: Tensor, hdim: int, mask, gate_activation: str,
                         activation) -> bool:
    """Whether `LSTMCore` computes this layer: no mask, sigmoid gates, tanh
    activation, float32 or bfloat16 input. The TPU gates (H a multiple of
    128, B of 8, the VMEM estimate) and the DL4JTPU_FUSED_LSTM switch have
    no counterpart: the kernel takes any shape up to its shared-memory
    limit, where `lstm_scan_cuda` raises. On the CPU the same path runs
    the plain twin."""
    if mask is not None or hdim < 1:
        return False
    if gate_activation != "sigmoid" or activation not in ("tanh", None):
        return False
    return x.dtype in (torch.float32, torch.bfloat16)


def fused_lstm_scan(params, x, carry: Tuple[Tensor, Tensor],
                    reverse: bool = False
                    ) -> Tuple[Tensor, Tuple[Tensor, Tensor]]:
    """LSTM.scan_sequence's fused path: x [B, T, F] + (h0, c0) ->
    (ys [B, T, H], (h_T, c_T)). The input projection x.W for all T is one
    `torch.matmul` outside the kernel; reverse runs the flipped sequence
    through the same kernel and flips the outputs back."""
    h0, c0 = carry
    xw = torch.matmul(x, params["W"])              # [B, T, 4H]
    xw_t = xw.transpose(0, 1)                      # time-major
    if reverse:
        xw_t = xw_t.flip(0)
    hdim = h0.shape[-1]
    zeros = torch.zeros((hdim,), dtype=xw_t.dtype, device=xw_t.device)
    ys_t, h_f, c_f = LSTMCore.apply(
        xw_t, h0, c0, params["RW"], params["b"], params.get("pI", zeros),
        params.get("pF", zeros), params.get("pO", zeros))
    if reverse:
        ys_t = ys_t.flip(0)
    return ys_t.transpose(0, 1), (h_f, c_f)

"""Attention core, layer norm and the DSL's attention layers (port of
deeplearning4j_tpu/nn/layers/attention.py): `dot_product_attention`,
`layer_norm`, and the config-DSL classes `LayerNormalization`,
`MultiHeadAttention` and `TransformerBlock`.

`dot_product_attention` follows the reference's routing: a key mask or
a float64 input takes the plain math below (as it does in JAX, where
the kernel computes in float32 and takes no mask); every other call goes
through `ops.flash_attention`, i.e. the CUDA kernel for CUDA tensors and
its plain twin for CPU tensors. Gradients flow through the flash path as
well: its `FlashAttention` autograd.Function runs the backward kernel
(the plain backward twin on the CPU), and the masked / float64 math is
differentiated by autograd. The serving and training paths never pass a
mask.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from deeplearning4j_tpu_torch.nn.activations import get_activation
from deeplearning4j_tpu_torch.nn.conf import inputs as it
from deeplearning4j_tpu_torch.nn.conf.serde import register
from deeplearning4j_tpu_torch.nn.layers.base import (BaseLayer, Layer,
                                                     apply_dropout)
from deeplearning4j_tpu_torch.nn.weights import init_weights

NEG_INF = -1e30


def dot_product_attention(q, k, v, *, causal: bool = False,
                          mask: Optional[torch.Tensor] = None,
                          q_offset: int = 0, kv_offset: int = 0,
                          scale: Optional[float] = None) -> torch.Tensor:
    """Scaled dot-product attention.

    q: [B, T, H, Dh]; k, v: [B, S, H, Dh] -> [B, T, H, Dh].
    ``mask``: optional [B, S] {0,1} key-validity mask.
    ``q_offset``/``kv_offset``: global positions of q[0] / k[0] — causal
    masking compares global positions. Scores and softmax accumulate in
    at least float32 (float64 inputs keep float64); masked scores are the
    finite NEG_INF, so fully-masked rows average uniformly as in JAX."""
    dh = q.shape[-1]
    scale = (dh ** -0.5) if scale is None else scale
    if mask is None and q.dtype != torch.float64:
        from deeplearning4j_tpu_torch.ops.flash_attention import \
            flash_attention
        return flash_attention(q, k, v, causal=causal, q_offset=q_offset,
                               kv_offset=kv_offset, scale=float(scale))
    acc = torch.promote_types(q.dtype, torch.float32)
    scores = torch.einsum("bthd,bshd->bhts", q.to(acc), k.to(acc)) * scale
    if causal:
        qpos = q_offset + torch.arange(q.shape[1], device=q.device)
        kpos = kv_offset + torch.arange(k.shape[1], device=q.device)
        cm = qpos[:, None] >= kpos[None, :]
        scores = torch.where(cm[None, None], scores,
                             torch.full_like(scores, NEG_INF))
    if mask is not None:
        keep = mask[:, None, None, :].to(torch.bool)
        scores = torch.where(keep, scores, torch.full_like(scores, NEG_INF))
    weights = torch.softmax(scores, dim=-1)
    return torch.einsum("bhts,bshd->bthd", weights.to(v.dtype), v)


def layer_norm(x, gamma, beta, eps: float = 1e-5) -> torch.Tensor:
    """Layer norm over the last axis in at least float32, returned in
    x's dtype. The variance is the population variance (jnp.var)."""
    xf = x.to(torch.promote_types(x.dtype, torch.float32))
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, unbiased=False)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * gamma + beta).to(x.dtype)


def _ln_dtype(dtype):
    return torch.promote_types(dtype, torch.float32)


@register
@dataclass
class LayerNormalization(Layer):
    """Per-feature layer norm over the last axis."""
    n_out: Optional[int] = None
    eps: float = 1e-5
    _family: str = "ff"

    @property
    def family(self):
        return self._family

    @property
    def input_family(self):
        return self._family

    def weight_param_keys(self):
        return ()

    def update_input_type(self, input_type):
        if isinstance(input_type, it.InputTypeRecurrent):
            self._family = "rnn"
        elif isinstance(input_type, it.InputTypeFeedForward):
            self._family = "ff"
        else:
            raise ValueError("LayerNormalization needs ff/rnn input")
        self.n_out = self.n_out or input_type.size
        return input_type

    def init_params(self, gen, dtype=torch.float32, device=None):
        ln = _ln_dtype(dtype)
        return {"gamma": torch.ones((self.n_out,), dtype=ln, device=device),
                "beta": torch.zeros((self.n_out,), dtype=ln, device=device)}

    def apply(self, params, state, x, *, train=False, key=None, mask=None):
        return layer_norm(x, params["gamma"], params["beta"], self.eps), state


def _weights(layer, gen, dtype, device, shapes):
    """init_weights for each (name, (fan_in, fan_out)), drawn in order."""
    scheme = layer.weight_init or "xavier"
    return {k: init_weights(gen, (fi, fo), fi, fo, scheme, layer.dist,
                            dtype, device) for k, (fi, fo) in shapes}


@register
@dataclass
class MultiHeadAttention(BaseLayer):
    """Self-attention over [B, T, D] -> [B, T, D]."""
    n_in: Optional[int] = None
    n_out: Optional[int] = None
    n_heads: int = 4
    causal: bool = False
    attn_dropout: float = 0.0

    @property
    def family(self):
        return "rnn"

    def update_input_type(self, input_type):
        if not isinstance(input_type, it.InputTypeRecurrent):
            raise ValueError("MultiHeadAttention needs recurrent input")
        if self.n_in is None:
            self.n_in = input_type.size
        if self.n_out is None:
            self.n_out = self.n_in
        if self.n_out % self.n_heads:
            raise ValueError(f"n_out {self.n_out} not divisible by n_heads "
                             f"{self.n_heads}")
        return it.InputType.recurrent(self.n_out,
                                      input_type.time_series_length)

    def init_params(self, gen, dtype=torch.float32, device=None):
        d, o = self.n_in, self.n_out
        p = _weights(self, gen, dtype, device,
                     [("Wq", (d, o)), ("Wk", (d, o)), ("Wv", (d, o)),
                      ("Wo", (o, o))])
        for b in ("bq", "bk", "bv", "bo"):
            p[b] = torch.zeros((o,), dtype=dtype, device=device)
        return p

    def weight_param_keys(self):
        return ("Wq", "Wk", "Wv", "Wo")

    def _heads(self, x, w, b):
        y = torch.matmul(x, w.to(x.dtype)) + b.to(x.dtype)
        return y.reshape(y.shape[0], y.shape[1], self.n_heads,
                         self.n_out // self.n_heads)

    def apply(self, params, state, x, *, train=False, key=None, mask=None):
        q = self._heads(x, params["Wq"], params["bq"])
        k = self._heads(x, params["Wk"], params["bk"])
        v = self._heads(x, params["Wv"], params["bv"])
        out = dot_product_attention(q, k, v, causal=self.causal, mask=mask)
        out = out.reshape(out.shape[0], out.shape[1], self.n_out)
        out = torch.matmul(out, params["Wo"].to(x.dtype)) \
            + params["bo"].to(x.dtype)
        if train and self.attn_dropout > 0 and key is not None:
            out = apply_dropout(out, self.attn_dropout, key)
        return out, state


@register
@dataclass
class TransformerBlock(BaseLayer):
    """Pre-LN transformer block: x + MHA(LN(x)); x + MLP(LN(x))."""
    n_in: Optional[int] = None
    n_heads: int = 4
    mlp_ratio: int = 4
    causal: bool = True
    eps: float = 1e-5

    @property
    def family(self):
        return "rnn"

    def update_input_type(self, input_type):
        if not isinstance(input_type, it.InputTypeRecurrent):
            raise ValueError("TransformerBlock needs recurrent input")
        if self.n_in is None:
            self.n_in = input_type.size
        if self.n_in % self.n_heads:
            raise ValueError("n_in not divisible by n_heads")
        return input_type

    @property
    def n_out(self):
        return self.n_in

    def init_params(self, gen, dtype=torch.float32, device=None):
        d = self.n_in
        f = d * self.mlp_ratio
        p = _weights(self, gen, dtype, device,
                     [("Wq", (d, d)), ("Wk", (d, d)), ("Wv", (d, d)),
                      ("Wo", (d, d)), ("W1", (d, f)), ("W2", (f, d))])
        # LN params stay >= float32 (float64 nets keep float64)
        ln = _ln_dtype(dtype)
        p.update(b1=torch.zeros((f,), dtype=dtype, device=device),
                 b2=torch.zeros((d,), dtype=dtype, device=device),
                 ln1g=torch.ones((d,), dtype=ln, device=device),
                 ln1b=torch.zeros((d,), dtype=ln, device=device),
                 ln2g=torch.ones((d,), dtype=ln, device=device),
                 ln2b=torch.zeros((d,), dtype=ln, device=device))
        return p

    def weight_param_keys(self):
        return ("Wq", "Wk", "Wv", "Wo", "W1", "W2")

    def apply(self, params, state, x, *, train=False, key=None, mask=None):
        d = self.n_in
        b_, t = x.shape[0], x.shape[1]
        h = layer_norm(x, params["ln1g"], params["ln1b"], self.eps)

        def heads(w):
            y = torch.matmul(h, w.to(h.dtype))
            return y.reshape(b_, t, self.n_heads, d // self.n_heads)

        a = dot_product_attention(heads(params["Wq"]), heads(params["Wk"]),
                                  heads(params["Wv"]), causal=self.causal,
                                  mask=mask)
        x = x + torch.matmul(a.reshape(b_, t, d), params["Wo"].to(x.dtype))
        h = layer_norm(x, params["ln2g"], params["ln2b"], self.eps)
        h = get_activation("gelu")(torch.matmul(h, params["W1"].to(h.dtype))
                                   + params["b1"].to(h.dtype))
        x = x + torch.matmul(h, params["W2"].to(x.dtype)) \
            + params["b2"].to(x.dtype)
        return x, state

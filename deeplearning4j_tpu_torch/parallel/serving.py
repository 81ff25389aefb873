"""Continuous-batching slot programs on one device.

Port of the continuous subset of deeplearning4j_tpu/parallel/serving.py
at tensor-parallel = data-parallel = 1: `shard_map`, the mesh specs and
the 'model' psum (`_g_sync`) fall away, and each "compiled program"
becomes a plain function closed over its geometry.

- `init_slot_state(cfg, num_slots)` — the persistent pool: KV caches
  [L, Ns, S, D] plus per-slot `pos` and pending-token `tok` vectors
  (int32 [Ns]), resident on the device for the engine's lifetime.
- `make_continuous_prefill(cfg, bucket_len, num_slots, ...)` — one pass
  over the whole [Ns, Tb] pool. Only admitted slots (``plen > 0``) write
  cache rows [0, Tb), set ``pos <- plen`` and emit their first token
  (sampled at index ``plen``); every other slot passes through untouched
  and emits -1.
- `make_continuous_decode(cfg, chunk, num_slots, ...)` — ``chunk``
  decode steps for every active slot: each step writes the slot's K/V
  row at ``clip(pos)`` (an inactive slot re-writes its own row), attends
  the slot's filled prefix through the decode kernel, and samples the
  token at index ``pos + 1``. A slot whose ``rem`` reaches 0 deactivates
  mid-chunk; inactive slots emit -1.

The reference's programs are functional and the engine rebinds the
returned pool; here the caches (and pos/tok) are updated IN PLACE and the
same tensors are returned, which is what the reference's buffer donation
achieved. The `constrain`, `quantized` and `kv_mode` variants are not
ported (ROADMAP queue A5).
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.models.transformer import (
    TransformerConfig, _check_sampling, _check_slice, layer_params,
    sample_at_positions, slot_cache_shape)
from deeplearning4j_tpu_torch.nn.layers.attention import (
    dot_product_attention, layer_norm)
from deeplearning4j_tpu_torch.ops.flash_decode import decode_attention


def _sample_slots(logits, posidx, key: int, temperature: float,
                  top_k: int, top_p: float) -> torch.Tensor:
    """Per-slot sampling on [Ns, V] logits: the token generated at
    sequence index ``posidx[i]`` draws with counter (key, posidx[i]) —
    slot-placement independent (reference :415, data rank 1)."""
    return sample_at_positions(logits, posidx, key, temperature, top_k,
                               top_p)


def _local_mlp(h, x, p) -> torch.Tensor:
    """MLP tail of the slot blocks, in the reference's summation order
    (h + m + b2, reference :188-191)."""
    z = F.gelu(torch.matmul(x, p["W1"].to(x.dtype)) + p["b1"].to(x.dtype),
               approximate="tanh")
    m = torch.matmul(z, p["W2"].to(z.dtype))
    return h + m + p["b2"].to(h.dtype)


def _local_block_prefill(h, p, cfg: TransformerConfig):
    """Block forward over the whole padded prompt pool [Ns, Tb, D];
    returns (h, (k, v)) with k/v flattened to [Ns, Tb, D]. Pad positions
    sit right of every valid one, so causal attention keeps them from
    touching valid outputs (reference :194)."""
    x = layer_norm(h, p["ln1g"], p["ln1b"], cfg.eps)

    def heads(y):
        return y.reshape(y.shape[0], y.shape[1], cfg.n_heads, cfg.d_head)

    q = heads(torch.matmul(x, p["Wq"].to(x.dtype)))
    k = heads(torch.matmul(x, p["Wk"].to(x.dtype)))
    v = heads(torch.matmul(x, p["Wv"].to(x.dtype)))
    a = dot_product_attention(q, k, v, causal=True)
    a = a.reshape(a.shape[0], a.shape[1], cfg.d_model)
    h = h + torch.matmul(a, p["Wo"].to(a.dtype))
    x = layer_norm(h, p["ln2g"], p["ln2b"], cfg.eps)
    h = _local_mlp(h, x, p)
    kf = k.reshape(k.shape[0], k.shape[1], cfg.d_model)
    vf = v.reshape(v.shape[0], v.shape[1], cfg.d_model)
    return h, (kf, vf)


def _local_block_decode_slotted(h, p, ck_all, cv_all, layer: int, pos,
                                act, cfg: TransformerConfig):
    """One block, one new position PER SLOT: h [Ns, 1, D], stacked caches
    [L, Ns, S, D], pos [Ns], act [Ns] bool. The K/V row is written in
    place at (layer, slot, clip(pos)); an inactive slot re-writes its own
    current row, so the write stays one fixed-shape scatter (reference
    :460). Attention masks each slot to its own prefix 0..clip(pos)."""
    ns = h.shape[0]
    s_max = ck_all.shape[2]
    x = layer_norm(h, p["ln1g"], p["ln1b"], cfg.eps)
    q = torch.matmul(x[:, 0], p["Wq"].to(x.dtype)).reshape(
        ns, cfg.n_heads, cfg.d_head)
    k = torch.matmul(x[:, 0], p["Wk"].to(x.dtype))      # [Ns, D]
    v = torch.matmul(x[:, 0], p["Wv"].to(x.dtype))
    rows = torch.arange(ns, device=h.device)
    wp = torch.clamp(pos, 0, s_max - 1)
    wi = wp.long()
    keep = act[:, None]
    ck_all[layer, rows, wi] = torch.where(
        keep, k.to(ck_all.dtype), ck_all[layer, rows, wi])
    cv_all[layer, rows, wi] = torch.where(
        keep, v.to(cv_all.dtype), cv_all[layer, rows, wi])
    a = decode_attention(q, ck_all, cv_all, wp, n_heads=cfg.n_heads,
                         layer=layer)                    # [Ns, H, Dh]
    h = h + torch.matmul(a.reshape(ns, 1, cfg.d_model), p["Wo"].to(h.dtype))
    x = layer_norm(h, p["ln2g"], p["ln2b"], cfg.eps)
    return _local_mlp(h, x, p)


def init_slot_state(cfg: TransformerConfig, num_slots: int, device):
    """The persistent slot pool (ck, cv, pos, tok) on ``device``: KV
    caches [L, Ns, S, D] zero-filled, pos and tok int32 [Ns] zeros."""
    _check_slice(cfg)
    dt = cfg.cache_torch_dtype()
    shape = slot_cache_shape(cfg, num_slots)
    ck = torch.zeros(shape, dtype=dt, device=device)
    cv = torch.zeros(shape, dtype=dt, device=device)
    pos = torch.zeros((num_slots,), dtype=torch.int32, device=device)
    tok = torch.zeros((num_slots,), dtype=torch.int32, device=device)
    return ck, cv, pos, tok


def make_continuous_prefill(cfg: TransformerConfig, bucket_len: int,
                            num_slots: int, temperature: float = 0.0,
                            top_k: int = 0, top_p: float = 1.0
                            ) -> Callable:
    """Slot-pool prefill: (params, ck, cv, pos, tok, prompts [Ns, Tb],
    plen [Ns], key) -> (ck, cv, pos, tok, first [Ns]). See the module
    docstring for the admission semantics."""
    _check_slice(cfg)
    _check_sampling(top_k, top_p)
    if not 0 < bucket_len <= cfg.max_len:
        raise ValueError(f"bucket_len {bucket_len} out of "
                         f"(0, {cfg.max_len}]")

    @torch.no_grad()
    def run(params, ck, cv, pos, tok, prompts, plen, key: int):
        dt = cfg.activation_dtype()
        ns, tb = prompts.shape
        if (ns, tb) != (num_slots, bucket_len):
            raise ValueError(f"prompts {tuple(prompts.shape)} != program "
                             f"geometry ({num_slots}, {bucket_len})")
        admit = plen > 0
        h = (params["embed"].to(dt)[prompts.long()]
             + params["pos"].to(dt)[:tb][None])
        for layer in range(cfg.n_layers):
            h, (k, v) = _local_block_prefill(
                h, layer_params(params, layer), cfg)
            ck[layer, admit, :tb] = k[admit].to(ck.dtype)
            cv[layer, admit, :tb] = v[admit].to(cv.dtype)
        h = layer_norm(h, params["lnfg"], params["lnfb"], cfg.eps)
        rows = torch.arange(ns, device=h.device)
        last = h[rows, torch.clamp(plen - 1, 0, tb - 1).long()]
        logits = torch.matmul(last, params["Wout"].to(last.dtype))
        first = _sample_slots(logits, plen, key, temperature, top_k, top_p)
        pos.copy_(torch.where(admit, plen.to(pos.dtype), pos))
        tok.copy_(torch.where(admit, first, tok))
        first = torch.where(admit, first, torch.full_like(first, -1))
        return ck, cv, pos, tok, first

    return run


def make_continuous_decode(cfg: TransformerConfig, chunk: int,
                           num_slots: int, temperature: float = 0.0,
                           top_k: int = 0, top_p: float = 1.0
                           ) -> Callable:
    """Slot-pool decode chunk: (params, ck, cv, pos, tok, active [Ns]
    bool, rem [Ns] int32, key) -> (ck, cv, pos, tok, toks [Ns, chunk]).
    See the module docstring for the per-slot semantics."""
    _check_slice(cfg)
    _check_sampling(top_k, top_p)
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")

    @torch.no_grad()
    def run(params, ck, cv, pos, tok, active, rem, key: int):
        dt = cfg.activation_dtype()
        if pos.shape != (num_slots,):
            raise ValueError(f"pos {tuple(pos.shape)} != program geometry "
                             f"({num_slots},)")
        rem = rem.clone()
        neg1 = torch.full_like(tok, -1)
        emitted = []
        for _ in range(chunk):
            act = active & (rem > 0)
            emb = params["embed"].to(dt)[tok.long()]
            pv = params["pos"].to(dt)[
                torch.clamp(pos, 0, cfg.max_len - 1).long()]
            h = (emb + pv)[:, None, :]
            for layer in range(cfg.n_layers):
                h = _local_block_decode_slotted(
                    h, layer_params(params, layer), ck, cv, layer, pos,
                    act, cfg)
            h = layer_norm(h, params["lnfg"], params["lnfb"], cfg.eps)
            logits = torch.matmul(h[:, 0], params["Wout"].to(h.dtype))
            nxt = _sample_slots(logits, pos + 1, key, temperature, top_k,
                                top_p)
            tok.copy_(torch.where(act, nxt, tok))
            emitted.append(torch.where(act, nxt, neg1))
            pos.copy_(torch.where(act, pos + 1, pos))
            rem = torch.where(act, rem - 1, rem)
        return ck, cv, pos, tok, torch.stack(emitted, dim=1)

    return run

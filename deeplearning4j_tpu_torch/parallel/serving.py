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
- `make_speculative_decode(cfg, spec_k, num_slots, ...)` — one
  speculative round: K draft steps, one verify pass over the K+1-token
  window through the window kernel, and the commit of each slot's
  accepted prefix (see the section comment below).

The reference's programs are functional and the engine rebinds the
returned pool; here the caches (and pos/tok) are updated IN PLACE and the
same tensors are returned, which is what the reference's buffer donation
achieved. The `constrain`, `quantized` and `kv_mode` variants, the paged
programs and chunked prefill are not ported (ROADMAP queues A4-A6).
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
from deeplearning4j_tpu_torch.ops.flash_decode import (
    decode_attention, decode_window_attention)


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


def _block_qkv(h, p, cfg: TransformerConfig):
    """First half of a one-position block step: h [Ns, 1, D] ->
    (q [Ns, H, Dh], k [Ns, D], v [Ns, D])."""
    ns = h.shape[0]
    x = layer_norm(h, p["ln1g"], p["ln1b"], cfg.eps)
    q = torch.matmul(x[:, 0], p["Wq"].to(x.dtype)).reshape(
        ns, cfg.n_heads, cfg.d_head)
    k = torch.matmul(x[:, 0], p["Wk"].to(x.dtype))
    v = torch.matmul(x[:, 0], p["Wv"].to(x.dtype))
    return q, k, v


def _block_out(h, a, p, cfg: TransformerConfig):
    """Second half of a one-position block step: the attention output a
    [Ns, H, Dh] through Wo, the residual and the MLP; h [Ns, 1, D]."""
    ns = h.shape[0]
    h = h + torch.matmul(a.reshape(ns, 1, cfg.d_model), p["Wo"].to(h.dtype))
    x = layer_norm(h, p["ln2g"], p["ln2b"], cfg.eps)
    return _local_mlp(h, x, p)


def _write_kv(ck_all, cv_all, layer: int, wp, keep, k, v) -> None:
    """Write each slot's K/V row [Ns, D] in place at (layer, slot, wp)
    where ``keep``; elsewhere the slot re-writes its own row, so the
    write stays one fixed-shape scatter (reference :460)."""
    rows = torch.arange(wp.shape[0], device=wp.device)
    wi = wp.long()
    keep = keep[:, None]
    ck_all[layer, rows, wi] = torch.where(
        keep, k.to(ck_all.dtype), ck_all[layer, rows, wi])
    cv_all[layer, rows, wi] = torch.where(
        keep, v.to(cv_all.dtype), cv_all[layer, rows, wi])


def _local_block_decode_slotted(h, p, ck_all, cv_all, layer: int, pos,
                                act, cfg: TransformerConfig):
    """One block, one new position PER SLOT: h [Ns, 1, D], stacked caches
    [L, Ns, S, D], pos [Ns], act [Ns] bool. The K/V row is written in
    place at (layer, slot, clip(pos)) for active slots. Attention masks
    each slot to its own prefix 0..clip(pos)."""
    q, k, v = _block_qkv(h, p, cfg)
    wp = torch.clamp(pos, 0, ck_all.shape[2] - 1)
    _write_kv(ck_all, cv_all, layer, wp, act, k, v)
    a = decode_attention(q, ck_all, cv_all, wp, n_heads=cfg.n_heads,
                         layer=layer)                    # [Ns, H, Dh]
    return _block_out(h, a, p, cfg)


def _embed_pending(params, cfg: TransformerConfig, pos, tok):
    """Each slot's pending token embedded at its own position [Ns, 1, D]
    (reference :2023): the first op of every decode, draft and verify
    step."""
    dt = cfg.activation_dtype()
    emb = params["embed"].to(dt)[tok.long()]
    pv = params["pos"].to(dt)[torch.clamp(pos, 0, cfg.max_len - 1).long()]
    return (emb + pv)[:, None, :]


def _head_sample(params, cfg: TransformerConfig, h, posidx, key: int,
                 temperature: float, top_k: int, top_p: float):
    """Final norm, output head and per-slot sampling of h [Ns, 1, D]: the
    token generated at sequence index ``posidx`` [Ns]."""
    h = layer_norm(h, params["lnfg"], params["lnfb"], cfg.eps)
    logits = torch.matmul(h[:, 0], params["Wout"].to(h.dtype))
    return _sample_slots(logits, posidx, key, temperature, top_k, top_p)


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
        if pos.shape != (num_slots,):
            raise ValueError(f"pos {tuple(pos.shape)} != program geometry "
                             f"({num_slots},)")
        rem = rem.clone()
        neg1 = torch.full_like(tok, -1)
        emitted = []
        for _ in range(chunk):
            act = active & (rem > 0)
            h = _embed_pending(params, cfg, pos, tok)
            for layer in range(cfg.n_layers):
                h = _local_block_decode_slotted(
                    h, layer_params(params, layer), ck, cv, layer, pos,
                    act, cfg)
            nxt = _head_sample(params, cfg, h, pos + 1, key, temperature,
                               top_k, top_p)
            tok.copy_(torch.where(act, nxt, tok))
            emitted.append(torch.where(act, nxt, neg1))
            pos.copy_(torch.where(act, pos + 1, pos))
            rem = torch.where(act, rem - 1, rem)
        return ck, cv, pos, tok, torch.stack(emitted, dim=1)

    return run


# ---------------------------------------------------------------------------
# speculative decoding: draft K tokens, verify them in ONE target pass
# ---------------------------------------------------------------------------
#
# A round (reference :1960-2409) runs K draft steps with a cheap drafter
# (the model itself, "self", or its first `draft_layers` blocks), then one
# target pass over the K+1-token window [pending, d_1..d_K], and commits
# the longest draft prefix that equals the target's own position-keyed
# samples plus the target's token at the first divergence. The committed
# token at index j is always the target's sample at j, so a speculative
# engine is token-identical to the plain one, greedy and sampled, provided
# the verify pass computes each window row exactly as a decode step would.
#
# The port holds that by construction: the verify pass runs decode's own
# per-row code (`_embed_pending`, `_block_qkv`, `_block_out`,
# `_head_sample`) once per window row, on tensors of decode's shape and
# layout, and batches only the attention, through the window kernel,
# whose row t equals the decode kernel at pos + t bit for bit. A batched
# [Ns*(K+1), D] product would let the matmul library pick another
# algorithm, and another summation order, than for decode's [Ns, D].
#
# Cache safety: draft steps write draft K/V rows at clip(pos..pos+K-1)
# (for `draft_layers` < L only in the layers the target shares, so they
# are the target's own); verify rewrites rows pos..pos+K of every layer
# with target K/V before attending them, and drops (never clips) rows at
# or past S. Rows past the committed prefix are never attended and are
# overwritten in order as real tokens arrive.

_SPEC_TODO = {
    "quantized": "quantized weights (ROADMAP queue A4)",
    "kv_mode": "the quantized KV pool (ROADMAP queue A4)",
    "draft_quantized": "the quantized drafter (ROADMAP queue A4)",
    "constrain": "grammar-constrained speculative decoding "
                 "(ROADMAP queue A6)",
}


def _check_spec(cfg: TransformerConfig, spec_k: int,
                draft_layers: int) -> int:
    """Validate a speculative program's geometry; returns the number of
    draft layers (0 -> every layer). MoE configs never reach here:
    `_check_slice` refuses them."""
    if spec_k < 1:
        raise ValueError(f"spec_k must be >= 1, got {spec_k}")
    nd = draft_layers if draft_layers > 0 else cfg.n_layers
    if not 0 < nd <= cfg.n_layers:
        raise ValueError(f"draft_layers {draft_layers} out of "
                         f"(0, {cfg.n_layers}]")
    return nd


def _spec_accept_commit(spec_k: int, drafts, tgt, pos, tok, rem, act):
    """Accept the longest draft prefix matching the target's samples,
    commit it plus the target's token at the first divergence (or the
    bonus token after K accepts), capped by the slot's remaining budget
    (reference :2048). Returns (pos', tok', rem', emit [Ns, K+1] with -1
    past each slot's commit count, ncommit, drafted, accepted), int32."""
    i32 = torch.int32
    rows = torch.arange(tok.shape[0], device=tok.device)
    zero = torch.zeros_like(tok)
    match = (drafts == tgt[:, :spec_k]) & act[:, None]
    acc = torch.cumprod(match.to(i32), dim=1, dtype=i32).sum(dim=1,
                                                             dtype=i32)
    c = torch.where(act, torch.minimum(acc + 1, rem), zero)
    win = torch.arange(spec_k + 1, device=tok.device)[None, :]
    emit = torch.where(win < c[:, None], tgt, torch.full_like(tgt, -1))
    last = tgt[rows, torch.clamp(c - 1, 0, spec_k).long()]
    tok = torch.where(act, last, tok)
    pos = torch.where(act, pos + c, pos)
    rem = torch.where(act, rem - c, rem)
    drafted = torch.where(act, torch.full_like(tok, spec_k), zero)
    accepted = torch.clamp(c - 1, min=0)
    return pos, tok, rem, emit, c, drafted, accepted


def make_speculative_decode(cfg: TransformerConfig, spec_k: int,
                            num_slots: int, temperature: float = 0.0,
                            top_k: int = 0, top_p: float = 1.0,
                            draft_layers: int = 0, quantized=None,
                            kv_mode=None, draft_quantized=None,
                            constrain: bool = False) -> Callable:
    """Speculative round over the contiguous slot pool (reference
    :2105): (params, dparams, ck, cv, pos, tok, active [Ns] bool, rem
    [Ns] int32, poison [Ns] bool, key) -> (ck, cv, pos, tok, emit
    [Ns, K+1], ncommit [Ns], drafted [Ns], accepted [Ns]).

    Every active slot advances 1..K+1 tokens; ``emit[i, :ncommit[i]]``
    are its committed tokens (-1 beyond). ``dparams`` drive the K draft
    steps through their first ``draft_layers`` blocks (0: all);
    ``poison`` derails a slot's drafts to (d+1) mod V, so verification
    rejects them. The caches, pos and tok are updated in place; ``rem``
    is not. See the section comment for the exactness and cache-safety
    arguments. The quantized and constrained variants are not ported."""
    for name, value in (("quantized", quantized), ("kv_mode", kv_mode),
                        ("draft_quantized", draft_quantized),
                        ("constrain", constrain)):
        if value:
            raise NotImplementedError(f"make_speculative_decode({name}="
                                      f"{value!r}): {_SPEC_TODO[name]} is "
                                      f"not ported yet")
    _check_slice(cfg)
    _check_sampling(top_k, top_p)
    nd = _check_spec(cfg, spec_k, draft_layers)
    k1 = spec_k + 1

    def sample(p, h, posidx, key):
        return _head_sample(p, cfg, h, posidx, key, temperature, top_k,
                            top_p)

    def draft_phase(dparams, ck, cv, pos, tok, act, key):
        """K sequential draft steps through decode's slotted block (their
        K/V rows land in the live cache; verify rewrites them)."""
        dpos, dtok = pos, tok
        drafts = []
        for _ in range(spec_k):
            h = _embed_pending(dparams, cfg, dpos, dtok)
            for layer in range(nd):
                h = _local_block_decode_slotted(
                    h, layer_params(dparams, layer), ck, cv, layer, dpos,
                    act, cfg)
            nxt = sample(dparams, h, dpos + 1, key)
            dtok = torch.where(act, nxt, dtok)
            dpos = torch.where(act, dpos + 1, dpos)
            drafts.append(nxt)
        return torch.stack(drafts, dim=1)                # [Ns, K]

    def verify_phase(params, ck, cv, pos, tok, act, drafts, key):
        """ONE target pass over the window: per layer each window row's
        K/V is written (rows at or past S dropped), then all rows attend
        through the window kernel. Returns the target's samples at the
        K+1 window positions [Ns, K+1]."""
        s_max = ck.shape[2]
        win = torch.cat([tok[:, None], drafts], dim=1)   # [Ns, K+1]
        posw = pos[:, None] + torch.arange(k1, dtype=pos.dtype,
                                           device=pos.device)[None, :]
        hs = [_embed_pending(params, cfg, posw[:, t], win[:, t])
              for t in range(k1)]
        for layer in range(cfg.n_layers):
            p = layer_params(params, layer)
            qs = []
            for t in range(k1):
                q, k, v = _block_qkv(hs[t], p, cfg)
                _write_kv(ck, cv, layer,
                          torch.clamp(posw[:, t], 0, s_max - 1),
                          act & (posw[:, t] < s_max), k, v)
                qs.append(q)
            a = decode_window_attention(torch.stack(qs, dim=1), ck, cv,
                                        pos, n_heads=cfg.n_heads,
                                        layer=layer)     # [Ns, K+1, H, Dh]
            at = a.transpose(0, 1).contiguous()
            hs = [_block_out(hs[t], at[t], p, cfg) for t in range(k1)]
        return torch.stack([sample(params, hs[t], posw[:, t] + 1, key)
                            for t in range(k1)], dim=1)

    @torch.no_grad()
    def run(params, dparams, ck, cv, pos, tok, active, rem, poison,
            key: int):
        if pos.shape != (num_slots,):
            raise ValueError(f"pos {tuple(pos.shape)} != program geometry "
                             f"({num_slots},)")
        act = active & (rem > 0)
        drafts = draft_phase(dparams, ck, cv, pos, tok, act, key)
        drafts = torch.where(poison[:, None],
                             (drafts + 1) % cfg.vocab_size, drafts)
        tgt = verify_phase(params, ck, cv, pos, tok, act, drafts, key)
        npos, ntok, _, emit, c, drafted, accepted = _spec_accept_commit(
            spec_k, drafts, tgt, pos, tok, rem, act)
        pos.copy_(npos)
        tok.copy_(ntok)
        return ck, cv, pos, tok, emit, c, drafted, accepted

    return run

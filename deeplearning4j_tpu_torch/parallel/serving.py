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

- `make_parallel_generate(cfg, max_new_tokens, ...)` — batch mode's
  program (reference :261-340): one prefill of the whole [B, T0] batch
  through the flash forward (`_local_block_prefill`) into a fresh
  [L, B, max_len, D] cache, then ``max_new_tokens - 1`` cached decode
  steps through the decode kernel, one position for every row. Step i
  draws with counter (key, i); `batch_key` is the root the engine keys
  a call with.
- `make_chunked_prefill(cfg, chunk_len, num_slots, ...)` — advances each
  slot by its next ``clen`` prompt tokens from ``start``: the chunk's
  rows attend the slot's cached prefix (rows < start) and, causally,
  each other, under one softmax (`_two_piece_attention`).
- The paged pool (`init_paged_state`): K/V in ``page_size``-token pages
  [L, num_pages, page_size, D] addressed through a host-owned block table
  ``bt`` [Ns, max_pages] passed to every call as data; page 0 is the
  scratch page that pad rows, inactive slots and rows past the mapped
  pages write. `make_paged_prefill` (``chunked=True``:
  `make_paged_chunked_prefill`) resumes from a prefix-cache hit or a
  chunk boundary with the two-piece attention over the gathered pages;
  `make_paged_decode` and `make_paged_speculative_decode` write their
  rows through the table and run the decode and window kernels over the
  gathered view (`_gather_pages`), as the reference does: on the same
  values the kernels return the contiguous pool's bits.
- KV handoff (reference engine.py :1162-1240): `make_page_gather` and
  `make_slot_gather` read a request's committed rows out of the pool,
  `make_kv_adopt` scatters handed-off rows into fresh pages and seats the
  slot's pos / tok, `make_chain_adopt` seeds pages only (plain index
  work, in place).

Quantization (reference :394, quant/): a quantized params tree needs no
option, since every weight dequantizes at its use
(`quant.core.QuantizedTensor.to`) and the math is unchanged.
``kv_mode`` ("int8" / "fp8") switches every program to the quantized pool
(`init_slot_state(kv_mode=)`, `init_paged_state(kv_mode=)`): the state
grows two float32 scale planes, (ck, cv, kscale, vscale, pos, tok), K/V
rows quantize on write (one scale a row, `quant.kv.quantize_rows`, on the
grid of the pool's value dtype), decode and the verify window read the
rows through the quantized kernels with the scales folded into scores and
probabilities, and prefill's cached prefix (chunked or paged) folds them
the same way in plain attention. The paged programs gather the one-byte
pages and their scale pages as they are (the reference upcasts the pages
to float32 first; int8 -> float32 is exact, so the values agree at a
quarter of the gather bytes). e4m3 bytes move through index writes,
gathers and ``torch.where`` as uint8 views (`quant.core.raw`), bit-exact.

The reference's programs are functional and the engine rebinds the
returned pool; here the caches (and pos/tok) are updated IN PLACE and the
same tensors are returned, which is what the reference's buffer donation
achieved.

Grammar constraints (reference :430-455): every maker's ``constrain=True``
variant takes the reference's five operands after its own per-call
tensors and before the key: ``callow`` [C, V] bool and ``ctrans`` [C, V]
int32 (the engine's `serving.constrain.ConstraintTable` on the device),
``cstate`` [Ns] int32 (each slot's DFA state, chained call to call),
``cseed`` [Ns] bool and ``cseedval`` [Ns] int32 (the host's seat-time
seeds). Each sampled token is drawn from logits fenced by its slot's
allow row (`_mask_allow`) and advances the state through ``ctrans``;
``cstate`` is updated in place and returned as the last output. Row 0
is all-allow, so an unconstrained slot samples what the maskless
program samples. The mask is plain elementwise work around the ported
kernels, which run as they do without it.
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.models.transformer import (
    _M32, TransformerConfig, _check_sampling, _check_slice, _mix32,
    layer_params, moe_mlp, page_pool_shape, sample_at_positions,
    slot_cache_shape)
from deeplearning4j_tpu_torch.nn.layers.attention import (
    NEG_INF, dot_product_attention, layer_norm)
from deeplearning4j_tpu_torch.ops.flash_decode import (
    decode_attention, decode_window_attention)
from deeplearning4j_tpu_torch.quant.core import raw, resolve_mode
from deeplearning4j_tpu_torch.quant.kv import (init_paged_quant_state,
                                               init_quant_slot_state,
                                               quantize_rows)


def _sample_slots(logits, posidx, key: int, temperature: float,
                  top_k: int, top_p: float) -> torch.Tensor:
    """Per-slot sampling on [Ns, V] logits: the token generated at
    sequence index ``posidx[i]`` draws with counter (key, posidx[i]) —
    slot-placement independent (reference :415, data rank 1)."""
    return sample_at_positions(logits, posidx, key, temperature, top_k,
                               top_p)


def _local_mlp(h, x, p, cfg: TransformerConfig, valid=None
               ) -> torch.Tensor:
    """MLP tail of the slot blocks, in the reference's summation order
    (h + m + b2, reference :188-191), or h + `moe_mlp` with ``n_experts
    > 0`` (reference :177-187), where ``valid`` [Ns, T] keeps pad and
    unadmitted rows out of routing (the capacity still counts them)."""
    if cfg.n_experts > 0:
        return h + moe_mlp(x, p, cfg, valid=valid)
    z = F.gelu(torch.matmul(x, p["W1"].to(x.dtype)) + p["b1"].to(x.dtype),
               approximate="tanh")
    m = torch.matmul(z, p["W2"].to(z.dtype))
    return h + m + p["b2"].to(h.dtype)


def _local_block_prefill(h, p, cfg: TransformerConfig, valid=None):
    """Block forward over the whole padded prompt pool [Ns, Tb, D];
    returns (h, (k, v)) with k/v flattened to [Ns, Tb, D]. Pad positions
    sit right of every valid one, so causal attention keeps them from
    touching valid outputs (reference :194); ``valid`` [Ns, Tb] reaches
    only the MoE routing."""
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
    h = _local_mlp(h, x, p, cfg, valid)
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
    return _local_mlp(h, x, p, cfg)


def _pool_mode(cache) -> str:
    """The grid of a quantized pool, read from its values' dtype."""
    if cache.dtype == torch.int8:
        return "int8"
    if cache.dtype == getattr(torch, "float8_e4m3fn", None):
        return "fp8"
    raise TypeError(f"a quantized KV pool holds int8 or float8_e4m3fn "
                    f"values, got {cache.dtype}")


def _store(kv, layer: int, idx, k, v, keep=None) -> None:
    """Write K/V rows k, v [..., D] in place at (layer, *idx) of the pool
    caches ``kv``: (ck, cv), or (ck, cv, kscale, vscale) for a quantized
    pool, whose rows quantize on write with their scales going to
    (layer, *idx, 0) of the scale planes (reference :503, :706-730).
    Where ``keep`` (the shape of idx) is False the old row, and scale, is
    written back, so the write stays one fixed-shape scatter (reference
    :460)."""
    quant = len(kv) == 4
    at = (layer,) + tuple(idx)
    for i, x in enumerate((k, v)):
        cache = kv[i]
        if quant:
            xq, xs = quantize_rows(x, _pool_mode(cache))
            cache, rows = raw(cache), raw(xq)
        else:
            rows = x.to(cache.dtype)
        if keep is not None:
            rows = torch.where(keep[..., None], rows, cache[at])
        cache[at] = rows
        if quant:
            sc = kv[2 + i]
            if keep is not None:
                xs = torch.where(keep, xs, sc[at + (0,)])
            sc[at + (0,)] = xs


def _attn_kv(kv):
    """(k, v, scale arguments) for the attention kernels from a pool's
    caches or a gathered view of them, (k, v) or (k, v, kscale, vscale):
    the scales are the stacked [L, Ns, S, 1] planes (read at the call's
    ``layer``) or a view's [Ns, S] ones."""
    return kv[0], kv[1], (dict(k_scale=kv[2], v_scale=kv[3])
                          if len(kv) == 4 else {})


def _local_block_decode_slotted(h, p, kv, layer: int, pos, act,
                                cfg: TransformerConfig):
    """One block, one new position PER SLOT: h [Ns, 1, D], the pool's
    stacked caches ``kv`` (ck, cv [L, Ns, S, D], and the scale planes of
    a quantized pool), pos [Ns], act [Ns] bool. The K/V row is written in
    place at (layer, slot, clip(pos)) for active slots (quantized on
    write in a quantized pool). Attention masks each slot to its own
    prefix 0..clip(pos), through the decode kernel (its quantized entry
    on a quantized pool: reference `_local_block_decode_slotted_q`)."""
    q, k, v = _block_qkv(h, p, cfg)
    ck_all, cv_all, sc = _attn_kv(kv)
    wp = torch.clamp(pos, 0, ck_all.shape[2] - 1)
    rows = torch.arange(wp.shape[0], device=wp.device)
    _store(kv, layer, (rows, wp.long()), k, v, keep=act)
    a = decode_attention(q, ck_all, cv_all, wp, n_heads=cfg.n_heads,
                         layer=layer, **sc)              # [Ns, H, Dh]
    return _block_out(h, a, p, cfg)


def _embed_pending(params, cfg: TransformerConfig, pos, tok):
    """Each slot's pending token embedded at its own position [Ns, 1, D]
    (reference :2023): the first op of every decode, draft and verify
    step."""
    dt = cfg.activation_dtype()
    emb = params["embed"].to(dt)[tok.long()]
    pv = params["pos"].to(dt)[torch.clamp(pos, 0, cfg.max_len - 1).long()]
    return (emb + pv)[:, None, :]


def _c_start(cstate, cseed, cseedval):
    """Seed-or-carry (reference :442): slots the host just (re)seated
    read their seeded DFA state (0: the unconstrained all-allow row);
    every other slot carries the device-chained state."""
    return torch.where(cseed, cseedval, cstate)


def _mask_allow(logits, allow):
    """The grammar fence before sampling (reference :449): disallowed
    entries get NEG_INF (-1e30, the value of the reference's fence too)
    added, allowed ones 0, both in the logits' dtype, so an all-allow
    row leaves the logits as they were."""
    return logits + torch.where(allow, logits.new_zeros(()),
                                logits.new_full((), NEG_INF))


def _advance(ctrans, ds, toks):
    """The DFA states after ``toks`` [Ns] from states ``ds`` [Ns]; a -1
    (no token) reads column 0, as the reference's ``maximum(tok, 0)``."""
    return ctrans[ds.long(), torch.clamp(toks, min=0).long()]


def _head_sample(params, cfg: TransformerConfig, h, posidx, key: int,
                 temperature: float, top_k: int, top_p: float,
                 allow=None):
    """Final norm, output head and per-slot sampling of h [Ns, 1, D]: the
    token generated at sequence index ``posidx`` [Ns], under the
    grammar's ``allow`` rows [Ns, V] when given."""
    h = layer_norm(h, params["lnfg"], params["lnfb"], cfg.eps)
    logits = torch.matmul(h[:, 0], params["Wout"].to(h.dtype))
    if allow is not None:
        logits = _mask_allow(logits, allow)
    return _sample_slots(logits, posidx, key, temperature, top_k, top_p)


def _pool_program(kv_mode, lead: int, body, constrain: bool = False
                  ) -> Callable:
    """The program's call from ``body(*lead_args, kv, *rest)``: the pool's
    caches follow the ``lead`` leading arguments (params, and dparams
    for speculative rounds) as (ck, cv), or as (ck, cv, kscale, vscale)
    with ``kv_mode``; body returns (*kv, ...). With ``constrain`` the
    call ends (..., callow, ctrans, cstate, cseed, cseedval, key): body
    gets ``c=(callow, ctrans, start states)`` and returns the advanced
    states last, which land in ``cstate`` in place."""
    n = 2 if kv_mode is None else 4

    def run(*args):
        kv = args[lead:lead + n]
        if len(kv) != n or (n == 4) != (kv[0].element_size() == 1):
            kind = "quantized" if n == 4 else "float"
            raise TypeError(f"a program of the {kind} KV pool was called "
                            "with another pool")
        if not constrain:
            return body(*args[:lead], kv, *args[lead + n:])
        *rest, callow, ctrans, cstate, cseed, cseedval, key = \
            args[lead + n:]
        *out, ds = body(*args[:lead], kv, *rest, key,
                        c=(callow, ctrans,
                           _c_start(cstate, cseed, cseedval)))
        cstate.copy_(ds)
        return (*out, cstate)

    return run


def init_slot_state(cfg: TransformerConfig, num_slots: int, device,
                    kv_mode=None):
    """The persistent slot pool (ck, cv, pos, tok) on ``device``: KV
    caches [L, Ns, S, D] zero-filled, pos and tok int32 [Ns] zeros. With
    ``kv_mode`` ("int8" / "fp8", resolved against ``device``): the
    quantized pool (ck, cv, kscale, vscale, pos, tok) of
    `quant.kv.init_quant_slot_state`."""
    _check_slice(cfg)
    if resolve_mode(kv_mode, device) is not None:
        return init_quant_slot_state(cfg, num_slots, kv_mode, device)
    dt = cfg.cache_torch_dtype()
    shape = slot_cache_shape(cfg, num_slots)
    ck = torch.zeros(shape, dtype=dt, device=device)
    cv = torch.zeros(shape, dtype=dt, device=device)
    pos = torch.zeros((num_slots,), dtype=torch.int32, device=device)
    tok = torch.zeros((num_slots,), dtype=torch.int32, device=device)
    return ck, cv, pos, tok


def make_continuous_prefill(cfg: TransformerConfig, bucket_len: int,
                            num_slots: int, temperature: float = 0.0,
                            top_k: int = 0, top_p: float = 1.0,
                            kv_mode=None, constrain: bool = False
                            ) -> Callable:
    """Slot-pool prefill: (params, ck, cv, pos, tok, prompts [Ns, Tb],
    plen [Ns], key) -> (ck, cv, pos, tok, first [Ns]); with ``kv_mode``
    the pool is (ck, cv, kscale, vscale) and the admitted rows quantize
    on write (reference :706-730). See the module docstring for the
    admission semantics; with ``constrain`` an admitted slot's first
    token samples under its start state's allow row and advances it
    (reference :594)."""
    _check_slice(cfg)
    _check_sampling(top_k, top_p)
    kv_mode = resolve_mode(kv_mode)
    if not 0 < bucket_len <= cfg.max_len:
        raise ValueError(f"bucket_len {bucket_len} out of "
                         f"(0, {cfg.max_len}]")

    @torch.no_grad()
    def body(params, kv, pos, tok, prompts, plen, key: int, c=None):
        dt = cfg.activation_dtype()
        ns, tb = prompts.shape
        if (ns, tb) != (num_slots, bucket_len):
            raise ValueError(f"prompts {tuple(prompts.shape)} != program "
                             f"geometry ({num_slots}, {bucket_len})")
        admit = plen > 0
        ai = torch.nonzero(admit, as_tuple=True)[0]
        ti = torch.arange(tb, device=prompts.device)
        # MoE routing skips pad and unadmitted rows (reference :643)
        valid = (ti[None, :] < plen[:, None]) if cfg.n_experts > 0 else None
        h = (params["embed"].to(dt)[prompts.long()]
             + params["pos"].to(dt)[:tb][None])
        for layer in range(cfg.n_layers):
            h, (k, v) = _local_block_prefill(
                h, layer_params(params, layer), cfg, valid)
            _store(kv, layer, (ai[:, None], ti[None, :]), k[ai], v[ai])
        h = layer_norm(h, params["lnfg"], params["lnfb"], cfg.eps)
        rows = torch.arange(ns, device=h.device)
        last = h[rows, torch.clamp(plen - 1, 0, tb - 1).long()]
        logits = torch.matmul(last, params["Wout"].to(last.dtype))
        if c is not None:
            logits = _mask_allow(logits, c[0][c[2].long()])
        first = _sample_slots(logits, plen, key, temperature, top_k, top_p)
        pos.copy_(torch.where(admit, plen.to(pos.dtype), pos))
        tok.copy_(torch.where(admit, first, tok))
        first = torch.where(admit, first, torch.full_like(first, -1))
        if c is None:
            return (*kv, pos, tok, first)
        return (*kv, pos, tok, first,
                torch.where(admit, _advance(c[1], c[2], first), c[2]))

    return _pool_program(kv_mode, 1, body, constrain)


def make_continuous_decode(cfg: TransformerConfig, chunk: int,
                           num_slots: int, temperature: float = 0.0,
                           top_k: int = 0, top_p: float = 1.0,
                           kv_mode=None, constrain: bool = False
                           ) -> Callable:
    """Slot-pool decode chunk: (params, ck, cv, pos, tok, active [Ns]
    bool, rem [Ns] int32, key) -> (ck, cv, pos, tok, toks [Ns, chunk]);
    with ``kv_mode`` the pool is (ck, cv, kscale, vscale) before pos and
    tok, in the arguments and the results (reference :765). See the
    module docstring for the per-slot semantics; with ``constrain``
    each step masks by its slot's state and advances it through the
    token an active slot samples."""
    _check_slice(cfg)
    _check_sampling(top_k, top_p)
    kv_mode = resolve_mode(kv_mode)
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")

    @torch.no_grad()
    def body(params, kv, pos, tok, active, rem, key: int, c=None):
        if pos.shape != (num_slots,):
            raise ValueError(f"pos {tuple(pos.shape)} != program geometry "
                             f"({num_slots},)")

        def block(h, layer, act):
            return _local_block_decode_slotted(
                h, layer_params(params, layer), kv, layer, pos, act, cfg)

        return _decode_chunk(params, cfg, chunk, block, kv, pos, tok,
                             active, rem, key, sampling, c)

    sampling = (temperature, top_k, top_p)
    return _pool_program(kv_mode, 1, body, constrain)


def _decode_chunk(params, cfg: TransformerConfig, chunk: int, block, kv,
                  pos, tok, active, rem, key: int, sampling, c):
    """The decode chunk of the contiguous and the paged pool: ``chunk``
    steps of ``block(h, layer, act)`` over every layer, then the
    sampling of each active slot's next token (masked by its DFA state
    with a constraint table ``c``, whose states then advance). Returns
    (*kv, pos, tok, toks [Ns, chunk][, states])."""
    rem = rem.clone()
    neg1 = torch.full_like(tok, -1)
    ds = None if c is None else c[2]
    emitted = []
    for _ in range(chunk):
        act = active & (rem > 0)
        h = _embed_pending(params, cfg, pos, tok)
        for layer in range(cfg.n_layers):
            h = block(h, layer, act)
        nxt = _head_sample(params, cfg, h, pos + 1, key, *sampling,
                           allow=None if c is None else c[0][ds.long()])
        if c is not None:
            ds = torch.where(act, _advance(c[1], ds, nxt), ds)
        tok.copy_(torch.where(act, nxt, tok))
        emitted.append(torch.where(act, nxt, neg1))
        pos.copy_(torch.where(act, pos + 1, pos))
        rem = torch.where(act, rem - 1, rem)
    out = (*kv, pos, tok, torch.stack(emitted, dim=1))
    return out if c is None else (*out, ds)


# ---------------------------------------------------------------------------
# chunked prefill: a prompt in pieces, each attending the cached prefix
# ---------------------------------------------------------------------------

def _two_piece_attention(q, k, v, kh, vh, start, scale: float,
                         ks=None, vs=None):
    """The chunked and paged prefill's attention (reference :1076,
    :1525-1550). q, k, v [Ns, C, H, Dh] are the chunk's; kh, vh
    [Ns, S, H, Dh] the slot's cache view. Chunk row t attends the cached
    rows s < start[slot] (piece 1: all masked, so exact zeros, when
    start is 0) and the chunk rows t' <= t (piece 2), with one softmax
    over the concatenated scores; scores and softmax in at least
    float32, each piece's probabilities rounded to its values' dtype.
    A quantized view comes with its row scales ks, vs [Ns, S]: piece 1
    is then the reference's scaled algebra in float32 (scores
    ``(q.k) * ks * scale``, values ``(w * vs) . v`` cast to the chunk's
    dtype), while the chunk attends itself in float. Returns
    [Ns, C, H, Dh] in the chunk's dtype."""
    acc = torch.promote_types(q.dtype, torch.float32)
    c, s = q.shape[1], kh.shape[1]
    dev = q.device
    qa = q.to(acc)
    sc2 = torch.einsum("bthd,bshd->bhts", qa, k.to(acc)) * scale
    future = (torch.arange(c, device=dev)[None, :]
              > torch.arange(c, device=dev)[:, None])
    sc2.masked_fill_(future[None, None], NEG_INF)
    if ks is None:
        sc1 = torch.einsum("bthd,bshd->bhts", qa, kh.to(acc)) * scale
    else:
        f32 = torch.float32
        sc1 = (torch.einsum("bthd,bshd->bhts", q.to(f32), kh.to(f32))
               * ks[:, None, None, :] * scale).to(acc)
    sc1.masked_fill_(torch.arange(s, device=dev)[None, None, None, :]
                     >= start[:, None, None, None], NEG_INF)
    w = torch.softmax(torch.cat([sc1, sc2], dim=-1), dim=-1)
    if ks is None:
        a1 = torch.einsum("bhts,bshd->bthd", w[..., :s].to(vh.dtype), vh)
    else:
        a1 = torch.einsum("bhts,bshd->bthd",
                          w[..., :s] * vs[:, None, None, :],
                          vh.to(torch.float32)).to(v.dtype)
    a2 = torch.einsum("bhts,bshd->bthd", w[..., s:].to(v.dtype), v)
    return (a1 + a2).to(q.dtype)


def _chunk_block(h, p, cfg: TransformerConfig, write, view, start,
                 valid=None):
    """One block over a prefill chunk h [Ns, C, D]: ``write(k, v)``
    stores the chunk's K/V rows [Ns, C, D], then ``view()`` returns the
    slot's cache (k, v) [Ns, S, D], and for a quantized pool its row
    scales (ks, vs) [Ns, S], for the two-piece attention; ``valid``
    [Ns, C] as `_local_mlp` takes it."""
    ns, c = h.shape[0], h.shape[1]

    def heads(y):
        return y.reshape(ns, y.shape[1], cfg.n_heads, cfg.d_head)

    x = layer_norm(h, p["ln1g"], p["ln1b"], cfg.eps)
    q = heads(torch.matmul(x, p["Wq"].to(x.dtype)))
    k = torch.matmul(x, p["Wk"].to(x.dtype))
    v = torch.matmul(x, p["Wv"].to(x.dtype))
    write(k, v)
    kc, vc, *scales = view()
    a = _two_piece_attention(q, heads(k), heads(v), heads(kc), heads(vc),
                             start, cfg.d_head ** -0.5, *scales)
    h = h + torch.matmul(a.reshape(ns, c, cfg.d_model), p["Wo"].to(a.dtype))
    x = layer_norm(h, p["ln2g"], p["ln2b"], cfg.eps)
    return _local_mlp(h, x, p, cfg, valid)


def _chunk_first(params, cfg: TransformerConfig, h, clen, start, pos, tok,
                 last, key: int, sampling, c=None):
    """The end of a prefill chunk: each advancing slot (clen > 0) samples
    the token at index start + clen from its last valid row and moves
    pos there; only slots with ``last`` set commit that token to ``tok``
    and report it in ``first`` (-1 elsewhere). With a constraint table
    ``c`` the sample is masked by each slot's start state, and returns
    (first, states): the committing slots' states advanced through
    their first token, the rest carried (reference :1139)."""
    n = h.shape[1]
    h = layer_norm(h, params["lnfg"], params["lnfb"], cfg.eps)
    rows = torch.arange(h.shape[0], device=h.device)
    lastrow = h[rows, torch.clamp(clen - 1, 0, n - 1).long()]
    logits = torch.matmul(lastrow, params["Wout"].to(lastrow.dtype))
    if c is not None:
        logits = _mask_allow(logits, c[0][c[2].long()])
    plen = start + clen
    first = _sample_slots(logits, plen, key, *sampling)
    adv = clen > 0
    take = adv & last
    pos.copy_(torch.where(adv, plen.to(pos.dtype), pos))
    tok.copy_(torch.where(take, first, tok))
    first = torch.where(take, first, torch.full_like(first, -1))
    if c is None:
        return first
    return first, torch.where(take, _advance(c[1], c[2], first), c[2])


def _chunk_embed(params, cfg: TransformerConfig, toks, start):
    """Chunk tokens [Ns, C] embedded at their absolute positions
    start + t (clipped to max_len - 1 for pad rows)."""
    dt = cfg.activation_dtype()
    c = toks.shape[1]
    absp = start[:, None] + torch.arange(c, device=toks.device)[None, :]
    pe = params["pos"].to(dt)[torch.clamp(absp, 0, cfg.max_len - 1).long()]
    return params["embed"].to(dt)[toks.long()] + pe, absp


def make_chunked_prefill(cfg: TransformerConfig, chunk_len: int,
                         num_slots: int, temperature: float = 0.0,
                         top_k: int = 0, top_p: float = 1.0,
                         kv_mode=None, constrain: bool = False) -> Callable:
    """Chunked admission prefill over the contiguous slot pool (reference
    :964): (params, ck, cv, pos, tok, toks [Ns, C], clen [Ns], start
    [Ns], last [Ns] bool, key) -> (ck, cv, pos, tok, first [Ns]); with
    ``kv_mode`` the pool is (ck, cv, kscale, vscale), chunk rows quantize
    on write and the cached prefix re-reads through its quantization.

    Each slot with clen > 0 advances by toks[i, :clen[i]], the slice
    [start, start + clen) of its committed prefix: its K/V rows land at
    those absolute positions (rows at or past S are dropped), the chunk
    attends the cache rows < start and itself (`_two_piece_attention`),
    and pos <- start + clen. Only slots with ``last`` set sample their
    first generated token into ``tok`` and ``first``; mid-prompt chunks
    report -1. start, clen and last are data: one program per
    (chunk_len, num_slots) serves every resume point. With ``constrain``
    only a final chunk's sample is masked into the state
    (`_chunk_first`)."""
    _check_slice(cfg)
    _check_sampling(top_k, top_p)
    kv_mode = resolve_mode(kv_mode)
    if not 0 < chunk_len <= cfg.max_len:
        raise ValueError(f"chunk_len {chunk_len} out of "
                         f"(0, {cfg.max_len}]")
    sampling = (temperature, top_k, top_p)

    @torch.no_grad()
    def body(params, kv, pos, tok, toks, clen, start, last, key: int,
             c=None):
        ns, n = toks.shape
        if (ns, n) != (num_slots, chunk_len):
            raise ValueError(f"toks {tuple(toks.shape)} != program "
                             f"geometry ({num_slots}, {chunk_len})")
        s_max = kv[0].shape[2]
        h, absp = _chunk_embed(params, cfg, toks, start)
        # the rows this call writes (valid and inside the pool): one
        # index list for every layer, so no pad row ever lands on a row
        # another entry writes
        valid = torch.arange(n, device=toks.device)[None, :] < clen[:, None]
        bi, ti = torch.nonzero(valid & (absp < s_max), as_tuple=True)
        pi = absp[bi, ti]
        mvalid = valid if cfg.n_experts > 0 else None   # reference :1032
        for layer in range(cfg.n_layers):
            def write(k, v, layer=layer):
                _store(kv, layer, (bi, pi), k[bi, ti], v[bi, ti])

            def view(layer=layer):
                return (kv[0][layer], kv[1][layer],
                        *(sc[layer, :, :, 0] for sc in kv[2:]))

            h = _chunk_block(h, layer_params(params, layer), cfg, write,
                             view, start, mvalid)
        first = _chunk_first(params, cfg, h, clen, start, pos, tok, last,
                             key, sampling, c)
        return (*kv, pos, tok, *(first if c is not None else (first,)))

    return _pool_program(kv_mode, 1, body, constrain)


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



def _check_spec(cfg: TransformerConfig, spec_k: int,
                draft_layers: int) -> int:
    """Validate a speculative program's geometry; returns the number of
    draft layers (0 -> every layer). MoE configs raise, as the
    reference's do (:2035)."""
    if spec_k < 1:
        raise ValueError(f"spec_k must be >= 1, got {spec_k}")
    if cfg.n_experts > 0:
        raise ValueError(
            "speculative decoding does not support MoE configs: the "
            "expert-capacity cap depends on the tokens-per-call count, "
            "so a K+1-token verify pass would drop differently than "
            "sequential decode and break token-exactness")
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


def _c_spec_window(spec_k: int, ds0, ctrans, drafts):
    """The DFA states of the K+1 verify-window rows [Ns, K+1] (reference
    :2079): entry j is the state after drafts[:, :j] from ds0, walked
    from the drafts as verified (poisoned or not), so the target's
    sample at row j is masked by the state the masked sequential decode
    holds there wherever the row can commit."""
    sw = [ds0]
    for j in range(spec_k):
        sw.append(_advance(ctrans, sw[-1], drafts[:, j]))
    return torch.stack(sw, dim=1)


def _c_spec_final(spec_k: int, swin, ctrans, tgt, c, act, ds0):
    """The DFA state after a round's commit (reference :2095): the window
    state at the last committed row advanced by the token committed
    there; inactive slots keep ds0."""
    rows = torch.arange(tgt.shape[0], device=tgt.device)
    j = torch.clamp(c - 1, 0, spec_k).long()
    return torch.where(act, _advance(ctrans, swin[rows, j], tgt[rows, j]),
                       ds0)


def _spec_round(cfg: TransformerConfig, spec_k: int, draft_phase,
                verify_phase, pos, tok, active, rem, poison, c):
    """One speculative round from its two phases (`draft_phase(act, c)`
    -> drafts [Ns, K]; `verify_phase(act, drafts, allow_w)` -> the
    target's samples [Ns, K+1]), then the commit; pos and tok are
    updated in place. With a constraint table ``c`` the drafts are
    masked by their own walk, each window row by `_c_spec_window`'s
    state, and the final states (`_c_spec_final`) close the result.
    Returns (pos, tok, emit, ncommit, drafted, accepted[, states])."""
    act = active & (rem > 0)
    drafts = draft_phase(act, c)
    drafts = torch.where(poison[:, None], (drafts + 1) % cfg.vocab_size,
                         drafts)
    swin = allow_w = None
    if c is not None:
        swin = _c_spec_window(spec_k, c[2], c[1], drafts)
        allow_w = c[0][swin.long()]                      # [Ns, K+1, V]
    tgt = verify_phase(act, drafts, allow_w)
    npos, ntok, _, emit, nc, drafted, accepted = _spec_accept_commit(
        spec_k, drafts, tgt, pos, tok, rem, act)
    pos.copy_(npos)
    tok.copy_(ntok)
    out = (pos, tok, emit, nc, drafted, accepted)
    if c is None:
        return out
    return (*out, _c_spec_final(spec_k, swin, c[1], tgt, nc, act, c[2]))


def _draft_steps(dparams, cfg: TransformerConfig, spec_k: int, nd: int,
                 block, pos, tok, act, key: int, sampling, c):
    """K sequential draft steps through decode's per-slot block
    ``block(h, layer, dpos, act)`` over the drafter's first ``nd``
    layers (their K/V rows land in the live cache; verify rewrites
    them); with a constraint table ``c`` each proposal is masked by the
    slot's state, which then advances (reference :2146-2186). Returns
    [Ns, K]."""
    dpos, dtok = pos, tok
    ds = None if c is None else c[2]
    drafts = []
    for _ in range(spec_k):
        h = _embed_pending(dparams, cfg, dpos, dtok)
        for layer in range(nd):
            h = block(h, layer, dpos, act)
        nxt = _head_sample(dparams, cfg, h, dpos + 1, key, *sampling,
                           allow=None if c is None else c[0][ds.long()])
        if c is not None:
            ds = torch.where(act, _advance(c[1], ds, nxt), ds)
        dtok = torch.where(act, nxt, dtok)
        dpos = torch.where(act, dpos + 1, dpos)
        drafts.append(nxt)
    return torch.stack(drafts, dim=1)


def make_speculative_decode(cfg: TransformerConfig, spec_k: int,
                            num_slots: int, temperature: float = 0.0,
                            top_k: int = 0, top_p: float = 1.0,
                            draft_layers: int = 0, kv_mode=None,
                            constrain: bool = False) -> Callable:
    """Speculative round over the contiguous slot pool (reference
    :2105): (params, dparams, ck, cv, pos, tok, active [Ns] bool, rem
    [Ns] int32, poison [Ns] bool, key) -> (ck, cv, pos, tok, emit
    [Ns, K+1], ncommit [Ns], drafted [Ns], accepted [Ns]); with
    ``kv_mode`` the pool is (ck, cv, kscale, vscale): draft and verify
    rows quantize on write, and the window reads them through the
    quantized window kernel, whose rows equal the quantized decode
    kernel's, so quantized spec reproduces quantized plain decode.

    Every active slot advances 1..K+1 tokens; ``emit[i, :ncommit[i]]``
    are its committed tokens (-1 beyond). ``dparams`` drive the K draft
    steps through their first ``draft_layers`` blocks (0: all);
    ``poison`` derails a slot's drafts to (d+1) mod V, so verification
    rejects them. The caches, pos and tok are updated in place; ``rem``
    is not. See the section comment for the exactness and cache-safety
    arguments. Either tree may be quantized (`quant.model.draft_tree`).
    ``constrain`` masks the drafts, the verify window and the commit
    (`_spec_round`, reference :2105)."""
    _check_slice(cfg)
    _check_sampling(top_k, top_p)
    kv_mode = resolve_mode(kv_mode)
    nd = _check_spec(cfg, spec_k, draft_layers)
    k1 = spec_k + 1

    sampling = (temperature, top_k, top_p)

    def verify_phase(params, kv, pos, tok, act, drafts, key, allow_w):
        """ONE target pass over the window: per layer each window row's
        K/V is written (rows at or past S dropped), then all rows attend
        through the window kernel. Returns the target's samples at the
        K+1 window positions [Ns, K+1], row t masked by ``allow_w[:, t]``
        when given."""
        s_max = kv[0].shape[2]
        rows = torch.arange(tok.shape[0], device=tok.device)
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
                wp = torch.clamp(posw[:, t], 0, s_max - 1)
                _store(kv, layer, (rows, wp.long()), k, v,
                       keep=act & (posw[:, t] < s_max))
                qs.append(q)
            ck, cv, sc = _attn_kv(kv)
            a = decode_window_attention(torch.stack(qs, dim=1), ck, cv,
                                        pos, n_heads=cfg.n_heads,
                                        layer=layer, **sc)  # [Ns, K+1, H, Dh]
            at = a.transpose(0, 1).contiguous()
            hs = [_block_out(hs[t], at[t], p, cfg) for t in range(k1)]
        return torch.stack([_head_sample(
            params, cfg, hs[t], posw[:, t] + 1, key, *sampling,
            allow=None if allow_w is None else allow_w[:, t])
            for t in range(k1)], dim=1)

    @torch.no_grad()
    def body(params, dparams, kv, pos, tok, active, rem, poison,
             key: int, c=None):
        if pos.shape != (num_slots,):
            raise ValueError(f"pos {tuple(pos.shape)} != program geometry "
                             f"({num_slots},)")

        def block(h, layer, dpos, act):
            return _local_block_decode_slotted(
                h, layer_params(dparams, layer), kv, layer, dpos, act, cfg)

        def draft(act, c):
            return _draft_steps(dparams, cfg, spec_k, nd, block, pos, tok,
                                act, key, sampling, c)

        def verify(act, drafts, allow_w):
            return verify_phase(params, kv, pos, tok, act, drafts, key,
                                allow_w)

        return (*kv, *_spec_round(cfg, spec_k, draft, verify, pos, tok,
                                  active, rem, poison, c))

    return _pool_program(kv_mode, 2, body, constrain)


# ---------------------------------------------------------------------------
# the paged pool: pages addressed through a host-owned block table
# ---------------------------------------------------------------------------
#
# Slot KV lives in [L, num_pages, page_size, D] pages; logical page j of
# slot i is physical page bt[i, j]. The engine owns the table (allocator,
# radix prefix cache, copy-on-write) and passes it to every call, so
# sharing and recycling pages never change a program's geometry. Page 0 is
# never allocated: pad rows, inactive slots and rows past the mapped pages
# write it, and no read of it is ever unmasked. Attention reads the pages
# through the logical view `_gather_pages` builds, as the reference does
# (:1335): the decode and window kernels then see the values the
# contiguous pool would hold at the same positions, at the same S.

def _check_paged(cfg: TransformerConfig, top_k: int, top_p: float,
                 page_size: int, num_pages: int, max_pages: int) -> None:
    """Paged-program validation (reference `_check_paged_mesh`, :1282,
    with no mesh: one device holds every page)."""
    _check_slice(cfg)
    _check_sampling(top_k, top_p)
    if page_size < 1:
        raise ValueError(f"page_size must be >= 1, got {page_size}")
    if num_pages < 2:
        raise ValueError(f"num_pages must be >= 2 (page 0 is the "
                         f"reserved scratch page), got {num_pages}")
    if max_pages * page_size < cfg.max_len:
        raise ValueError(
            f"block table of {max_pages} pages x {page_size} tokens "
            f"cannot address max_len={cfg.max_len}")


def init_paged_state(cfg: TransformerConfig, num_slots: int,
                     page_size: int, num_pages: int, device,
                     kv_mode=None):
    """The persistent paged pool (kp, vp, pos, tok) on ``device``: kp, vp
    [L, num_pages, page_size, D] zero-filled, pos and tok int32 [Ns]
    zeros. The block table is host data, not part of the state. With
    ``kv_mode`` ("int8" / "fp8", resolved against ``device``): the
    quantized pool (kp, vp, kscale, vscale, pos, tok) of
    `quant.kv.init_paged_quant_state`."""
    _check_slice(cfg)
    if resolve_mode(kv_mode, device) is not None:
        return init_paged_quant_state(cfg, num_slots, page_size, num_pages,
                                      kv_mode, device)
    dt = cfg.cache_torch_dtype()
    shape = page_pool_shape(cfg, num_pages, page_size)
    kp = torch.zeros(shape, dtype=dt, device=device)
    vp = torch.zeros(shape, dtype=dt, device=device)
    pos = torch.zeros((num_slots,), dtype=torch.int32, device=device)
    tok = torch.zeros((num_slots,), dtype=torch.int32, device=device)
    return kp, vp, pos, tok


def _gather_pages(plane, bt, ns: int, s_view: int):
    """A layer's pages [NP, ps, D] -> the block-table-ordered logical view
    [Ns, s_view, D] (one index, as the reference's gather; one-byte pages
    move as uint8 and keep their dtype). Unallocated table entries read
    the scratch page; the caller's position mask keeps them out of
    attention."""
    g = raw(plane)[bt.long()].reshape(ns, s_view, plane.shape[-1])
    return g.view(plane.dtype)


def _paged_view(kv, layer: int, bt, ns: int, s_view: int):
    """The gathered view of a paged pool's layer: (kh, vh) [Ns, s_view, D],
    and for a quantized pool its scales (ks, vs) [Ns, s_view] gathered
    with their pages (reference :1413-1416)."""
    kh, vh = (_gather_pages(c[layer], bt, ns, s_view) for c in kv[:2])
    return (kh, vh) + tuple(_gather_pages(c[layer], bt, ns, s_view)[..., 0]
                            for c in kv[2:])


def _page_rows(bt, posm, keep, page_size: int):
    """Physical (page, offset) of logical positions posm [Ns, T] through
    bt [Ns, max_pages]: entries not in ``keep`` [Ns, T] go to the scratch
    page 0 (offset posm % page_size)."""
    lp = torch.clamp(posm // page_size, 0, bt.shape[1] - 1).long()
    pg = torch.where(keep, torch.gather(bt, 1, lp), 0)
    return pg.long(), (posm % page_size).long()


def _last_write_wins(kv, pg, off, *rows):
    """``rows`` (each [*pg.shape, D]) for a write at (pg, off) of the
    paged pool ``kv``, with every write that shares its target with a
    later one, in row-major order, carrying that later write's values:
    duplicate writes then store one value, the last one's, whatever order
    the device applies them in. Pad rows and inactive slots all write the
    scratch page 0, which an index write stores in no defined order on
    the card (or on several CPU threads). An MoE decode routes every
    slot, so a free slot's hidden state, read from page 0 through its
    zeroed block table, reaches the active tokens through the experts'
    capacity; without this its tokens would change from run to run. Each
    target's winner is a max of write positions, exact on integers."""
    ps = kv[0].shape[2]
    t = (pg * ps + off).reshape(-1)
    pos = torch.arange(t.shape[0], device=t.device)
    win = torch.full((kv[0].shape[1] * ps,), -1, dtype=pos.dtype,
                     device=t.device)
    src = win.scatter_reduce(0, t, pos, "amax")[t]
    return tuple(r.reshape(t.shape[0], r.shape[-1])[src].reshape(r.shape)
                 for r in rows)


def _local_block_decode_paged(h, p, kv, bt, layer: int, pos, act,
                              cfg: TransformerConfig, page_size: int):
    """`_local_block_decode_slotted` on the paged pool ``kv`` (kp, vp, and
    the scale planes of a quantized pool; reference :1343 and
    `_local_block_decode_paged_q` :1384): the K/V row lands at
    (bt[slot, wp // ps], wp % ps), inactive slots writing the scratch
    page, and the decode kernel runs over the gathered view through the
    same `decode_attention` call, so paged decode is the contiguous
    decode over the same values."""
    q, k, v = _block_qkv(h, p, cfg)
    ns, mp = h.shape[0], bt.shape[1]
    s_view = mp * page_size
    wp = torch.clamp(pos, 0, s_view - 1)
    pg, off = _page_rows(bt, wp[:, None], act[:, None], page_size)
    if cfg.n_experts > 0:
        k, v = _last_write_wins(kv, pg[:, 0], off[:, 0], k, v)
    _store(kv, layer, (pg[:, 0], off[:, 0]), k, v)
    kh, vh, sc = _attn_kv(_paged_view(kv, layer, bt, ns, s_view))
    a = decode_attention(q, kh, vh, wp, n_heads=cfg.n_heads, **sc)
    return _block_out(h, a, p, cfg)


def make_paged_prefill(cfg: TransformerConfig, bucket_len: int,
                       num_slots: int, page_size: int, max_pages: int,
                       num_pages: int, temperature: float = 0.0,
                       top_k: int = 0, top_p: float = 1.0,
                       kv_mode=None, chunked: bool = False,
                       constrain: bool = False) -> Callable:
    """Paged admission prefill (reference :1430): (params, kp, vp, pos,
    tok, bt [Ns, max_pages], suffix [Ns, Tb], slen [Ns], start [Ns]
    [, last [Ns] bool when ``chunked``], key) -> (kp, vp, pos, tok,
    first [Ns]); with ``kv_mode`` the pool is (kp, vp, kscale, vscale),
    the suffix rows quantize on write and the cached prefix (a hit or
    earlier chunks) is read through its quantization in plain attention
    (reference :1532-1560).

    ``suffix`` holds each admitted slot's tokens not yet in its pages,
    from position ``start`` (a prefix-cache hit or, chunked, any chunk
    boundary), right-padded to Tb. Their K/V rows land at
    (bt[slot, (start+t) // ps], (start+t) % ps), pad rows on the scratch
    page; attention is `_two_piece_attention` over the gathered pages.
    Slots with slen == 0 pass through; the rest move pos to start +
    slen and sample the token there, which ``chunked`` programs commit
    only where ``last`` is set (mid-prompt chunks report -1). With
    ``constrain`` that token is masked into the state
    (`_chunk_first`, reference :1592)."""
    _check_paged(cfg, top_k, top_p, page_size, num_pages, max_pages)
    kv_mode = resolve_mode(kv_mode)
    if not 0 < bucket_len <= cfg.max_len:
        raise ValueError(f"bucket_len {bucket_len} out of "
                         f"(0, {cfg.max_len}]")
    s_view = max_pages * page_size
    sampling = (temperature, top_k, top_p)

    @torch.no_grad()
    def body(params, kv, pos, tok, bt, suffix, slen, start, last, key,
             c=None):
        ns, tb = suffix.shape
        if (ns, tb) != (num_slots, bucket_len) or \
                tuple(bt.shape) != (num_slots, max_pages):
            raise ValueError(f"suffix {tuple(suffix.shape)} / bt "
                             f"{tuple(bt.shape)} != program geometry "
                             f"({num_slots}, {bucket_len}, {max_pages})")
        h, absp = _chunk_embed(params, cfg, suffix, start)
        valid = torch.arange(tb, device=suffix.device)[None, :] \
            < slen[:, None]
        pg, off = _page_rows(bt, absp, valid, page_size)
        mvalid = valid if cfg.n_experts > 0 else None   # reference :1499
        for layer in range(cfg.n_layers):
            def write(k, v, layer=layer):
                if cfg.n_experts > 0:
                    k, v = _last_write_wins(kv, pg, off, k, v)
                _store(kv, layer, (pg, off), k, v)

            h = _chunk_block(h, layer_params(params, layer), cfg, write,
                             lambda layer=layer: _paged_view(
                                 kv, layer, bt, ns, s_view), start, mvalid)
        first = _chunk_first(params, cfg, h, slen, start, pos, tok, last,
                             key, sampling, c)
        return (*kv, pos, tok, *(first if c is not None else (first,)))

    if chunked:
        return _pool_program(kv_mode, 1, body, constrain)

    def one_shot(params, kv, pos, tok, bt, suffix, slen, start, key: int,
                 c=None):
        return body(params, kv, pos, tok, bt, suffix, slen, start,
                    torch.ones_like(slen, dtype=torch.bool), key, c)

    return _pool_program(kv_mode, 1, one_shot, constrain)


def make_paged_chunked_prefill(cfg: TransformerConfig, chunk_len: int,
                               num_slots: int, page_size: int,
                               max_pages: int, num_pages: int,
                               temperature: float = 0.0, top_k: int = 0,
                               top_p: float = 1.0, kv_mode=None,
                               constrain: bool = False) -> Callable:
    """Paged twin of `make_chunked_prefill` (reference :1753): (params,
    kp, vp, pos, tok, bt, toks [Ns, C], clen, start, last, key) -> (kp,
    vp, pos, tok, first), the pool (kp, vp, kscale, vscale) with
    ``kv_mode``. It is `make_paged_prefill` with the chunk as the suffix
    and ``last`` gating the first token."""
    return make_paged_prefill(cfg, chunk_len, num_slots, page_size,
                              max_pages, num_pages, temperature=temperature,
                              top_k=top_k, top_p=top_p, kv_mode=kv_mode,
                              chunked=True,
                              constrain=constrain)


def make_paged_decode(cfg: TransformerConfig, chunk: int, num_slots: int,
                      page_size: int, max_pages: int, num_pages: int,
                      temperature: float = 0.0, top_k: int = 0,
                      top_p: float = 1.0, kv_mode=None,
                      constrain: bool = False) -> Callable:
    """Paged decode chunk (reference :1780): (params, kp, vp, pos, tok,
    bt [Ns, max_pages], active [Ns] bool, rem [Ns] int32, key) -> (kp,
    vp, pos, tok, toks [Ns, chunk]). `make_continuous_decode`'s contract
    with K/V rows in block-table pages (`_local_block_decode_paged`); the
    pool (kp, vp, kscale, vscale) with ``kv_mode``; ``constrain`` as
    there."""
    _check_paged(cfg, top_k, top_p, page_size, num_pages, max_pages)
    kv_mode = resolve_mode(kv_mode)
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")

    @torch.no_grad()
    def body(params, kv, pos, tok, bt, active, rem, key: int, c=None):
        if pos.shape != (num_slots,) or \
                tuple(bt.shape) != (num_slots, max_pages):
            raise ValueError(f"pos {tuple(pos.shape)} / bt "
                             f"{tuple(bt.shape)} != program geometry "
                             f"({num_slots}, {max_pages})")

        def block(h, layer, act):
            return _local_block_decode_paged(
                h, layer_params(params, layer), kv, bt, layer, pos, act,
                cfg, page_size)

        return _decode_chunk(params, cfg, chunk, block, kv, pos, tok,
                             active, rem, key, sampling, c)

    sampling = (temperature, top_k, top_p)
    return _pool_program(kv_mode, 1, body, constrain)


def make_paged_speculative_decode(cfg: TransformerConfig, spec_k: int,
                                  num_slots: int, page_size: int,
                                  max_pages: int, num_pages: int,
                                  temperature: float = 0.0, top_k: int = 0,
                                  top_p: float = 1.0, kv_mode=None,
                                  draft_layers: int = 0,
                                  constrain: bool = False) -> Callable:
    """Speculative round on the paged pool (reference :2412): (params,
    dparams, kp, vp, pos, tok, bt, active, rem, poison, key) -> (kp, vp,
    pos, tok, emit [Ns, K+1], ncommit, drafted, accepted), with
    `make_speculative_decode`'s contract. Draft steps go through
    `_local_block_decode_paged`; the verify window's rows land at
    (bt[slot, pos_j // ps], pos_j % ps), inactive slots and positions
    past the mapped pages on the scratch page, and attend through the
    window kernel over the gathered view. The engine privatises every
    page the K+1 window can write before the call (copy-on-write). With
    ``kv_mode`` the pool is (kp, vp, kscale, vscale), as
    `make_speculative_decode` takes it, and ``constrain`` as there."""
    _check_paged(cfg, top_k, top_p, page_size, num_pages, max_pages)
    kv_mode = resolve_mode(kv_mode)
    nd = _check_spec(cfg, spec_k, draft_layers)
    k1 = spec_k + 1
    s_view = max_pages * page_size

    sampling = (temperature, top_k, top_p)

    def verify_phase(params, kv, bt, pos, tok, act, drafts, key, allow_w):
        """As the contiguous verify pass: decode's per-row code for each
        window row, the attention batched through the window kernel."""
        ns = tok.shape[0]
        win = torch.cat([tok[:, None], drafts], dim=1)   # [Ns, K+1]
        posw = pos[:, None] + torch.arange(k1, dtype=pos.dtype,
                                           device=pos.device)[None, :]
        pgw, offw = _page_rows(bt, posw, act[:, None] & (posw < s_view),
                               page_size)
        hs = [_embed_pending(params, cfg, posw[:, t], win[:, t])
              for t in range(k1)]
        for layer in range(cfg.n_layers):
            p = layer_params(params, layer)
            qs = []
            for t in range(k1):
                q, k, v = _block_qkv(hs[t], p, cfg)
                _store(kv, layer, (pgw[:, t], offw[:, t]), k, v)
                qs.append(q)
            kh, vh, sc = _attn_kv(_paged_view(kv, layer, bt, ns, s_view))
            a = decode_window_attention(torch.stack(qs, dim=1), kh, vh, pos,
                                        n_heads=cfg.n_heads, **sc)
            at = a.transpose(0, 1).contiguous()
            hs = [_block_out(hs[t], at[t], p, cfg) for t in range(k1)]
        return torch.stack([_head_sample(
            params, cfg, hs[t], posw[:, t] + 1, key, *sampling,
            allow=None if allow_w is None else allow_w[:, t])
            for t in range(k1)], dim=1)

    @torch.no_grad()
    def body(params, dparams, kv, pos, tok, bt, active, rem, poison,
             key: int, c=None):
        if pos.shape != (num_slots,) or \
                tuple(bt.shape) != (num_slots, max_pages):
            raise ValueError(f"pos {tuple(pos.shape)} / bt "
                             f"{tuple(bt.shape)} != program geometry "
                             f"({num_slots}, {max_pages})")

        def block(h, layer, dpos, act):
            return _local_block_decode_paged(
                h, layer_params(dparams, layer), kv, bt, layer, dpos, act,
                cfg, page_size)

        def draft(act, c):
            return _draft_steps(dparams, cfg, spec_k, nd, block, pos, tok,
                                act, key, sampling, c)

        def verify(act, drafts, allow_w):
            return verify_phase(params, kv, bt, pos, tok, act, drafts, key,
                                allow_w)

        return (*kv, *_spec_round(cfg, spec_k, draft, verify, pos, tok,
                                  active, rem, poison, c))

    return _pool_program(kv_mode, 2, body, constrain)


# ---------------------------------------------------------------------------
# KV handoff: gather and adopt (reference serving/engine.py :1162-1240)
# ---------------------------------------------------------------------------
#
# Plain index work at log2-bucketed page counts (`quant.kv.
# handoff_page_bucket`): the index vectors are data padded to the bucket,
# so the programs have one geometry per bucket. The adopt programs write
# the pool tensors IN PLACE (the engine's CUDA graphs hold the pool by
# identity); a padded index entry (``valid`` False) writes the scratch
# page 0, which no unmasked read sees. One-byte planes move as their
# bytes (`quant.core.raw`).

def make_page_gather() -> Callable:
    """``(idx [nb] int, *planes) -> tuple`` of each page plane
    [L, pages, page_size, X] gathered at ``idx`` -> [L, nb, page_size,
    X]: a page chain's K/V (and scale) rows, every layer at once."""
    def gather(idx, *planes):
        idx = idx.long()
        return tuple(raw(a)[:, idx].view(a.dtype) for a in planes)
    return gather


def make_slot_gather() -> Callable:
    """``(slot: int, rows: int, *planes) -> tuple`` of each slot plane
    [L, Ns, S, X] at ``slot``, rows [0, rows) -> [L, rows, X] (copies)."""
    def gather(slot, rows, *planes):
        return tuple(a[:, int(slot), :int(rows)].clone() for a in planes)
    return gather


def make_chain_adopt() -> Callable:
    """``(idx [nb], valid [nb] bool, *rows, *planes) -> planes``: each
    row buffer [L, nb, page_size, X] scattered into its page plane at
    ``idx`` (``valid`` False: the scratch page 0), in place; no slot's
    ``pos`` or ``tok`` is touched (a prefix-cache chain seeds the cache,
    not a seat)."""
    def adopt(idx, valid, *arrs):
        n = len(arrs) // 2
        rows, planes = arrs[:n], arrs[n:]
        tgt = torch.where(valid, idx, torch.zeros_like(idx)).long()
        for a, r in zip(planes, rows):
            raw(a)[:, tgt] = raw(r.to(a.dtype) if r.dtype != a.dtype
                                 else r)
        return planes
    return adopt


def make_kv_adopt() -> Callable:
    """``(idx, valid, slot, new_pos, new_tok, *rows, *planes, pos, tok)
    -> (*planes, pos, tok)``: `make_chain_adopt`'s scatter, then the
    slot's ``pos`` and ``tok`` set to the handed-off committed prefix, in
    place: the slot decodes on from there with no prefill."""
    chain = make_chain_adopt()

    def adopt(idx, valid, slot, new_pos, new_tok, *arrs):
        planes = chain(idx, valid, *arrs[:-2])
        pos, tok = arrs[-2], arrs[-1]
        pos[int(slot)] = int(new_pos)
        tok[int(slot)] = int(new_tok)
        return (*planes, pos, tok)
    return adopt


# ---------------------------------------------------------------------------
# batch mode: the whole-batch generate (reference :261-340)
# ---------------------------------------------------------------------------

def batch_key(seed: int, t0: int) -> int:
    """The counter root of one batch-mode generate call over prompts of
    length ``t0``: the port's analog of the reference's
    ``fold_in(PRNGKey(seed), t0)`` (:5158). It depends only on the seed
    and the decoded-position offset, so a retry, or a solo continuation
    of the same prefix, draws the same tokens."""
    a = _mix32((int(seed) & _M32) ^ 0x9E3779B9)
    return int(_mix32((a ^ (int(t0) & _M32)) & _M32))


def make_parallel_generate(cfg: TransformerConfig, max_new_tokens: int,
                           temperature: float = 0.0, top_k: int = 0,
                           top_p: float = 1.0) -> Callable:
    """Batch generate (reference :261, at tensor-parallel = data-parallel
    = 1): ``(params, prompt [B, T0] int, key: int) -> int32 [B, T0 +
    max_new_tokens]``. ``params`` is a float tree or a quantized one
    (`quant.model.quantize_params`), dequantized at each use. Prefill
    runs every layer over the whole prompt through `_local_block_prefill`
    (the flash forward on the card: one launch a layer) and fills a
    fresh [L, B, max_len, D] cache; each later token runs one decode step
    a layer through the decode kernel (the last token needs none: ``L x
    (max_new_tokens - 1)`` decode launches). Step i samples every row
    with counter (key, i) after the temperature / top-k / top-p filters;
    temperature <= 0 is greedy."""
    _check_slice(cfg)
    _check_sampling(top_k, top_p)
    if max_new_tokens < 1:
        raise ValueError(f"max_new_tokens must be >= 1, got "
                         f"{max_new_tokens}")

    @torch.no_grad()
    def run(params, prompt, key: int):
        dt = cfg.activation_dtype()
        b, t0 = prompt.shape
        if t0 + max_new_tokens > cfg.max_len:
            raise ValueError(f"generation length {t0 + max_new_tokens} "
                             f"exceeds max_len={cfg.max_len}")
        prompt = prompt.long()
        dev = prompt.device
        h = (params["embed"].to(dt)[prompt]
             + params["pos"].to(dt)[:t0][None])
        cdt = cfg.cache_torch_dtype()
        ck = torch.zeros(slot_cache_shape(cfg, b), dtype=cdt, device=dev)
        cv = torch.zeros_like(ck)
        for layer in range(cfg.n_layers):
            h, (k, v) = _local_block_prefill(
                h, layer_params(params, layer), cfg)
            ck[layer, :, :t0] = k.to(cdt)
            cv[layer, :, :t0] = v.to(cdt)
        h = layer_norm(h, params["lnfg"], params["lnfb"], cfg.eps)
        logits = torch.matmul(h[:, -1], params["Wout"].to(h.dtype))
        toks = []
        for i in range(max_new_tokens):
            step = torch.full((b,), i, dtype=torch.int64, device=dev)
            tok = sample_at_positions(logits, step, key, temperature,
                                      top_k, top_p)
            toks.append(tok)
            if i + 1 == max_new_tokens:
                break
            pos = t0 + i
            hh = (params["embed"].to(dt)[tok.long()]
                  + params["pos"].to(dt)[pos:pos + 1])[:, None, :]
            for layer in range(cfg.n_layers):
                p = layer_params(params, layer)
                q, k, v = _block_qkv(hh, p, cfg)
                ck[layer, :, pos] = k.to(cdt)
                cv[layer, :, pos] = v.to(cdt)
                a = decode_attention(q, ck, cv, pos, n_heads=cfg.n_heads,
                                     layer=layer)
                hh = _block_out(hh, a, p, cfg)
            hh = layer_norm(hh, params["lnfg"], params["lnfb"], cfg.eps)
            logits = torch.matmul(hh[:, 0], params["Wout"].to(hh.dtype))
        return torch.cat([prompt, torch.stack(toks, dim=1).long()],
                         dim=1).to(torch.int32)

    return run

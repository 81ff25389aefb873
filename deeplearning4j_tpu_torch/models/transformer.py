"""TransformerLM — port of deeplearning4j_tpu/models/transformer.py.

Functional like the reference: `init_params` returns a dictionary of
tensors with the same keys and layout (blocks stacked over a leading
[L] axis, every weight [in, out] so both sides compute ``x @ W``), and
`forward`, `loss_fn`, `prefill`, `decode_step` and `generate` are
plain functions on it. KV caches keep the reference's flattened-head layout
[L, B, S, D=H*Dh]. Attention goes through `nn.layers.attention`
(prefill: the flash-forward kernel) and `ops.flash_decode` (every decode
step: the decode kernel), and gradients through the flash backward
kernel; projections, MLP and output head stay `torch.matmul`, as the
reference left them to XLA.

Training (reference :200-260, :554-613): `loss_fn` is the dense mean NLL
over float32 logits, or `chunked_cross_entropy` over V/C vocab panels
when `xent_chunk` is set. `remat` checkpoints with
`torch.utils.checkpoint` (non-reentrant) where the reference used
`jax.checkpoint`: 'full' each block, 'mlp' only the MLP, 'dots' each
block under a selective policy that saves the outputs of the 2-D matrix
products (`x @ W`, the counterpart of
`dots_with_no_batch_dims_saveable`) and recomputes the rest, including
the flash forward inside `FlashAttention`, as the reference recomputes
its custom_vjp.

Where the reference donated a cache buffer to a jitted step, the port
writes the cache row in place (`decode_step`).

Sampling. JAX's threefry cannot be reproduced, so the port draws with a
counter-based generator written in torch integer ops, identical on CPU
and CUDA: Gumbel-max over uniforms hashed from (seed, index, vocab id).
It keeps the reference's property (:470-481): the token at index j is a
function of (seed, j, the logits at j) only, never of batch placement.
`generate` keys each draw by its step index (reference :517); the slot
programs of parallel/serving key by sequence position (reference
parallel/serving.py:812).

Not on this slice (each raises NotImplementedError naming its ROADMAP
item): mixture-of-experts MLPs (`n_experts > 0`, `capacity_factor`) and
sequence-parallel attention (`seq_impl`).
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from deeplearning4j_tpu_torch._device import resolve_device
from deeplearning4j_tpu_torch.nn.layers.attention import (
    dot_product_attention, layer_norm)
from deeplearning4j_tpu_torch.ops.flash_decode import decode_attention

Params = Dict[str, Any]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float64": torch.float64}

_MOE_TODO = "mixture-of-experts MLP is not ported yet (ROADMAP queue A3)"


@dataclass(frozen=True)
class TransformerConfig:
    """Same fields and defaults as the reference's TransformerConfig."""
    vocab_size: int = 256
    d_model: int = 128
    n_heads: int = 4
    n_layers: int = 4
    max_len: int = 256
    mlp_ratio: int = 4
    dtype: str = "float32"          # activation dtype
    n_experts: int = 0
    capacity_factor: float = 1.25
    eps: float = 1e-5
    remat: bool = False
    remat_policy: str = "full"
    seq_impl: str = "ring"
    xent_chunk: int = 0
    cache_dtype: Optional[str] = None

    @property
    def d_head(self) -> int:
        return self.d_model // self.n_heads

    @property
    def d_ff(self) -> int:
        return self.d_model * self.mlp_ratio

    def activation_dtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]

    def cache_torch_dtype(self) -> torch.dtype:
        """KV-cache storage dtype: `cache_dtype` when set, else the
        activation dtype."""
        if not self.cache_dtype:
            return self.activation_dtype()
        return _DTYPES[self.cache_dtype]


# fields the reference reads only in code this slice does not port; a
# non-default value raises instead of being silently ignored
_UNPORTED_FIELDS = {
    "capacity_factor": (1.25, _MOE_TODO),
    "seq_impl": ("ring", "seq_impl (sequence-parallel attention) is not "
                 "ported yet (ROADMAP queue A12)"),
}


def _check_slice(cfg: TransformerConfig) -> None:
    for name, (default, todo) in _UNPORTED_FIELDS.items():
        if getattr(cfg, name) != default:
            raise NotImplementedError(todo)
    if cfg.n_experts > 0:
        raise NotImplementedError(_MOE_TODO)


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

def init_params(cfg: TransformerConfig, seed: int = 0,
                device=None) -> Params:
    """Random parameters in the reference's layout, drawn from a seeded
    CPU `torch.Generator` (so CPU and CUDA runs hold the same values)
    and moved to ``device``. Values differ from JAX's init; parity tests
    convert a JAX tree with `models.convert.params_from_numpy`."""
    _check_slice(cfg)
    dev = resolve_device(device)
    g = torch.Generator(device="cpu").manual_seed(int(seed))
    d, f, L, v = cfg.d_model, cfg.d_ff, cfg.n_layers, cfg.vocab_size

    def w(shape, fan_in):
        return torch.randn(shape, generator=g) / (fan_in ** 0.5)

    blocks = {
        "Wq": w((L, d, d), d), "Wk": w((L, d, d), d),
        "Wv": w((L, d, d), d), "Wo": w((L, d, d), d),
        "ln1g": torch.ones(L, d), "ln1b": torch.zeros(L, d),
        "ln2g": torch.ones(L, d), "ln2b": torch.zeros(L, d),
        "W1": w((L, d, f), d), "b1": torch.zeros(L, f),
        "W2": w((L, f, d), f), "b2": torch.zeros(L, d),
    }
    params = {
        "embed": torch.randn((v, d), generator=g) * 0.02,
        "pos": torch.randn((cfg.max_len, d), generator=g) * 0.02,
        "blocks": blocks,
        "lnfg": torch.ones(d), "lnfb": torch.zeros(d),
        "Wout": w((d, v), d),
    }
    return params_to(params, dev)


def params_to(params: Params, device) -> Params:
    """The same tree with every leaf on ``device``."""
    return {k: (params_to(v, device) if isinstance(v, dict)
                else v.to(device)) for k, v in params.items()}


def layer_params(params: Params, layer: int) -> Dict[str, torch.Tensor]:
    return {k: v[layer] for k, v in params["blocks"].items()}


# ---------------------------------------------------------------------------
# block body
# ---------------------------------------------------------------------------

def dense_mlp(h, p) -> torch.Tensor:
    z = torch.matmul(h, p["W1"].to(h.dtype)) + p["b1"].to(h.dtype)
    # jax.nn.gelu defaults to the tanh approximation
    z = F.gelu(z, approximate="tanh")
    return torch.matmul(z, p["W2"].to(h.dtype)) + p["b2"].to(h.dtype)


def block_forward(h, p, cfg: TransformerConfig,
                  mask: Optional[torch.Tensor] = None,
                  return_kv: bool = False, remat_mlp: bool = False):
    """One pre-LN block on [B, T, D]; ``return_kv`` also returns the
    block's K/V heads [B, T, H, Dh] (the cache-prefill path);
    ``remat_mlp`` checkpoints just the MLP (remat_policy 'mlp')."""
    _check_slice(cfg)
    d = cfg.d_model
    x = layer_norm(h, p["ln1g"], p["ln1b"], cfg.eps)

    def heads(y):
        return y.reshape(y.shape[0], y.shape[1], cfg.n_heads, cfg.d_head)

    q = heads(torch.matmul(x, p["Wq"].to(x.dtype)))
    k = heads(torch.matmul(x, p["Wk"].to(x.dtype)))
    v = heads(torch.matmul(x, p["Wv"].to(x.dtype)))
    a = dot_product_attention(q, k, v, causal=True, mask=mask)
    h = h + torch.matmul(a.reshape(a.shape[0], a.shape[1], d),
                         p["Wo"].to(h.dtype))
    x = layer_norm(h, p["ln2g"], p["ln2b"], cfg.eps)
    if remat_mlp:
        h = h + checkpoint(dense_mlp, x, p, use_reentrant=False)
    else:
        h = h + dense_mlp(x, p)
    if return_kv:
        return h, (k, v)
    return h


def _embed(cfg: TransformerConfig, params: Params, tokens) -> torch.Tensor:
    dt = cfg.activation_dtype()
    t = tokens.shape[1]
    return (params["embed"].to(dt)[tokens.long()]
            + params["pos"].to(dt)[:t][None])


def _dots_policy(ctx, op, *args, **kwargs):
    """'dots': keep the 2-D matrix products (every x @ W reaches aten.mm),
    recompute the rest; batched products (aten.bmm) have batch dims."""
    return (CheckpointPolicy.MUST_SAVE if op is torch.ops.aten.mm.default
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat_block(h, p, cfg: TransformerConfig) -> torch.Tensor:
    """One block checkpointed under remat 'full' or 'dots'."""
    kw = {}
    if cfg.remat_policy == "dots":
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _dots_policy)
    return checkpoint(block_forward, h, p, cfg, use_reentrant=False, **kw)


def forward_hidden(cfg: TransformerConfig, params: Params,
                   tokens) -> torch.Tensor:
    """tokens [B, T] -> final-LN hidden states [B, T, D] (what `loss_fn`
    consumes, so the chunked cross-entropy can fuse the output
    projection into its vocab panels)."""
    _check_slice(cfg)
    if cfg.remat and cfg.remat_policy not in ("full", "dots", "mlp"):
        raise ValueError(f"unknown remat_policy {cfg.remat_policy!r}: "
                         "expected 'full', 'dots' or 'mlp'")
    remat_mlp = cfg.remat and cfg.remat_policy == "mlp"
    h = _embed(cfg, params, tokens)
    for layer in range(cfg.n_layers):
        p = layer_params(params, layer)
        if cfg.remat and not remat_mlp:
            h = _remat_block(h, p, cfg)
        else:
            h = block_forward(h, p, cfg, remat_mlp=remat_mlp)
    return layer_norm(h, params["lnfg"], params["lnfb"], cfg.eps)


def forward(cfg: TransformerConfig, params: Params, tokens) -> torch.Tensor:
    """tokens [B, T] -> logits [B, T, V]."""
    h = forward_hidden(cfg, params, tokens)
    return torch.matmul(h, params["Wout"].to(h.dtype))


def _xent_panel(x, w_i, y, c0: int, m, s, tl):
    """One vocab panel of `chunked_cross_entropy`: logits in the
    activation dtype, then float32; online logsumexp update; the target
    logit picked up where it falls in this panel."""
    chunk = w_i.shape[1]
    logits = torch.matmul(x, w_i.to(x.dtype)).to(torch.float32)
    m_new = torch.maximum(m, logits.amax(dim=-1))
    s = (s * torch.exp(m - m_new)
         + torch.exp(logits - m_new[:, None]).sum(dim=-1))
    local = y - c0
    hit = (local >= 0) & (local < chunk)
    g = torch.gather(logits, 1, local.clamp(0, chunk - 1)[:, None])[:, 0]
    return m_new, s, torch.where(hit, g, tl)


def chunked_cross_entropy(h, wout, targets, chunk: int) -> torch.Tensor:
    """Mean NLL of ``targets`` under softmax(h @ wout) over V/chunk vocab
    panels with an online logsumexp, never holding more than one
    [B*T, chunk] float32 panel of logits (reference :554-600). Each
    panel is checkpointed, so the backward recomputes it instead of
    keeping every panel (which would rebuild the full logits)."""
    d, v = wout.shape
    if v % chunk != 0:
        raise ValueError(f"vocab {v} not divisible by xent_chunk {chunk}")
    x = h.reshape(-1, d)
    y = targets.reshape(-1).to(torch.int64)
    n = x.shape[0]
    m = torch.full((n,), float("-inf"), dtype=torch.float32,
                   device=x.device)
    s = torch.zeros((n,), dtype=torch.float32, device=x.device)
    tl = torch.zeros_like(s)
    for c0 in range(0, v, chunk):
        m, s, tl = checkpoint(_xent_panel, x, wout[:, c0:c0 + chunk], y, c0,
                              m, s, tl, use_reentrant=False)
    return torch.mean(m + torch.log(s) - tl)


def loss_fn(cfg: TransformerConfig, params: Params, tokens,
            targets) -> torch.Tensor:
    """Mean next-token NLL (reference :603-613): the chunked
    cross-entropy when `xent_chunk` splits the vocabulary, else
    log_softmax over float32 logits."""
    if cfg.xent_chunk > 0 and cfg.vocab_size > cfg.xent_chunk:
        h = forward_hidden(cfg, params, tokens)
        return chunked_cross_entropy(h, params["Wout"], targets,
                                     cfg.xent_chunk)
    logits = forward(cfg, params, tokens).to(torch.float32)
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, targets.to(torch.int64)[..., None])[..., 0]
    return torch.mean(nll)


# ---------------------------------------------------------------------------
# KV-cache decoding
# ---------------------------------------------------------------------------

def slot_cache_shape(cfg: TransformerConfig, num_slots: int
                     ) -> Tuple[int, int, int, int]:
    """Slot-pool KV-cache geometry [L, num_slots, S, D] (heads
    flattened, D = H*Dh, S = max_len)."""
    return (cfg.n_layers, num_slots, cfg.max_len, cfg.d_model)


def page_pool_shape(cfg: TransformerConfig, num_pages: int,
                    page_size: int) -> Tuple[int, int, int, int]:
    """Paged KV-pool geometry [L, num_pages, page_size, D] (reference
    :293): the slot pool's per-slot rows as a shared pool of
    ``page_size``-token pages addressed through per-slot block tables.
    Heads stay flattened (D = H*Dh); physical page 0 is the scratch
    page that masked writes land on."""
    return (cfg.n_layers, num_pages, page_size, cfg.d_model)


def init_cache(cfg: TransformerConfig, batch: int,
               device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stacked per-layer KV caches [L, B, S, D] (k, v), zero-filled, in
    `cfg.cache_torch_dtype()`."""
    shape = slot_cache_shape(cfg, batch)
    dt = cfg.cache_torch_dtype()
    dev = resolve_device(device)
    return (torch.zeros(shape, dtype=dt, device=dev),
            torch.zeros(shape, dtype=dt, device=dev))


def _block_decode(h, p, ck_all, cv_all, layer: int, pos: int,
                  cfg: TransformerConfig):
    """One block, one new position for every batch row: h [B, 1, D].
    The new K/V row is written IN PLACE at (layer, :, pos) of the
    stacked caches (the reference donated the buffer to get the same
    effect), then the query attends rows 0..pos through the decode
    kernel, which reads the layer plane of the stacked buffer."""
    d = cfg.d_model
    x = layer_norm(h, p["ln1g"], p["ln1b"], cfg.eps)
    q = torch.matmul(x, p["Wq"].to(x.dtype)).reshape(
        x.shape[0], 1, cfg.n_heads, cfg.d_head)
    k = torch.matmul(x, p["Wk"].to(x.dtype))        # [B, 1, D] flat
    v = torch.matmul(x, p["Wv"].to(x.dtype))
    ck_all[layer, :, pos] = k[:, 0].to(ck_all.dtype)
    cv_all[layer, :, pos] = v[:, 0].to(cv_all.dtype)
    a = decode_attention(q[:, 0], ck_all, cv_all, pos,
                         n_heads=cfg.n_heads, layer=layer)  # [B, H, Dh]
    h = h + torch.matmul(a.reshape(a.shape[0], 1, d), p["Wo"].to(h.dtype))
    x = layer_norm(h, p["ln2g"], p["ln2b"], cfg.eps)
    return h + dense_mlp(x, p)


def decode_step(cfg: TransformerConfig, params: Params, token,
                caches: Tuple[torch.Tensor, torch.Tensor], pos: int):
    """token [B] at position ``pos`` -> (logits [B, V], caches). The
    caches are updated in place and returned (the reference's default
    donation)."""
    _check_slice(cfg)
    ck_all, cv_all = caches
    pos = int(pos)
    dt = cfg.activation_dtype()
    emb = params["embed"].to(dt)[token.long()]               # [B, D]
    posv = params["pos"].to(dt)[pos:pos + 1]                 # [1, D]
    h = (emb + posv)[:, None, :]                             # [B, 1, D]
    for layer in range(cfg.n_layers):
        h = _block_decode(h, layer_params(params, layer), ck_all, cv_all,
                          layer, pos, cfg)
    h = layer_norm(h, params["lnfg"], params["lnfb"], cfg.eps)
    logits = torch.matmul(h[:, 0], params["Wout"].to(h.dtype))
    return logits, (ck_all, cv_all)


def prefill(cfg: TransformerConfig, params: Params, prompt):
    """One batched pass over the prompt: last-position logits + filled
    KV caches [L, B, S, D]."""
    _check_slice(cfg)
    b, t0 = prompt.shape
    h = _embed(cfg, params, prompt)
    ck, cv = init_cache(cfg, b, device=prompt.device)
    for layer in range(cfg.n_layers):
        h, (k, v) = block_forward(h, layer_params(params, layer), cfg,
                                  return_kv=True)
        ck[layer, :, :t0] = k.reshape(b, t0, cfg.d_model).to(ck.dtype)
        cv[layer, :, :t0] = v.reshape(b, t0, cfg.d_model).to(cv.dtype)
    h = layer_norm(h, params["lnfg"], params["lnfb"], cfg.eps)
    last_logits = torch.matmul(h[:, -1], params["Wout"].to(h.dtype))
    return last_logits, (ck, cv)


# ---------------------------------------------------------------------------
# sampling
# ---------------------------------------------------------------------------

def _check_sampling(top_k: int, top_p: float) -> None:
    if not 0.0 < top_p <= 1.0:
        raise ValueError(f"top_p must be in (0, 1], got {top_p}")
    if top_k < 0:
        raise ValueError(f"top_k must be >= 0, got {top_k}")


def _filter_logits(logits, top_k: int, top_p: float) -> torch.Tensor:
    """The reference's top-k / top-p filters on [B, V] float32 logits
    (:436): filtered entries drop to -inf; one descending sort serves
    both filters; the top-1 token always survives."""
    v = logits.shape[-1]
    use_k = bool(top_k) and top_k < v
    use_p = top_p < 1.0
    if not (use_k or use_p):
        return logits
    # made on the device (a host scalar would be a copy, which a CUDA
    # graph capture refuses)
    neg = logits.new_full((), float("-inf"))
    sorted_l = torch.sort(logits, dim=-1, descending=True).values
    if use_k:
        kth = sorted_l[:, top_k - 1:top_k]
        logits = torch.where(logits < kth, neg, logits)
    if use_p:
        if use_k:   # mask the same tail in the sorted view
            idx = torch.arange(v, device=logits.device)[None, :]
            sorted_l = torch.where(idx >= top_k, neg, sorted_l)
        probs = torch.softmax(sorted_l, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        keep_n = ((cum - probs) < top_p).sum(dim=-1, keepdim=True)
        cutoff = torch.gather(sorted_l, 1, keep_n - 1)
        logits = torch.where(logits < cutoff, neg, logits)
    return logits


_M32 = 0xFFFFFFFF
_MIX = 0x45D9F3B      # < 2**31: every product of a 32-bit value fits int64


def _mix32(x):
    """32-bit integer finalizer on int64 tensors (or ints) holding values
    in [0, 2**32): identical on every device."""
    x = (((x >> 16) ^ x) * _MIX) & _M32
    x = (((x >> 16) ^ x) * _MIX) & _M32
    return (x >> 16) ^ x


def gumbel_noise(seed: int, posidx, vocab: int) -> torch.Tensor:
    """Float64 Gumbel noise [N, V] that depends only on (seed, posidx[i],
    vocab id): the port's counter-based stand-in for threefry
    `fold_in(key, j)` draws."""
    a = _mix32((int(seed) & _M32) ^ 0x3243F6A8)
    j = posidx.to(torch.int64).reshape(-1, 1) & _M32
    b = _mix32(j ^ a)
    vid = torch.arange(vocab, dtype=torch.int64, device=posidx.device)
    x = _mix32((vid[None, :] * 0x27D4EB2D + b) & _M32)
    u = ((x >> 8).to(torch.float64) + 0.5) * (1.0 / (1 << 24))
    return -torch.log(-torch.log(u))


def sample_at_positions(logits, posidx, seed: int, temperature: float,
                        top_k: int, top_p: float) -> torch.Tensor:
    """Position-keyed sampling on [N, V] logits: row i draws with
    counter (seed, posidx[i]) after the temperature / top-k / top-p
    filters (greedy ignores the seed). Returns int32 [N]."""
    if temperature <= 0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    filt = _filter_logits(logits.to(torch.float32) / temperature,
                          top_k, top_p)
    g = gumbel_noise(seed, posidx, filt.shape[-1])
    return torch.argmax(filt.to(torch.float64) + g, dim=-1).to(torch.int32)


def generate(cfg: TransformerConfig, params: Params, prompt,
             max_new_tokens: int, seed: int = 0, temperature: float = 1.0,
             top_k: int = 0, top_p: float = 1.0) -> torch.Tensor:
    """Autoregressive sampling with a KV cache: one batched prefill, then
    ``max_new_tokens`` cached decode steps. temperature <= 0 is greedy.
    Step i draws with counter (seed, i) for every row. Returns int32
    [B, T0 + max_new_tokens] on the prompt's device."""
    total = prompt.shape[1] + max_new_tokens
    if total > cfg.max_len:
        raise ValueError(f"generation length {total} exceeds "
                         f"max_len={cfg.max_len}")
    _check_sampling(top_k, top_p)
    if prompt.numel() and (int(prompt.min()) < 0
                           or int(prompt.max()) >= cfg.vocab_size):
        # an out-of-range id would fault the device-side gather
        raise ValueError(f"prompt token ids must be in "
                         f"[0, {cfg.vocab_size})")
    prompt = prompt.to(torch.int64)
    b, t0 = prompt.shape
    with torch.no_grad():
        logits, caches = prefill(cfg, params, prompt)
        toks = []
        for i in range(max_new_tokens):
            step = torch.full((b,), i, dtype=torch.int64,
                              device=prompt.device)
            tok = sample_at_positions(logits, step, seed, temperature,
                                      top_k, top_p)
            toks.append(tok)
            if i + 1 < max_new_tokens:
                logits, caches = decode_step(cfg, params, tok.long(),
                                             caches, t0 + i)
    out = torch.stack(toks, dim=1) if toks else prompt[:, :0]
    return torch.cat([prompt, out.to(torch.int64)], dim=1).to(torch.int32)


# ---------------------------------------------------------------------------
# model surface
# ---------------------------------------------------------------------------

class TransformerLM:
    """Thin stateful wrapper (the reference's TransformerLM): parameters
    from a seed on ``device`` (CUDA unless ``device="cpu"``)."""

    def __init__(self, cfg: TransformerConfig, seed: int = 0,
                 device: Union[str, torch.device, None] = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.params = init_params(cfg, seed, self.device)

    def logits(self, tokens) -> torch.Tensor:
        with torch.no_grad():
            return forward(self.cfg, self.params,
                           torch.as_tensor(tokens, device=self.device))

    def loss(self, tokens, targets) -> float:
        with torch.no_grad():
            return float(loss_fn(
                self.cfg, self.params,
                torch.as_tensor(tokens, device=self.device),
                torch.as_tensor(targets, device=self.device)))

    def generate(self, prompt, max_new_tokens: int, *,
                 temperature: float = 1.0, top_k: int = 0,
                 top_p: float = 1.0, seed: int = 0) -> torch.Tensor:
        """KV-cached autoregressive sampling; see `generate`."""
        prompt = torch.as_tensor(prompt, device=self.device)
        return generate(self.cfg, self.params, prompt, max_new_tokens,
                        seed, temperature, top_k=top_k, top_p=top_p)

#!/usr/bin/env python3
"""Chip smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's serving path on the card and fails (non-zero exit, no
result line) if anything is wrong:

1. Kernel vs plain, on the card: the flash-forward kernel at the main
   path's bf16 prefill shapes (64 slots x 8 heads, Dh=64, causal, T=1024
   as the engine's bucket in phase 3, T=64 as generate's prompt, T=512)
   plus small odd float32 shapes, and the decode kernel at the serving
   decode shape (B=64, S=2048, D=512, H=8, stacked cache; float32 with
   L=2, and bf16 with L=12, layer 5; vector pos including 0 and 2047,
   and a scalar pos). bf16 results are held per row to 2^-7 of the
   plain row's largest entry, float32 results to 1e-5. Each comparison
   prints one JSON line: its errors and tolerance, the kernel's and the
   plain version's times, the time of one PyTorch library call for the
   same function (`scaled_dot_product_attention`, a yardstick the port
   never calls), the least time the card could take (bound) and the
   shape. The summary reports each kernel at the engine's shape.
2. float32 end to end, card vs CPU: a 2-layer model at the full width
   (512d / 8 heads) serves 8 greedy requests x 16 new tokens through
   `InferenceEngine` on cuda and on cpu; tokens must match exactly and
   the prefill / first-step logits within 1e-3.
3. Full width: the 12L / 512d / 8H / V=256 / max_len 2048 bf16 engine with
   64 slots and decode_chunk 8 answers 128 requests (prompt lengths 16..1024
   from seed 0, 64 new tokens), then `TransformerLM.generate` runs B=64,
   prompt 64, 128 new greedy tokens. Every launch counter is reset just
   before each run and read just after: each kernel must have run, the
   flash kernel n_layers times per prefill call and the decode kernel
   n_layers x chunk times per decode chunk. One more engine tick (64
   admissions + one decode chunk) runs under torch.profiler and prints
   the device time by kernel and the device's idle share of the tick.
4. Summary: one `kernels` JSON line, then the last line
   {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.

The kernels build from deeplearning4j_tpu_torch/csrc/ at the start (one
nvcc per source, started together). Weights are random, from fixed seeds.
"""
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM data-sheet peaks (the bound of every kernel line)
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "float32": 67e12}


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def line(obj) -> None:
    print(json.dumps(obj), flush=True)


def time_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Mean milliseconds per call, from CUDA events around ``iters``
    back-to-back calls after ``warmup`` calls."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes: float, flops: float, dtype: str):
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


# ---------------------------------------------------------------------------
# phase 1: kernels vs their plain versions
# ---------------------------------------------------------------------------

# a bfloat16 result is right to one rounding of its row's magnitude: the
# kernel and its plain twin sum in float32 in other orders and may round
# an element to neighbouring bf16 values, one ulp apart, and one ulp of
# any entry is at most 2**-7 of the row's largest entry; a fault in the
# online-softmax merge moves outputs by their own size
BF16_ROW_RTOL = 2.0 ** -7
BF16_ATOL = 1e-5
BF16_TOL = f"|err| <= 2^-7 * max|plain row| + {BF16_ATOL}"


def row_rel_err(got, want) -> float:
    """Worst |got - want| in units of the bf16 limit of its row (the last
    axis): 2^-7 * max|want_row| + BF16_ATOL. Right when <= 1."""
    g, w = got.float(), want.float()
    row = w.abs().amax(dim=-1, keepdim=True)
    return float(((g - w).abs() / (row * BF16_ROW_RTOL + BF16_ATOL)).max())


def phase_kernels(torch, dev):
    """Each kernel against its plain twin, on the card, at the shapes the
    main path gives it; times at the engine's shapes for the summary."""
    from deeplearning4j_tpu_torch.ops import flash_attention as fa
    from deeplearning4j_tpu_torch.ops import flash_decode as fd
    import torch.nn.functional as F

    g = torch.Generator(device="cpu").manual_seed(0)
    results = {}

    def rnd(shape, dtype):
        return torch.randn(shape, generator=g).to(dev, dtype)

    # -- flash forward at the main path's bf16 prefill shapes ------------
    # 64 slots (or generate's 64 rows) x 8 heads, Dh 64, causal; T=1024 is
    # the engine's prefill bucket in phase 3 (its prompts reach 1024),
    # T=64 generate's prompt, T=512 a half-full bucket
    bh, dh = 64 * 8, 64
    scale = dh ** -0.5
    bf = torch.bfloat16
    for t in (1024, 64, 512):
        q3, k3, v3 = (rnd((bh, t, dh), bf) for _ in range(3))
        o, m, logl = fa.flash_forward_cuda(q3, k3, v3, scale, True)
        ro, rm, rl = fa.flash_forward_reference(q3, k3, v3, scale, True)
        err = max_err(o, ro)
        rel = row_rel_err(o, ro)
        err_stats = max(max_err(m, rm), max_err(logl, rl))
        if not (rel <= 1.0 and err_stats <= 1e-4):
            fail(f"flash forward bf16 T={t}: max err {err}, row-relative "
                 f"{rel} (limit 1), stats {err_stats}")
        k_ms = time_ms(lambda: fa.flash_forward_cuda(q3, k3, v3, scale,
                                                     True))
        p_ms = time_ms(lambda: fa.flash_forward_reference(
            q3, k3, v3, scale, True), iters=3)
        q4, k4, v4 = (x.view(64, 8, t, dh) for x in (q3, k3, v3))
        lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
            q4, k4, v4, is_causal=True, scale=scale))
        nbytes = 4 * bh * t * dh * 2 + 2 * bh * t * 4
        flops = 4 * bh * dh * (t * (t + 1) // 2)
        b_ms, b_by = bound(nbytes, flops, "bfloat16")
        rec = dict(phase=1, kernel="flash_fwd", dtype="bfloat16",
                   causal=True, shape=[bh, t, dh], max_abs_err=err,
                   row_rel_err=rel,
                   tol=BF16_TOL,
                   stats_err=err_stats, stats_tol=1e-4, kernel_ms=k_ms,
                   plain_ms=p_ms, library_ms=lib_ms, bound_ms=b_ms,
                   bound_by=b_by)
        line(rec)
        if t == 1024:
            results["flash_fwd"] = rec
        del q3, k3, v3, o, ro, q4, k4, v4

    # -- flash forward, small odd float32 shapes -------------------------
    for tq, sk, qo, ko in ((100, 100, 0, 0), (64, 96, 0, 32),
                           (77, 200, 123, 0)):
        qs = rnd((6, tq, dh), torch.float32)
        ks, vs = rnd((6, sk, dh), torch.float32), rnd((6, sk, dh),
                                                      torch.float32)
        got = fa.flash_forward_cuda(qs, ks, vs, scale, True, qo, ko)
        want = fa.flash_forward_reference(qs, ks, vs, scale, True, qo, ko)
        errs = [max_err(x, y) for x, y in zip(got, want)]
        line(dict(phase=1, kernel="flash_fwd", dtype="float32",
                  shape=[6, tq, sk, dh], q_offset=qo, kv_offset=ko,
                  max_abs_err=max(errs), tol=1e-5))
        if not max(errs) <= 1e-5:
            fail(f"flash forward f32 {tq}x{sk} offsets {qo},{ko}: {errs}")

    # -- decode at the serving decode shape ------------------------------
    L, B, S, D, H = 12, 64, 2048, 512, 8
    Dh = D // H
    layer = 5
    pos_v = torch.from_numpy(np.random.default_rng(0).integers(
        0, S, size=B).astype(np.int32))
    pos_v[0], pos_v[1] = 0, S - 1
    pos_v = pos_v.to(dev)

    # float32 at the serving shape (stacked 2-layer pool, as phase 2)
    ck, cv = rnd((2, B, S, D), torch.float32), rnd((2, B, S, D),
                                                   torch.float32)
    qd = rnd((B, H, Dh), torch.float32)
    got = fd.decode_attention_cuda(qd, ck, cv, pos_v, H, layer=1)
    want = fd.reference_decode_attention(qd, ck[1], cv[1], pos_v, H)
    err32 = max_err(got, want)
    line(dict(phase=1, kernel="decode_attention", dtype="float32",
              shape=[2, B, S, D], layer=1, pos="vector [0..2047]",
              max_abs_err=err32, tol=1e-5))
    if not err32 <= 1e-5:
        fail(f"decode float32 vector pos: max err {err32}")
    del ck, cv, qd

    ck, cv = rnd((L, B, S, D), bf), rnd((L, B, S, D), bf)
    qd = rnd((B, H, Dh), bf)
    got = fd.decode_attention_cuda(qd, ck, cv, pos_v, H, layer=layer)
    want = fd.reference_decode_attention(qd, ck[layer], cv[layer], pos_v, H)
    err_v = max_err(got, want)
    rel_v = row_rel_err(got, want)
    if not rel_v <= 1.0:
        fail(f"decode vector pos: max err {err_v}, row-relative {rel_v}")
    rows = int((pos_v.long() + 1).sum())
    nb_v = 2 * rows * Dh * H * 2 + 2 * B * D * 2 + B * 4
    bv_ms, bv_by = bound(nb_v, 4 * rows * D, "bfloat16")
    kv_ms = time_ms(lambda: fd.decode_attention_cuda(qd, ck, cv, pos_v, H,
                                                     layer=layer))
    line(dict(phase=1, kernel="decode_attention", dtype="bfloat16",
              shape=[L, B, S, D], layer=layer, pos="vector [0..2047]",
              max_abs_err=err_v, row_rel_err=rel_v,
              tol=BF16_TOL, kernel_ms=kv_ms,
              bound_ms=bv_ms, bound_by=bv_by))

    pos_s = S - 1                                   # a full cache
    got = fd.decode_attention_cuda(qd, ck, cv, pos_s, H, layer=layer)
    want = fd.reference_decode_attention(qd, ck[layer], cv[layer], pos_s, H)
    err_s = max_err(got, want)
    rel_s = row_rel_err(got, want)
    if not rel_s <= 1.0:
        fail(f"decode scalar pos: max err {err_s}, row-relative {rel_s}")
    k_ms = time_ms(lambda: fd.decode_attention_cuda(qd, ck, cv, pos_s, H,
                                                    layer=layer))
    p_ms = time_ms(lambda: fd.reference_decode_attention(
        qd, ck[layer], cv[layer], pos_s, H), iters=5)
    kl = ck[layer].view(B, S, H, Dh).transpose(1, 2)
    vl = cv[layer].view(B, S, H, Dh).transpose(1, 2)
    ql = qd.view(B, H, 1, Dh)
    lib_ms = time_ms(lambda: F.scaled_dot_product_attention(ql, kl, vl))
    nbytes = 2 * B * S * D * 2 + 2 * B * D * 2
    b_ms, b_by = bound(nbytes, 4 * B * S * D, "bfloat16")
    rec = dict(phase=1, kernel="decode_attention", dtype="bfloat16",
               shape=[L, B, S, D], layer=layer, pos=pos_s,
               max_abs_err=max(err_s, err_v), row_rel_err=rel_s,
               tol=BF16_TOL, kernel_ms=k_ms,
               plain_ms=p_ms, library_ms=lib_ms, bound_ms=b_ms,
               bound_by=b_by)
    line(rec)
    results["decode_attention"] = rec
    del ck, cv
    torch.cuda.empty_cache()
    return results


# ---------------------------------------------------------------------------
# phase 2: float32 end to end, card vs CPU
# ---------------------------------------------------------------------------

def phase_f32_card_vs_cpu(torch, dev):
    from deeplearning4j_tpu_torch.models import transformer as tf
    from deeplearning4j_tpu_torch.serving.engine import (EngineConfig,
                                                         InferenceEngine)
    cfg = tf.TransformerConfig(vocab_size=256, d_model=512, n_heads=8,
                               n_layers=2, max_len=2048, dtype="float32")
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, 256, size=int(n)).astype(np.int32)
               for n in rng.integers(8, 65, size=8)]
    outs, logits = {}, {}
    for name in ("cuda", "cpu"):
        d = dev if name == "cuda" else torch.device("cpu")
        params = tf.init_params(cfg, seed=1, device=d)
        eng = InferenceEngine(cfg, params, EngineConfig(
            num_slots=8, decode_chunk=8, max_new_tokens=16), device=d)
        hs = [eng.submit(p) for p in prompts]
        eng.run_pending()
        outs[name] = [h.result() for h in hs]
        batch = torch.from_numpy(np.stack([p[:8] for p in prompts])).to(d)
        with torch.no_grad():
            last, caches = tf.prefill(cfg, params, batch)
            step, _ = tf.decode_step(cfg, params, last.argmax(-1), caches, 8)
        logits[name] = (last.cpu(), step.cpu())
    same = all(np.array_equal(a, b) for a, b in zip(outs["cuda"],
                                                   outs["cpu"]))
    lerr = max(float((a - b).abs().max())
               for a, b in zip(logits["cuda"], logits["cpu"]))
    line(dict(phase=2, requests=len(prompts), new_tokens=16,
              tokens_equal=same, logits_max_abs_err=lerr, tol=1e-3))
    if not same:
        fail("float32 engine tokens differ between card and CPU")
    if not lerr <= 1e-3:
        fail(f"float32 logits differ between card and CPU by {lerr}")


# ---------------------------------------------------------------------------
# phase 3: the full-width serving path, with launch counts
# ---------------------------------------------------------------------------

def phase_full_width(torch, dev):
    from deeplearning4j_tpu_torch.models import transformer as tf
    from deeplearning4j_tpu_torch.ops import flash_attention as fa
    from deeplearning4j_tpu_torch.ops import flash_decode as fd
    from deeplearning4j_tpu_torch.serving.engine import (EngineConfig,
                                                         InferenceEngine)
    cfg = tf.TransformerConfig(vocab_size=256, d_model=512, n_heads=8,
                               n_layers=12, max_len=2048, dtype="bfloat16")
    L = cfg.n_layers
    n_req, new = 128, 64
    rng = np.random.default_rng(0)
    lens = rng.integers(16, 1025, size=n_req)
    prompts = [rng.integers(0, 256, size=int(n)).astype(np.int32)
               for n in lens]
    lm = tf.TransformerLM(cfg, seed=0, device=dev)
    eng = InferenceEngine(cfg, lm.params, EngineConfig(
        num_slots=64, decode_chunk=8, max_new_tokens=new, max_queue=256,
        degrade_queue_depth=1024), device=dev)

    fa.flash_forward_cuda.launches = 0
    fd.decode_attention_cuda.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    hs = [eng.submit(p) for p in prompts]
    eng.run_pending()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n_flash, n_dec = (fa.flash_forward_cuda.launches,
                      fd.decode_attention_cuda.launches)
    for h, p in zip(hs, prompts):
        out = h.result()
        if out.shape != (p.shape[0] + new,) or \
                not np.array_equal(out[:p.shape[0]], p) or \
                out.min() < 0 or out.max() >= cfg.vocab_size:
            fail(f"request {h.rid}: bad result of shape {out.shape}")
    c = eng.counts
    if n_flash != L * c["prefill_calls"] or \
            n_dec != L * eng.decode_chunk * c["decode_chunks"]:
        fail(f"engine launch counts flash={n_flash} decode={n_dec} vs "
             f"{c} with L={L}, chunk={eng.decode_chunk}")
    steps = eng.decode_chunk * c["decode_chunks"]
    line(dict(phase=3, run="engine", requests=n_req, answered=len(hs),
              new_tokens=new, prompt_len_min=int(lens.min()),
              prompt_len_max=int(lens.max()), wall_s=wall,
              tokens_per_s=n_req * new / wall,
              prefill_calls=c["prefill_calls"],
              prefill_s=eng.seconds["prefill"],
              decode_chunks=c["decode_chunks"],
              decode_s=eng.seconds["decode"],
              ms_per_decode_step=eng.seconds["decode"] / steps * 1e3,
              flash_launches=n_flash, decode_launches=n_dec))

    gb, gt, gnew = 64, 64, 128
    prompt = torch.from_numpy(rng.integers(0, 256, size=(gb, gt)).astype(
        np.int32)).to(dev)
    fa.flash_forward_cuda.launches = 0
    fd.decode_attention_cuda.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = lm.generate(prompt, gnew, temperature=0.0)
    torch.cuda.synchronize()
    gwall = time.perf_counter() - t0
    g_flash, g_dec = (fa.flash_forward_cuda.launches,
                      fd.decode_attention_cuda.launches)
    if tuple(out.shape) != (gb, gt + gnew) or \
            not torch.equal(out[:, :gt], prompt):
        fail(f"generate returned shape {tuple(out.shape)}")
    if g_flash != L or g_dec != L * (gnew - 1):
        fail(f"generate launch counts flash={g_flash} decode={g_dec}")
    # generate is one call: its wall time per new token includes the
    # B=64 prompt prefill
    line(dict(phase=3, run="generate", batch=gb, prompt=gt, new_tokens=gnew,
              wall_s=gwall, tokens_per_s=gb * gnew / gwall,
              wall_ms_per_new_token=gwall / gnew * 1e3,
              flash_launches=g_flash, decode_launches=g_dec))
    phase_profile(torch, eng, rng)
    return {"flash_fwd": n_flash + g_flash,
            "decode_attention": n_dec + g_dec}


def phase_profile(torch, eng, rng):
    """One engine tick (64 admissions of 64 tokens + one decode chunk of
    8) under torch.profiler: device time by kernel and the device's idle
    share of the tick's wall time."""
    from torch.profiler import ProfilerActivity, profile
    prompts = [rng.integers(0, 256, size=64).astype(np.int32)
               for _ in range(eng.num_slots)]
    warm = [eng.submit(p, max_new_tokens=9) for p in prompts]
    eng.run_pending()
    hs = [eng.submit(p, max_new_tokens=9) for p in prompts]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.tick()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    eng.run_pending()
    if not all(h.done() for h in hs + warm):
        fail("profiled tick left requests unanswered")
    # device-side events only (the kernels themselves): the host ops that
    # launched them report the same device time again
    rows = []
    for e in prof.key_averages():
        if not str(getattr(e, "device_type", "")).endswith("CUDA"):
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        if us > 0:
            rows.append((e.key, us, e.count))
    busy = sum(us for _, us, _ in rows) / 1e6
    rows.sort(key=lambda r: -r[1])
    line(dict(phase=3, run="profiled_tick", wall_s=wall,
              device_busy_s=busy if rows else "not measured",
              device_idle_share=(1 - busy / wall) if rows
              else "not measured",
              top_kernels=[dict(name=k[:80], ms=us / 1e3, count=n)
                           for k, us, n in rows[:8]]))


# ---------------------------------------------------------------------------

def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(ROOT, "deeplearning4j_tpu_torch")):
        print("chip_smoke: run from a checkout of the repository "
              "(deeplearning4j_tpu_torch/ not found)", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() \
        else "nvidia-smi unavailable"
    print(card, flush=True)

    import deeplearning4j_tpu_torch  # noqa: F401  (sets allow_tf32=False)
    from deeplearning4j_tpu_torch.ops import _build
    t0 = time.perf_counter()
    _build.build_all()
    line(dict(phase=0, build_s=time.perf_counter() - t0,
              torch=torch.__version__, cuda=torch.version.cuda))

    measured = phase_kernels(torch, dev)
    phase_f32_card_vs_cpu(torch, dev)
    launches = phase_full_width(torch, dev)

    sources = {
        "flash_fwd": ("deeplearning4j_tpu_torch/csrc/flash_fwd.cu",
                      "deeplearning4j_tpu/ops/flash_attention.py:138"),
        "decode_attention": (
            "deeplearning4j_tpu_torch/csrc/decode_attention.cu",
            "deeplearning4j_tpu/ops/flash_decode.py:187"),
    }
    kernels = []
    for name, (src, rep) in sources.items():
        r = measured[name]
        if launches[name] <= 0:
            fail(f"kernel {name} was never launched on the main path")
        kernels.append(dict(
            name=name, route="cuda", source=src, replaces=rep,
            launches=launches[name], max_abs_err=r["max_abs_err"],
            ms=r["kernel_ms"], plain_ms=r["plain_ms"],
            bound_ms=r["bound_ms"], bound_by=r["bound_by"],
            library_ms=r["library_ms"]))
    print(card, flush=True)
    line({"kernels": kernels})
    line({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())

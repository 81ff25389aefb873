"""The port's profiling layer: the analytic program cost, the profiler's
arithmetic against JAX's, the tenant meter, the chip-peak table and the
on-demand torch.profiler capture.

`program_cost` takes the place of XLA's cost analysis. Its matmul FLOPs
outside attention must equal `torch.utils.flop_counter.FlopCounterMode`'s
count of the same CPU program call, with the attention (a kernel on the
card, which the counter cannot see there) replaced by a stub that does no
arithmetic; its attention FLOPs and its bytes are held to a hand count at
a small size. Both are exact (integer arithmetic in float64: rel 1e-12).
The profiler and the tenant meter run the same calls as JAX's, with
injected peaks and an injected clock, and must report the same numbers
and the same Prometheus text.
"""
import json
import os
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401

from deeplearning4j_tpu.observability import export as jex  # noqa: E402
from deeplearning4j_tpu.observability import metrics as jme  # noqa: E402
from deeplearning4j_tpu.observability import profiling as jprof  # noqa

from deeplearning4j_tpu_torch.models import transformer as tf  # noqa: E402
from deeplearning4j_tpu_torch.observability import export as tex  # noqa
from deeplearning4j_tpu_torch.observability import metrics as tme  # noqa
from deeplearning4j_tpu_torch.observability import profiling as tprof  # noqa
from deeplearning4j_tpu_torch.parallel import serving as tsv  # noqa: E402
from deeplearning4j_tpu_torch.util import flops as tflops  # noqa: E402

EXACT = dict(rtol=1e-12, atol=0)
NS = 3
FIELDS = dict(vocab_size=40, d_model=32, n_heads=4, n_layers=2, max_len=32)


def _cfg(**kw):
    return tf.TransformerConfig(**{**FIELDS, **kw})


def _zero_attention(monkeypatch):
    """Every attention of the slot programs as a stub of the right shape
    that does no arithmetic, so the FLOP counter sees only the rest."""
    def like_q(q, *a, **k):
        return torch.zeros_like(q)

    for name in ("dot_product_attention", "decode_attention",
                 "decode_window_attention", "_two_piece_attention"):
        monkeypatch.setattr(tsv, name, like_q)


def _counted(fn, *args):
    from torch.utils.flop_counter import FlopCounterMode
    with FlopCounterMode(display=False) as fc:
        fn(*args)
    return float(fc.get_total_flops())


def _call(cfg, kind, kv_mode=None, ps=4):
    """(program, its arguments, ctx, lens, paged geometry) of one small
    call of ``kind`` on a fresh pool."""
    params = tf.init_params(cfg, seed=0, device="cpu")
    g = torch.Generator().manual_seed(0)
    ns, v = NS, cfg.vocab_size
    mp = cfg.max_len // ps
    npages = NS * mp + 1
    paged = kind.startswith("paged")
    if paged:
        state = tsv.init_paged_state(cfg, ns, ps, npages, "cpu",
                                     kv_mode=kv_mode)
        bt = torch.arange(1, ns * mp + 1, dtype=torch.int32).reshape(ns, mp)
        lead = (bt,)
        geo = (ps, mp, npages)
    else:
        state = tsv.init_slot_state(cfg, ns, "cpu", kv_mode=kv_mode)
        lead, geo = (), ()
    pos = state[-2]
    ctx = np.array([3, 0, 9])
    pos.copy_(torch.from_numpy(ctx.astype(np.int32)))
    kw = dict(kv_mode=kv_mode)
    base = kind.removeprefix("paged_")
    if base == "prefill":
        tb = 8
        lens = np.array([5, 0, 8])
        toks = torch.randint(0, v, (ns, tb), generator=g, dtype=torch.int32)
        plen = torch.from_numpy(lens.astype(np.int32))
        if paged:
            fn = tsv.make_paged_prefill(cfg, tb, ns, *geo, **kw)
            start = torch.from_numpy(ctx.astype(np.int32))
            args = (params, *state, *lead, toks, plen, start, 0)
        else:
            ctx = np.zeros(ns, np.int64)
            fn = tsv.make_continuous_prefill(cfg, tb, ns, **kw)
            args = (params, *state, toks, plen, 0)
        return fn, args, ctx, lens, tb, geo
    if base == "chunked_prefill":
        c = 4
        lens = np.array([4, 0, 2])
        toks = torch.randint(0, v, (ns, c), generator=g, dtype=torch.int32)
        clen = torch.from_numpy(lens.astype(np.int32))
        start = torch.from_numpy(ctx.astype(np.int32))
        last = torch.tensor([True, False, True])
        maker = (tsv.make_paged_chunked_prefill if paged
                 else tsv.make_chunked_prefill)
        fn = maker(cfg, c, ns, *geo, **kw)
        return (fn, (params, *state, *lead, toks, clen, start, last, 0),
                ctx, lens, c, geo)
    active = torch.tensor([True, False, True])
    rem = torch.tensor([2, 0, 1], dtype=torch.int32)
    if base == "decode":
        c = 2
        maker = tsv.make_paged_decode if paged else tsv.make_continuous_decode
        fn = maker(cfg, c, ns, *geo, **kw)
        lens = np.array([2, 0, 1])
        return (fn, (params, *state, *lead, active, rem, 0), ctx, lens, c,
                geo)
    k = 2
    maker = (tsv.make_paged_speculative_decode if paged
             else tsv.make_speculative_decode)
    fn = maker(cfg, k, ns, *geo, draft_layers=1, **kw)
    poison = torch.zeros(ns, dtype=torch.bool)
    return (fn, (params, params, *state, *lead, active, rem, poison, 0), ctx,
            np.array([1, 0, 1]), k, geo)


CASES = {"decode": ({}, "decode", None),
         "prefill": ({}, "prefill", None),
         "chunked_prefill": ({}, "chunked_prefill", None),
         "spec": ({}, "spec", None),
         "paged_decode": ({}, "paged_decode", None),
         "paged_prefill": ({}, "paged_prefill", None),
         "paged_chunked_prefill": ({}, "paged_chunked_prefill", None),
         "paged_spec": ({}, "paged_spec", None),
         "int8kv_decode": ({}, "decode", "int8"),
         "int8kv_paged_spec": ({}, "paged_spec", "int8"),
         "moe_decode": ({"n_experts": 4}, "decode", None),
         "moe_prefill": ({"n_experts": 4, "capacity_factor": 1.25},
                         "prefill", None),
         "moe_paged_chunked": ({"n_experts": 4, "capacity_factor": 0.5},
                               "paged_chunked_prefill", None)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_linear_flops_equal_flop_counter(monkeypatch, case):
    fields, kind, kv_mode = CASES[case]
    cfg = _cfg(**fields)
    _zero_attention(monkeypatch)
    fn, args, ctx, lens, size, geo = _call(cfg, kind, kv_mode)
    ps, mp = (geo[0], geo[1]) if geo else (0, 0)
    cost = tprof.program_cost(cfg, kind, size, NS, ctx, lens,
                              kv_mode=kv_mode, draft_layers=1,
                              page_size=ps, max_pages=mp)
    want = _counted(fn, *args)
    assert want > 0
    np.testing.assert_allclose(cost["linear_flops"], want, **EXACT)
    # the masked variant costs the same
    assert tprof.program_cost(cfg, kind + "_c", size, NS, ctx, lens,
                              kv_mode=kv_mode, draft_layers=1,
                              page_size=ps, max_pages=mp) == cost


def _hand(kind, kv_mode=None):
    """A hand count of ``_call``'s geometry for the attention FLOPs and
    the bytes (D=32, L=2, S=32, Ns=3, page 4 -> view 32; f32 pool 128
    bytes a row, int8 32 + 4)."""
    D, L, S = 32, 2, 32
    row = 36 if kv_mode else 128                     # one K or V row
    kvb = 2 * row
    w = {"layer": 1000.0, "head": 100.0, "embed_row": 10.0}
    d = {"layer": 300.0, "head": 30.0, "embed_row": 3.0}
    view = NS * S * kvb                              # a layer's view
    gather = 2 * view                                # read pages, write
    if kind == "decode":
        # slot 0: pos 3, 2 steps -> rows 4, 5; slot 1 (inactive): pos 0 ->
        # 1, 1; slot 2: pos 9, 1 step -> 10, 11 (its second step idle)
        rows = (4 + 5) + (1 + 1) + (10 + 11)
        attn = L * 4 * D * rows
        wb = 2 * (L * 1000 + 100 + NS * 10)
        kv = L * (rows * kvb + 2 * NS * kvb)
        return attn, wb + kv, w, None
    if kind == "paged_decode":
        rows = 9 + 2 + 21
        wb = 2 * (L * 1000 + 100 + NS * 10)
        kv = L * (rows * kvb + 2 * NS * kvb + 2 * gather)
        return L * 4 * D * rows, wb + kv, w, None
    if kind == "prefill":
        tb = 8
        attn = L * 4 * D * NS * tb * (tb + 1) / 2
        wb = L * 1000 + 100 + NS * tb * 10
        kv = L * 2 * tb * kvb                         # two admitted slots
        return attn, wb + kv, w, None
    if kind == "chunked_prefill":
        c = 4
        attn = L * 4 * D * NS * c * (S + c)
        wb = L * 1000 + 100 + NS * c * 10
        kv = L * (6 * kvb + NS * S * kvb)             # 4 + 2 rows written
        return attn, wb + kv, w, None
    if kind == "paged_chunked_prefill":
        c = 4
        attn = L * 4 * D * NS * c * (S + c)
        wb = L * 1000 + 100 + NS * c * 10
        # every slot's chunk rows written (pads to the scratch page), the
        # gather, then the einsum's read of the whole view
        kv = L * (NS * c * kvb + gather + view)
        return attn, wb + kv, w, None
    if kind == "paged_spec":
        k = 2
        # drafts: slot 0 pos 3, 4; slot 1 0, 0; slot 2 9, 10 (+1 rows)
        drows = (4 + 5) + (1 + 1) + (10 + 11)
        # verify rows pos .. pos + 2 for every slot (+1 rows)
        vrows = (4 + 5 + 6) + (1 + 2 + 3) + (10 + 11 + 12)
        attn = 4 * D * (1 * drows + L * vrows)
        wb = (k * (1 * 300 + 30 + NS * 3)
              + (k + 1) * (L * 1000 + 100 + NS * 10))
        kv = (1 * (drows * kvb + k * NS * kvb + k * gather)
              + L * ((6 + 3 + 12) * kvb + (k + 1) * NS * kvb + gather))
        return attn, wb + kv, w, d
    raise AssertionError(kind)


@pytest.mark.parametrize("kind,kv_mode", [
    ("decode", None), ("paged_decode", None), ("prefill", None),
    ("chunked_prefill", None), ("paged_chunked_prefill", None),
    ("paged_chunked_prefill", "int8"), ("paged_spec", None),
    ("paged_spec", "int8"), ("decode", "int8")])
def test_attention_and_bytes_hand_count(kind, kv_mode):
    cfg = _cfg()
    _, _, ctx, lens, size, geo = _call(cfg, kind, kv_mode)
    attn, nbytes, w, d = _hand(kind, kv_mode)
    ps, mp = (geo[0], geo[1]) if geo else (0, 0)
    cost = tprof.program_cost(cfg, kind, size, NS, ctx, lens,
                              kv_mode=kv_mode, weights=w, draft=d,
                              draft_layers=1, page_size=ps, max_pages=mp)
    np.testing.assert_allclose(cost["attn_flops"], attn, **EXACT)
    np.testing.assert_allclose(cost["bytes"], nbytes, **EXACT)
    np.testing.assert_allclose(cost["flops"],
                               cost["linear_flops"] + attn, **EXACT)


def test_tree_bytes_reads_stored_dtypes():
    from deeplearning4j_tpu_torch.quant.model import (param_bytes,
                                                      quantize_params)
    cfg = _cfg()
    p = tf.init_params(cfg, seed=0, device="cpu")
    for tree in (p, quantize_params(p, mode="int8")):
        b = tprof.tree_bytes(tree, cfg)
        total = (b["layer"] * cfg.n_layers + b["head"]
                 + b["embed_row"] * cfg.vocab_size)
        # every tensor but the position table (counted a row a token)
        pos = param_bytes(tree["pos"])
        np.testing.assert_allclose(
            total, param_bytes(tree) - pos + pos / cfg.max_len
            * cfg.vocab_size, rtol=1e-12)
    assert tprof.tree_bytes(quantize_params(p, mode="int8"), cfg)["layer"] \
        < 0.6 * tprof.tree_bytes(p, cfg)["layer"]


# ---------------------------------------------------------------------------
# roofline, the profiler, the tenant meter: the same arithmetic as JAX's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("args", [(1e9, 1e6, 989e12, 3.35e12),
                                  (1e9, 1e9, 989e12, 3.35e12),
                                  (5.0, 0.0, 1.0, 1.0),
                                  (1e9, 1e6, None, 3.35e12),
                                  (2950.0, 10.0, 295.0, 1.0)])
def test_roofline_matches(args):
    assert tprof.roofline(*args) == jprof.roofline(*args)


class _Clock:
    def __init__(self):
        self.t = 50.0

    def __call__(self):
        self.t += 0.25
        return self.t


def _profile_script(s, monkeypatch):
    """The same calls on a profiler of each package (s = (profiling,
    metrics, export)), with injected peaks and clock."""
    prof_mod, me, ex = s
    monkeypatch.setattr(prof_mod, "_perf", _Clock())
    reg = me.MetricsRegistry()
    p = prof_mod.EngineProfiler(reg, peak_flops=1e12,
                                peak_bytes_per_s=1e10, tenant_top_n=2,
                                window_s=1e9)
    p.record_program("prefill_b64", {"flops": 4e9, "bytes": 2e7}, 256)
    p.record_program("decode", {"flops": 1e8, "bytes": 5e7}, 32)
    p.record_program("spec_decode_k4", {}, 40)      # rate-less
    ticks = [(["prefill_b64", "decode"], 0.010),
             (["decode"], 0.002),
             ([], 0.003),                            # drain tail
             (["decode", "spec_decode_k4"], 0.004),
             (["unknown"], 0.001),
             ([], 0.0)]
    for labels, busy in ticks:
        p.tick_begin()
        for lab in labels:
            p.dispatched(lab)
        p.tick_end(busy)

    class H:
        pass
    hs = []
    for i, (tenant, label, n, kind) in enumerate([
            ("a", "prefill_b64", 100, "prefill"), ("b", "decode", 7,
                                                   "decode"),
            (None, "decode", 3, "decode"), ("c", "prefill_b64", 5,
                                            "prefill"),
            ("a", "spec_decode_k4", 4, "decode"), ("d", None, 2, "decode")]):
        h = H()
        h.tenant = tenant
        p.bill_tokens(h, label, n, kind)
        hs.append((getattr(h, "cost_flops", 0.0),
                   getattr(h, "cost_bytes", 0.0)))
    return (p.report(), p.program_report(), p.mfu(), p.achieved(),
            p.token_cost("decode"), hs, ex.prometheus_text(reg))


def test_engine_profiler_matches_jax(monkeypatch):
    want = _profile_script((jprof, jme, jex), monkeypatch)
    got = _profile_script((tprof, tme, tex), monkeypatch)
    assert got == want
    assert want[0]["mfu"] > 0 and want[1]["decode"]["bound"] == "memory"
    assert want[1]["prefill_b64"]["bound"] == "compute"


def test_per_invocation_costs_sum_exactly(monkeypatch):
    """The port's dispatches carry their own cost: totals are the sum,
    the report's per-invocation figure their mean."""
    monkeypatch.setattr(tprof, "_perf", _Clock())
    p = tprof.EngineProfiler(tme.MetricsRegistry(), peak_flops=1e12,
                             peak_bytes_per_s=1e10)
    for f in (1e6, 3e6, 5e6):
        p.tick_begin()
        p.dispatched("decode", {"flops": f, "bytes": f / 10})
        p.tick_end(0.001)
    row = p.program_report()["decode"]
    assert row["invocations"] == 3 and row["flops_total"] == 9e6
    assert row["flops_per_invocation"] == 3e6
    assert row["bytes_total"] == pytest.approx(9e5)
    assert row["device_seconds"] == pytest.approx(0.003)


def test_tenant_meter_folds_like_jax():
    def run(prof_mod, me, ex):
        reg = me.MetricsRegistry()
        m = prof_mod.TenantMeter(reg, top_n=3)
        for i, t in enumerate(["a", None, "b", "c", "d", "a", "e", "b",
                               "f"]):
            m.bill(t, 1e6 * (i + 1), 1e3 * i, i + 1,
                   "prefill" if i % 2 else "decode")
        return m.report(), [m.label_for(t) for t in "abcdefg"], \
            ex.prometheus_text(reg)

    want = run(jprof, jme, jex)
    assert run(tprof, tme, tex) == want
    assert want[0]["tenants"].keys() == {"a", "default", "b", "other"}
    assert want[0]["bills_folded_to_other"] == 4


def test_chip_peaks(monkeypatch):
    assert tflops.chip_peak_flops("cpu") is None
    assert tflops.chip_peak_bytes_per_s("cpu") is None
    p = tprof.EngineProfiler(tme.MetricsRegistry(), device="cpu")
    assert p.peak_flops is None and p.mfu() == 0.0
    assert p.report()["ridge_flops_per_byte"] is None
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    for name, want in (("NVIDIA H100 80GB HBM3", (989e12, 3.35e12)),
                       ("NVIDIA A100-SXM4-80GB", (None, None))):
        monkeypatch.setattr(torch.cuda, "get_device_name",
                            lambda d=None, name=name: name)
        assert (tflops.chip_peak_flops(), tflops.chip_peak_bytes_per_s()) \
            == want
        assert tflops.chip_peak_flops("cuda:0") == want[0]


# ---------------------------------------------------------------------------
# ProfileCapture on the CPU
# ---------------------------------------------------------------------------

def _wait_idle(cap, limit=60.0):
    t0 = time.monotonic()
    while cap.active:
        assert time.monotonic() - t0 < limit, "capture never finished"
        time.sleep(0.02)


def test_profile_capture_writes_a_trace(tmp_path):
    cap = tprof.ProfileCapture(str(tmp_path / "prof"))
    code, body = cap.capture("0.2")
    assert code == 200, body
    assert set(body) == {"started", "seconds", "directory", "capture"}
    busy, _ = cap.capture(0.1)                       # single flight
    assert busy == 503
    x = torch.randn(64, 64)
    for _ in range(5):
        x = x @ x.T / 64
    _wait_idle(cap)
    files = os.listdir(tmp_path / "prof")
    assert len(files) == 1 and files[0].endswith(".json")
    with open(tmp_path / "prof" / files[0]) as f:
        assert "traceEvents" in json.load(f)
    assert cap.capture(0.05)[0] == 200               # free again
    _wait_idle(cap)


@pytest.mark.parametrize("seconds,code", [("x", 400), ("0", 400),
                                          ("-1", 400), (None, 400)])
def test_profile_capture_bad_seconds(tmp_path, seconds, code):
    assert tprof.ProfileCapture(str(tmp_path)).capture(seconds)[0] == code


def test_profile_capture_refuses_without_dir_or_under_another_session(
        tmp_path):
    assert tprof.ProfileCapture(None).capture(1)[0] == 503
    cap = tprof.ProfileCapture(str(tmp_path))
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function("outer_session_op"):
            code, body = cap.capture(0.1)
            torch.ones(8).sum()
    assert code == 503 and "another torch.profiler" in body["error"]
    assert not cap.active and os.listdir(tmp_path) == []
    # the outer session is whole
    assert "outer_session_op" in {e.key for e in prof.key_averages()}

"""The port's disaggregated prefill/decode tiers against the reference's,
on the CPU.

`deeplearning4j_tpu_torch.serving.disagg.TieredRouter` and the
reference's run the same scenario on the same weights (a JAX tree,
converted), float32, ``pipeline=False``, driven tick by tick with their
own injected clocks advanced by the same step and their own
`FleetFaultInjector`s of the same schedule (tests/torch_fleet_helpers.py).
The port's record (per request: status, error, shed reasons, router
trace kinds, tokens; the router's stats with the handoffs by outcome;
the injector's counts; the autoscale trajectory) must equal the
reference's, and the port is also held to the reference test's contract
(tests/test_serving_disagg.py): the two-hop result token-exact against
one paged port engine, zero lost under a decode-tier kill, a prefill-tier
kill, a failed export (``handoff_fail_at``) and a corrupted kvwire frame
(``corrupt_frame_at``, refused by the frame's real CRC check).

Arms: float and int8 KV (greedy) and float sampled; a prefix hit on the
prefill tier; a chunked prefill tier; the faults; autoscale up, down and
revive; scale-to-zero of the prefill tier with its cold start; the tier
table in `debugz`; tier-config validation; `Autoscaler`'s decisions on
one observation sequence; the metric families (handoff, tier, autoscale,
kvwire) against the reference's and the naming lint. A tiered MoE
handoff is held to one paged port MoE engine at a capacity that never
binds (the reference's paged MoE programs do not trace on jax 0.9 with
shard_map's replication check on; ROADMAP queue C).
"""
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401

from deeplearning4j_tpu.observability import export as jex  # noqa: E402
from deeplearning4j_tpu.parallel.mesh import MeshSpec, make_mesh  # noqa

from deeplearning4j_tpu_torch.models import transformer as ttf  # noqa
from deeplearning4j_tpu_torch.observability import (  # noqa: E402
    json_snapshot, prometheus_text)
from deeplearning4j_tpu_torch.serving import disagg as tdisagg  # noqa
from deeplearning4j_tpu_torch.serving import engine as teng  # noqa: E402
from torch_fleet_helpers import (FIELDS, drive, idle,  # noqa: E402
                                 prompt, record, single)
from torch_fleet_helpers import impls as make_impls  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke  # noqa: E402


@pytest.fixture(scope="module")
def impls():
    return make_impls(FIELDS, make_mesh(MeshSpec(data=1, model=1)))


def _run(imp, *, prompts, max_new=12, serial=False, ec=None, pc=None,
         dc=None, **kw):
    ec = imp.ec(paged=True, **(ec or {}))
    r = imp.tiered(pc=imp.ec(paged=True, **pc) if pc else ec,
                   dc=imp.ec(paged=True, **dc) if dc else ec, **kw)
    inj = r._injector
    try:
        hs = []
        for p in prompts:
            hs.append(r.submit(p, max_new_tokens=max_new))
            if serial:                # the second sees the cache
                drive(r)
        drive(r)
        r._test_handles = hs
        rec = record(r, hs, inj)
        rec["handoff_events"] = [
            [(e.data["outcome"], e.data["tokens"]) for e in h.trace.events
             if e.kind == "handoff"] for h in hs]
        rec["kvwire_events"] = [
            [(e.data.get("direction"), e.data.get("outcome"))
             for e in h.trace.events if e.kind == "kvwire"] for h in hs]
        return rec, r
    finally:
        r.close()


FIVE = [prompt(6 + i, i) for i in range(5)]
SCENARIOS = {
    "float_greedy": dict(prompts=FIVE),
    "int8_greedy": dict(prompts=FIVE, ec=dict(kv_quantize="int8")),
    "float_sampled": dict(prompts=FIVE, ec=dict(temperature=0.8)),
    "prefix_hit": dict(prompts=[prompt(32, 3), prompt(32, 3)],
                       serial=True),
    "chunked_prefill": dict(prompts=[prompt(20, i) for i in range(3)],
                            pc=dict(prefill_chunk=8)),
    "kill_decode": dict(prompts=[prompt(8, i) for i in range(5)],
                        decode=2, inj=dict(kill_at={6: 1})),
    "kill_prefill": dict(prompts=[prompt(8, i) for i in range(4)],
                         inj=dict(kill_at={1: 0})),
    "export_fails": dict(prompts=[prompt(8, i) for i in range(3)],
                         inj=dict(handoff_fail_at=[0])),
    "corrupt_frame": dict(prompts=[prompt(8, i) for i in range(3)],
                          inj=dict(corrupt_frame_at=[1])),
    "all_faults": dict(prompts=[prompt(8 + i % 3, i) for i in range(6)],
                       decode=2, inj=dict(kill_at={7: 2},
                                          handoff_fail_at=[1],
                                          corrupt_frame_at=[3])),
}


@pytest.mark.parametrize("arm", list(SCENARIOS))
def test_tiered_router_matches_reference(impls, arm):
    spec = SCENARIOS[arm]
    want, _ = _run(impls["jax"], **spec)
    got, r = _run(impls["port"], **spec)
    if arm == "float_sampled":
        # the port's sampler draws from torch's generator, not JAX's:
        # sampled tokens are held to the port's own single engine below
        for rec in (got, want):
            rec["requests"] = [dict(q, tokens=len(q["tokens"]))
                               for q in rec["requests"]]
    assert got == want
    # the reference test's contract, on the port
    port = impls["port"]
    sec = dict(spec.get("ec") or {}, **(spec.get("pc") or {}))
    oracle = single(port, spec["prompts"],
                    ec=port.ec(paged=True, **sec))
    for h, p, w in zip(r._test_handles, spec["prompts"], oracle):
        assert h.status == "completed"
        np.testing.assert_array_equal(h.result(0), w)
    st = got["stats"]
    n = len(spec["prompts"])
    assert st["completed"] == n and st["shed_outage"] == 0
    if arm in ("float_greedy", "int8_greedy", "float_sampled",
               "prefix_hit", "chunked_prefill"):
        assert st["handoffs_ok"] == n and st["handoffs_failed"] == 0
        assert all(ev == [("ok", ev[0][1])] and ev[0][1] >= 6
                   for ev in got["handoff_events"])
    if arm == "kill_decode":
        assert st["failovers"] >= 1 and st["handoffs_ok"] > n
    if arm == "kill_prefill":
        assert st["restarts"] >= 1
    if arm == "export_fails":
        assert (st["handoffs_failed"], st["handoffs_ok"]) == (1, 2)
    if arm == "corrupt_frame":
        assert (st["handoffs_failed"], st["handoffs_ok"]) == (1, 2)
        assert [("export", "crc")] in got["kvwire_events"]
    if arm == "all_faults":
        assert st["handoffs_failed"] == 2 and st["failovers"] >= 1


def test_prefill_tier_prefix_hit_and_released_holds(impls):
    """The second of two equal prompts hits the prefill replica's radix
    cache, and no held slot outlives its handoff (a failed export's hold
    is released too)."""
    imp = impls["port"]
    r = imp.tiered(inj=dict(handoff_fail_at=[0]))
    try:
        for p in (prompt(32, 3), prompt(32, 3)):
            h = r.submit(p, max_new_tokens=12)
            drive(r)
            assert h.status == "completed"
        pre = r._ctls[0].replica.engine
        assert int(pre._m_prefix_hits.value) >= 1
        assert pre.drained()
        assert all(s is None for s in pre._slots)
    finally:
        r.close()


def _autoscale_cycle(imp):
    ec = imp.ec(paged=True, max_new_tokens=16)
    r = imp.tiered(pc=ec, dc=ec, decode_autoscale=imp.disagg.AutoscalePolicy(
        min_replicas=1, max_replicas=3, window=2, cooldown_s=0.1))
    try:
        hs = [r.submit(prompt(8, i), max_new_tokens=16) for i in range(8)]
        drive(r)
        idle(r, 60)
        active = len(r._active_ctls("decode"))
        stopped = [c.id for c in r._ctls if c.state() == "stopped"]
        hs2 = [r.submit(prompt(8, i + 20), max_new_tokens=16)
               for i in range(8)]
        drive(r)
        log = [{k: v for k, v in e.items() if k != "cold_start_s"}
               for e in r.autoscale_log]
        return dict(record(r, hs + hs2), log=log, active=active,
                    stopped=stopped,
                    ups=r._m_autoscale.labels("decode", "up").value)
    finally:
        r.close()


def _scale_to_zero(imp):
    r = imp.tiered(prefill_autoscale=imp.disagg.AutoscalePolicy(
        min_replicas=0, max_replicas=1, window=2, cooldown_s=0.1))
    try:
        h0 = r.submit(prompt(8, 1), max_new_tokens=12)
        drive(r)
        idle(r, 40)
        zero = [c.state() for c in r._tier_ctls("prefill")]
        h = r.submit(prompt(8, 7), max_new_tokens=12)
        drive(r)
        log = [{k: v for k, v in e.items() if k != "cold_start_s"}
               for e in r.autoscale_log]
        cold = [e.get("cold_start_s") for e in r.autoscale_log
                if e["tier"] == "prefill" and e["direction"] == "up"]
        return dict(record(r, [h0, h]), log=log, zero=zero,
                    cold=len(cold))
    finally:
        r.close()


@pytest.mark.parametrize("scenario", [_autoscale_cycle, _scale_to_zero],
                         ids=["up_down_revive", "scale_to_zero"])
def test_autoscale_matches_reference(impls, scenario):
    want = scenario(impls["jax"])
    got = scenario(impls["port"])
    assert got == want
    assert all(q["status"] == "completed" for q in got["requests"])
    assert got["stats"]["shed_outage"] == 0
    dirs = [(e["tier"], e["direction"]) for e in got["log"]]
    if scenario is _autoscale_cycle:
        assert ("decode", "up") in dirs and ("decode", "down") in dirs
        assert got["active"] == 1 and got["stopped"] and got["ups"] >= 2
    else:
        assert got["zero"] == ["stopped"]
        assert ("prefill", "up") in dirs and got["cold"] >= 1
        port = impls["port"]
        want_tokens = single(port, [prompt(8, 7)], ec=port.ec(paged=True))
        np.testing.assert_array_equal(
            np.concatenate([prompt(8, 7),
                            np.asarray(got["requests"][1]["tokens"],
                                       np.int32)]), want_tokens[0])


def test_autoscaler_decisions_match_reference(impls):
    """The pure decision core on one observation sequence: window,
    cooldown, bounds, the scale-to-zero idle gate, the cold-start
    force-up, budget utilization and the span-latency signal."""
    seq = [(0.0, 1, 0.9, None, 2, 2), (0.1, 1, 0.9, None, 2, 2),
           (0.2, 2, 0.9, None, 2, 2), (0.3, 2, 0.9, None, 2, 2),
           (1.2, 2, 0.9, None, 2, 2), (3.0, 3, 1.0, None, 5, 5),
           (4.0, 2, 0.0, None, 0, 0), (4.1, 2, 0.0, None, 0, 0),
           (5.5, 1, 0.0, None, 0, 3), (5.6, 1, 0.0, None, 0, 0),
           (5.7, 1, 0.0, None, 0, 0), (9.0, 0, 0.0, None, 1, 0),
           (12.0, 1, 0.1, 0.99, 1, 1), (12.1, 1, 0.1, 0.99, 1, 1),
           (14.0, 1, 0.1, None, 1, 1, 900.0),
           (14.1, 1, 0.1, None, 1, 1, 900.0)]
    out = {}
    for name, imp in impls.items():
        d = imp.disagg
        a = d.Autoscaler(d.AutoscalePolicy(
            min_replicas=0, max_replicas=3, window=2, cooldown_s=1.0,
            scale_up_occupancy=0.8, scale_down_occupancy=0.2,
            scale_up_span_p99_ms=500.0))
        out[name] = [a.observe(*o[:6], span_p99_ms=(o[6] if len(o) > 6
                                                    else None))
                     for o in seq]
        with pytest.raises(ValueError, match="min_replicas"):
            d.AutoscalePolicy(min_replicas=3, max_replicas=1)
    assert out["port"] == out["jax"]
    assert out["port"][:2] == [0, 1] and 1 in out["port"][-2:]
    assert -1 in out["port"]


def test_tier_table_and_validation(impls):
    """debugz's per-tier table and the probe piggyback, health's tiers,
    and the tier-config parity guard, on both sides."""
    tables = {}
    for name, imp in impls.items():
        r = imp.tiered(pc=imp.ec(paged=True, prefill_chunk=8))
        try:
            hs = [r.submit(prompt(8, i), max_new_tokens=12)
                  for i in range(3)]
            drive(r)
            assert all(h.done() for h in hs)
            d = r.debugz()
            tiers = {row["tier"]: {k: row[k] for k in (
                "replicas", "states", "in_flight")}
                for row in d["tiers"]}
            rows = {row["replica"]: (row["tier"], row["kind"],
                                     row["handoff_mode"],
                                     row["budget_utilization"] is not None)
                    for row in d["replicas"]}
            tables[name] = dict(tiers=tiers, rows=rows,
                                handoffs={k: d["handoffs"][k] for k in (
                                    "ok", "fallback", "failed", "tokens",
                                    "bytes")},
                                last=d["handoffs"]["last"]["outcome"],
                                health=r.health()["tiers"])
        finally:
            r.close()
        with pytest.raises(ValueError, match="temperature"):
            imp.disagg.TieredRouter(
                prefill_engine_config=imp.ec(paged=True, temperature=0.5),
                decode_engine_config=imp.ec(paged=True), **imp.build)
    assert tables["port"] == tables["jax"]
    assert tables["port"]["handoffs"]["ok"] == 3
    assert tables["port"]["rows"][0] == ("prefill", "inprocess", "wire",
                                        True)


def _families(snap):
    return {name: (fam["kind"], sorted({k for s in fam["samples"]
                                        for k in s["labels"]}))
            for name, fam in snap.items()}


def test_tiered_metric_families_match_reference(impls):
    """After handoffs, a failed export, a corrupted frame and an
    autoscale, the tiered router's families equal the reference's
    (names, kinds, label names), the counters agree, and the exposition
    passes the lint."""
    snaps, texts = {}, {}
    for name, imp in impls.items():
        ec = imp.ec(paged=True)
        r = imp.tiered(pc=ec, dc=ec, inj=dict(handoff_fail_at=[0],
                                              corrupt_frame_at=[2]),
                       decode_autoscale=imp.disagg.AutoscalePolicy(
                           min_replicas=1, max_replicas=2, window=2,
                           cooldown_s=0.1))
        try:
            for i in range(5):
                r.submit(prompt(8, i), max_new_tokens=12)
            drive(r)
            idle(r, 30)
            m = jex if name == "jax" else None
            snaps[name] = (m.json_snapshot(r.registry) if m
                           else json_snapshot(r.registry))
            texts[name] = (m.prometheus_text(r.registry) if m
                           else prometheus_text(r.registry))
        finally:
            r.close()
    assert _families(snaps["port"]) == _families(snaps["jax"])
    fams = _families(snaps["port"])
    assert fams["serving_kvwire_frames"][1] == ["direction", "outcome"]
    assert fams["serving_handoff_transfers"][1] == ["outcome"]
    for name in ("serving_handoff_transfers", "serving_handoff_tokens",
                 "serving_handoff_bytes", "serving_kvwire_frames",
                 "serving_autoscale_events", "serving_fleet_dispatches"):
        assert snaps["port"][name]["samples"] == \
            snaps["jax"][name]["samples"], name
    assert chip_smoke.lint_exposition(texts["port"]) == []


def test_tiered_moe_handoff_token_exact():
    """MoE engines hand off too: a tiered fleet of 4-expert engines at a
    capacity that never binds equals one paged port MoE engine."""
    cfg = ttf.TransformerConfig(**dict(FIELDS, n_experts=4,
                                       capacity_factor=8.0))
    params = ttf.init_params(cfg, 0, device="cpu")
    ec = teng.EngineConfig(decode_chunk=2, max_new_tokens=10,
                           backoff_base_s=0.0, max_batch_size=2,
                           paged=True, page_size=4)
    prompts = [prompt(6 + 3 * i, i) for i in range(4)]
    want = []
    for p in prompts:
        eng = teng.InferenceEngine(cfg, params, ec, device="cpu")
        h = eng.submit(p, max_new_tokens=10)
        eng.run_pending()
        want.append(h.result(0))
    r = tdisagg.TieredRouter(cfg=cfg, params=params, device="cpu",
                             prefill_replicas=1, decode_replicas=2,
                             prefill_engine_config=ec,
                             decode_engine_config=ec)
    try:
        hs = [r.submit(p, max_new_tokens=10) for p in prompts]
        r.run_pending()
        for h, w in zip(hs, want):
            np.testing.assert_array_equal(h.result(0), w)
        assert r.stats["handoffs_ok"] == len(prompts)
    finally:
        r.close()


def test_tiered_router_needs_a_device():
    """Without ``device=`` the tiers run on the card; with no card the
    constructor raises instead of dropping to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = ttf.TransformerConfig(**FIELDS)
    params = ttf.init_params(cfg, 0, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdisagg.TieredRouter(cfg=cfg, params=params)

"""The engine side of KV handoff in the port, on the CPU (reference
serving/engine.py :368, :1992-2096, :3541-3911; tests/test_serving_kvwire
and the disaggregation suite hold JAX's side).

- Between two port engines, hold -> export -> kvwire frame -> adopt
  continues token-exact against one engine of the adopter's kind with
  the same slot count: contiguous -> paged, paged -> paged, int8 ->
  int8, and a pipelined exporter whose pending tick the export flushes
  (``serving_pipeline_flush_seconds{reason="export_slot_kv"}``);
  ``serving_kv_adoptions{outcome="ok"}`` counts every adoption and the
  page audit returns to its start.
- Across frameworks through kvwire frames: JAX's export adopted by the
  port and the port's adopted by JAX, greedy float32, on float and int8
  pools, token-exact against each adopter's own uninterrupted run (the
  JAX engine's and the port's agree too).
- A misaligned handoff and an injected adoption fault
  (`ServingFaultInjector(adopt_fail_requests=...)`, whose `check_adopt`
  the engine now calls) shed typed ``handoff`` with every claimed page
  released; a pool too short for an adoption blocks it at the queue head
  until pages free, then seats it.
- Prefix-cache chains: `export_cached_chain` -> `seed_cached_chain` makes
  the peer's next admission a prefix hit, token-exact; a chain of
  another ``weights_step`` is refused.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402

from deeplearning4j_tpu.models import transformer as jtf  # noqa: E402
from deeplearning4j_tpu.parallel.mesh import MeshSpec, make_mesh  # noqa
from deeplearning4j_tpu.serving import engine as jeng  # noqa: E402
from deeplearning4j_tpu.serving import kvwire as jwire  # noqa: E402

from deeplearning4j_tpu_torch.models import transformer as ttf  # noqa
from deeplearning4j_tpu_torch.models.convert import \
    params_from_numpy  # noqa: E402
from deeplearning4j_tpu_torch.parallel.failure import \
    ServingFaultInjector  # noqa: E402
from deeplearning4j_tpu_torch.serving import engine as teng  # noqa: E402
from deeplearning4j_tpu_torch.serving import kvwire  # noqa: E402
from deeplearning4j_tpu_torch.serving.paging import \
    chain_hashes  # noqa: E402

# max_len 80: JAX's program caches are process-wide, and
# tests/test_profiling.py leaves AOT-loaded executables of its 64-position
# config in them for any later file on its worker
FIELDS = dict(vocab_size=32, d_model=32, n_heads=4, n_layers=2, max_len=80)
TCFG = ttf.TransformerConfig(**FIELDS)
PAGED = dict(paged=True, page_size=4)
HEAD, TAIL = 3, 9            # tokens decoded before and after the handoff


def _prompts():
    rng = np.random.default_rng(3)
    return [rng.integers(0, 32, size=n).astype(np.int32)
            for n in (9, 5, 13, 7)]


PROMPTS = _prompts()


@pytest.fixture(scope="module")
def weights():
    """JAX's weights and the same tree in the port."""
    jcfg = jtf.TransformerConfig(**FIELDS)
    jp = jtf.init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, jp, params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jp), device="cpu")


def _ec(**kw):
    base = dict(decode_chunk=2, max_new_tokens=HEAD + TAIL, num_slots=4,
                pipeline=False)
    base.update(kw)
    return base


def _port(tp, **kw):
    return teng.InferenceEngine(TCFG, tp, teng.EngineConfig(**_ec(**kw)),
                                device="cpu")


def _served(eng, prompts=PROMPTS, n=HEAD + TAIL, **submit):
    hs = [eng.submit(p, max_new_tokens=n, **submit) for p in prompts]
    eng.run_pending()
    return hs


def _adoptions(eng, outcome="ok"):
    m = eng._m_adoptions
    if m is None or not hasattr(m, "labels"):
        m = eng.registry.get("serving_kv_adoptions")
    return int(m.labels(outcome).value)


def _adopt_all(adopter, held, frames, decode):
    hs = [adopter.submit(h.result(), max_new_tokens=TAIL,
                         kv=decode(f)) for h, f in zip(held, frames)]
    adopter.run_pending()
    return hs


@pytest.mark.parametrize("exp,adp", [
    ({}, PAGED), (PAGED, PAGED),
    (dict(PAGED, kv_quantize="int8"), dict(PAGED, kv_quantize="int8")),
    (dict(PAGED, pipeline=True), PAGED)],
    ids=["contiguous-paged", "paged-paged", "int8-int8", "pipelined"])
def test_port_handoff_continues_token_exact(weights, exp, adp):
    _, _, tp = weights
    want = [h.result() for h in _served(_port(tp, **adp))]
    ex = _port(tp, **exp)
    held = [ex.submit(p, max_new_tokens=HEAD, hold_kv=True)
            for p in PROMPTS]
    if exp.get("pipeline"):
        # stop with the last tokens dispatched and their tick pending:
        # the export must commit it first
        while not all(h.generated.shape[0] + h._pending_n >= HEAD
                      for h in held):
            ex.tick()
        assert ex._pending and not all(h.done() for h in held)
    else:
        ex.run_pending()
    start = ex.counts["pages_used"] if ex._paged else None
    assert all(ex.committed_kv_pages(h) > 0 for h in held) == ex._paged
    frames = [kvwire.encode_handoff(ex.export_slot_kv(h)) for h in held]
    assert all(h.done() for h in held)
    assert all(r is None for r in ex._slots)
    if ex._paged:
        # the released slots' pages went back; the cache keeps its own
        assert ex.counts["pages_used"] == ex.prefix_cache_pages < start
    if exp.get("pipeline"):
        assert ex._last_flush["reason"] == "export_slot_kv"
        flush = ex.registry.get("serving_pipeline_flush_seconds")
        assert flush.labels("export_slot_kv").snapshot()[2] == 1
    ad = _port(tp, **adp)
    got = _adopt_all(ad, held, frames, kvwire.decode_handoff)
    assert [h.result().tolist() for h in got] == \
        [w.tolist() for w in want]
    assert _adoptions(ad) == len(PROMPTS)
    assert ad.counts["prefill_calls"] == 0
    assert ad.counts["pages_used"] == ad.prefix_cache_pages
    assert all(e.kind != "prefill_done" for h in got
               for e in h.trace.events)


@pytest.mark.parametrize("mode", [None, "int8"], ids=["f32", "int8"])
def test_cross_framework_handoff_token_exact(weights, mode):
    jcfg, jp, tp = weights
    kw = dict(PAGED, kv_quantize=mode)
    mesh = make_mesh(MeshSpec(data=1, model=1))
    je = jeng.InferenceEngine(jcfg, mesh, jp, jeng.EngineConfig(**_ec(**kw)))
    jwant = [h.result() for h in _served(je)]
    twant = [h.result() for h in _served(_port(tp, **kw))]
    assert [a.tolist() for a in jwant] == [b.tolist() for b in twant]
    # JAX exports, the port adopts
    jheld = _served(je, n=HEAD, hold_kv=True)
    jframes = [jwire.encode_handoff(je.export_slot_kv(h)) for h in jheld]
    ad = _port(tp, **kw)
    got = _adopt_all(ad, jheld, jframes, kvwire.decode_handoff)
    assert [h.result().tolist() for h in got] == \
        [w.tolist() for w in twant]
    assert _adoptions(ad) == len(PROMPTS)
    # the port exports, JAX adopts
    ex = _port(tp, **kw)
    theld = _served(ex, n=HEAD, hold_kv=True)
    tframes = [kvwire.encode_handoff(ex.export_slot_kv(h)) for h in theld]
    # the same rows went on the wire from either exporter: float32 rows
    # to the two frameworks' rounding, the int8 ones, dequantized, to two
    # steps of their row's grid
    for a, b in zip(tframes, jframes):
        ka, kb = kvwire.decode_handoff(a), kvwire.decode_handoff(b)
        assert (ka.pos, ka.tok) == (kb.pos, kb.tok)
        for x, y, sx, sy in ((ka.k, kb.k, ka.k_scale, kb.k_scale),
                             (ka.v, kb.v, ka.v_scale, kb.v_scale)):
            if mode is None:
                assert (x - y).abs().max() <= 1e-5
            else:
                step = torch.maximum(sx, sy)
                assert ((x.float() * sx - y.float() * sy).abs()
                        <= 2 * step + 1e-7).all()
    jgot = _adopt_all(je, theld, tframes, jwire.decode_handoff)
    assert [h.result().tolist() for h in jgot] == \
        [w.tolist() for w in jwant]
    assert int(je._m_adoptions.labels("ok").value) == len(PROMPTS)


def test_misaligned_and_faulted_adoptions_shed_handoff(weights):
    _, _, tp = weights
    ex = _port(tp, **PAGED)
    held = _served(ex, n=HEAD, hold_kv=True)
    kvs = [ex.export_slot_kv(h) for h in held]
    inj = ServingFaultInjector(adopt_fail_requests=[2])
    ad = teng.InferenceEngine(TCFG, tp, teng.EngineConfig(**_ec(**PAGED)),
                              device="cpu", fault_injector=inj)
    ad._ensure_state()
    start = ad.counts["pages_used"]
    bad = ad.submit(held[0].result()[:-1], max_new_tokens=TAIL,
                    kv=kvs[0])                      # one token short
    faulted = ad.submit(held[1].result(), max_new_tokens=TAIL, kv=kvs[1])
    wrong_tok = ad.submit(held[2].result(), max_new_tokens=TAIL,
                          kv=dataclasses.replace(kvs[2], tok=kvs[2].tok
                                                 ^ 1))
    good = ad.submit(held[3].result(), max_new_tokens=TAIL, kv=kvs[3])
    ad.run_pending()
    for h in (bad, faulted, wrong_tok):
        assert h.status == teng.RequestStatus.SHED
        assert isinstance(h.error, teng.HandoffError)
        assert h.trace.events[-1].kind == "shed"
        assert h.trace.events[-1].data["reason"] == "handoff"
    assert "injected" in str(faulted.error)
    assert inj.adoptions_failed == 1
    assert good.status == teng.RequestStatus.COMPLETED
    assert int(ad._m_shed.labels("handoff").value) == 3
    assert (_adoptions(ad, "shed"), _adoptions(ad)) == (3, 1)
    assert ad.counts["pages_used"] - ad.prefix_cache_pages == start


def test_short_pool_blocks_adoption_until_pages_free(weights):
    _, _, tp = weights
    want = [h.result() for h in _served(_port(tp, **PAGED))[:2]]
    ex = _port(tp, **PAGED)
    held = _served(ex, PROMPTS[:2], n=HEAD, hold_kv=True)
    kvs = [ex.export_slot_kv(h) for h in held]
    # 9 + 12 tokens need 6 pages of 4: 8 usable pages seat one at a time
    ad = _port(tp, **dict(PAGED, kv_pages=9, prefix_cache=False))
    hs = [ad.submit(h.result(), max_new_tokens=TAIL, kv=kv)
          for h, kv in zip(held, kvs)]
    ad.tick()
    assert hs[0].status == "running" and ad._queue[0] is hs[1]
    assert _adoptions(ad, "blocked") >= 1
    ad.run_pending()
    assert [h.result().tolist() for h in hs] == [w.tolist() for w in want]
    assert _adoptions(ad) == 2 and ad.counts["pages_used"] == 0


def test_cached_chain_migrates_and_other_weights_refused(weights):
    _, _, tp = weights
    prompt = PROMPTS[2]                       # 13 tokens: 3 full pages
    src = _port(tp, **PAGED)
    want = _served(src, [prompt])[0].result()
    h = chain_hashes(prompt, 4)[-1]
    assert src.set_advertised_chains([h]) == 1
    kv = src.export_cached_chain(h)
    assert (kv.source, kv.pos, kv.tokens.tolist()) == \
        ("cache", 12, prompt[:12].tolist())
    assert src.export_cached_chain(12345) is None
    kv = kvwire.decode_handoff(kvwire.encode_handoff(kv))
    dst = _port(tp, **PAGED)
    assert not dst.seed_cached_chain(dataclasses.replace(kv,
                                                         weights_step=7))
    assert _adoptions(dst, "seed_failed") == 1
    assert dst.seed_cached_chain(kv)
    assert dst.prefix_cache_pages == 3 and _adoptions(dst, "seeded") == 1
    got = _served(dst, [prompt])[0].result()
    assert got.tolist() == want.tolist()
    assert dst.counts["prefix_hits"] == 1
    assert dst.counts["prefix_shared_tokens"] == 12
    # a cache-source handoff at submit seeds, then admits as a hit
    dst2 = _port(tp, **PAGED)
    got2 = dst2.submit(prompt, kv=kv)
    dst2.run_pending()
    assert got2.result().tolist() == want.tolist()
    assert dst2.counts["prefix_hits"] == 1


def test_export_errors_and_unadoptable_targets(weights):
    _, _, tp = weights
    eng = _port(tp, **dict(PAGED, prefill_chunk=4))
    h = eng.submit(PROMPTS[2], hold_kv=True)
    eng.tick()                               # mid-prefill (chunks of 4)
    with pytest.raises(teng.HandoffError, match="mid-prefill"):
        eng.export_slot_kv(h, release=False)
    eng.run_pending()
    assert eng.committed_kv_pages(h) > 0
    kv = eng.export_slot_kv(h)
    with pytest.raises(teng.HandoffError, match="not resident"):
        eng.export_slot_kv(h)
    assert not eng.release_held(h)
    # a contiguous engine (or another KV mode) cannot adopt: it prefills,
    # with the tokens of a plain run
    for kw in ({}, dict(PAGED, kv_quantize="int8")):
        target = _port(tp, **kw)
        r = target.submit(h.result(), max_new_tokens=3, kv=kv)
        assert r._kv is None
        target.run_pending()
        ref = _served(_port(tp, **kw), [h.result()], n=3)[0]
        assert r.result().tolist() == ref.result().tolist()
        assert target.counts["prefill_calls"] == 1

"""Port parity: checkpoints and hot weight reload against JAX's.

`util.checkpointing.CheckpointManager` writes and reads the npz layout of
JAX's manager with ``use_orbax=False``: a tree saved by either side is
restored by the other with equal arrays (bfloat16 bits intact), the
manifests equal; verification, the newest-verified fallback past a
corrupt or torn step, retention, metadata, the orphan sweep and the
refusal of an orbax directory run on the port alone.

`InferenceEngine.reload_weights` is held to JAX's engine (float32, one
converted `init_params` tree, the synchronous loop) on JAX's reload
contracts: the swap and the swap back, the fallback past a corrupt or
torn step, an empty directory raising, in-flight requests evicted with
their committed tokens, a paged engine's prefix cache flushed with no
page leaked, the spec engine's drafter rebuilt (spec equal to plain
after it), an int8 engine quantizing the float checkpoint again (equal
to an int8 engine built from that tree), and a pipelined tick in flight
discarded (token-exact against an uninterrupted run), with batch mode
reloading between batches.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from deeplearning4j_tpu.models import transformer as jtf  # noqa: E402
from deeplearning4j_tpu.parallel.mesh import MeshSpec, make_mesh  # noqa
from deeplearning4j_tpu.serving import engine as jeng  # noqa: E402
from deeplearning4j_tpu.util import checkpointing as jck  # noqa: E402

from deeplearning4j_tpu_torch.models import transformer as ttf  # noqa
from deeplearning4j_tpu_torch.models.convert import \
    params_from_numpy  # noqa: E402
from deeplearning4j_tpu_torch.observability import (  # noqa: E402
    MetricsRegistry, json_snapshot)
from deeplearning4j_tpu_torch.parallel import failure as tfail  # noqa
from deeplearning4j_tpu_torch.serving import engine as teng  # noqa: E402
from deeplearning4j_tpu_torch.util import checkpointing as tck  # noqa

# max_len 80: JAX's program caches are process-wide, and an AOT-loaded
# executable another test file leaves for the 64-position config of its
# own tests cannot serve this file's engines
FIELDS = dict(vocab_size=32, d_model=32, n_heads=4, n_layers=2, max_len=80)
JCFG = jtf.TransformerConfig(**FIELDS)
TCFG = ttf.TransformerConfig(**FIELDS)
SIDES = {"jax": jeng, "port": teng}


@pytest.fixture(autouse=True)
def _reference_paths(monkeypatch):
    monkeypatch.delenv("DL4JTPU_FLASH", raising=False)


@pytest.fixture(scope="module")
def mesh1():
    return make_mesh(MeshSpec(data=1, model=1))


@pytest.fixture(scope="module")
def jparams():
    return jtf.init_params(JCFG, jax.random.PRNGKey(0))


def _port_tree(jtree):
    return params_from_numpy(jax.tree_util.tree_map(np.asarray, jtree),
                             device="cpu")


@pytest.fixture(scope="module")
def tparams(jparams):
    return _port_tree(jparams)


def _prompt(t0=8, seed=0):
    return (np.arange(t0, dtype=np.int32) * (seed + 3)) % 32


def _config(**kw):
    base = dict(decode_chunk=2, max_new_tokens=8, backoff_base_s=0.0,
                max_batch_size=2, pipeline=False)
    base.update(kw)
    return base


@pytest.fixture
def make(mesh1, jparams, tparams):
    """make(side, params=None, **config) -> one side's engine (params: a
    JAX tree, converted for the port)."""
    def build(side, params=None, **kw):
        mod = SIDES[side]
        cfg = mod.EngineConfig(**_config(**kw))
        jp = jparams if params is None else params
        if side == "jax":
            return mod.InferenceEngine(JCFG, mesh1, jp, cfg)
        tp = tparams if params is None else _port_tree(jp)
        return mod.InferenceEngine(TCFG, tp, cfg, device="cpu")
    return build


@pytest.fixture
def ckpts(tmp_path, jparams):
    """{side: manager} each holding step 1 = params and step 2 = the
    zeroed tree, written by that side's own manager."""
    zeroed = jax.tree_util.tree_map(lambda a: a * 0, jparams)
    j = jck.CheckpointManager(str(tmp_path / "jax"), use_orbax=False)
    j.save_tree(jparams, 1)
    j.save_tree(zeroed, 2)
    t = tck.CheckpointManager(tmp_path / "port", registry=MetricsRegistry())
    t.save_tree(_port_tree(jparams), 1)
    t.save_tree(_port_tree(zeroed), 2)
    return {"jax": j, "port": t}


def _serve(eng, prompts, **kw):
    hs = [eng.submit(p, **kw) for p in prompts]
    eng.run_pending()
    return hs


def _gen(hs):
    return [h.result(0).tolist() for h in hs]


# ---------------------------------------------------------------------------
# the checkpoint format
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_checkpoints_cross_read(tmp_path, jparams, dtype):
    """A tree JAX's manager wrote is restored by the port's, and the
    other way round: equal arrays, bfloat16 bits intact, the manifests
    and the dtype sidecar equal."""
    jt = jax.tree_util.tree_map(lambda a: a.astype(dtype), jparams)
    tt = params_from_numpy(
        jax.tree_util.tree_map(lambda a: np.asarray(a.astype(jnp.float32)),
                               jt), device="cpu",
        dtype=getattr(torch, dtype))
    jm = jck.CheckpointManager(str(tmp_path / "j"), use_orbax=False)
    jm.save_tree(jt, 3)
    tm = tck.CheckpointManager(tmp_path / "t", registry=MetricsRegistry())
    tm.save_tree(tt, 3, meta={"cursor": 5})

    got = tck.CheckpointManager(tmp_path / "j",
                                registry=MetricsRegistry()).restore_tree(tt)
    back = jck.CheckpointManager(str(tmp_path / "t"),
                                 use_orbax=False).restore_tree(jt)
    for name, leaf in tck.flatten_with_names(tt, "tree"):
        path = name.split("|")[1].split("/")
        g, b, want = got, back, jt
        for k in path:
            g, b, want = g[k], b[k], want[k]
        assert g.dtype == leaf.dtype
        bits = (lambda x: x.view(np.uint16)) if dtype == "bfloat16" \
            else (lambda x: x)
        np.testing.assert_array_equal(
            bits(g.view(torch.int16).numpy() if dtype == "bfloat16"
                 else g.numpy()), bits(np.asarray(want)))
        np.testing.assert_array_equal(bits(np.asarray(b)),
                                      bits(np.asarray(want)))
    mj = json.loads((tmp_path / "j/step_3/manifest.json").read_text())
    mt = json.loads((tmp_path / "t/step_3/manifest.json").read_text())
    assert mj == mt
    assert (tmp_path / "j/step_3/dtypes.json").read_text() == \
        (tmp_path / "t/step_3/dtypes.json").read_text()
    assert jck.CheckpointManager(str(tmp_path / "t"), use_orbax=False
                                 ).read_meta(3) == {"cursor": 5}


def test_manager_verify_fallback_retention_and_series(tmp_path, tparams):
    reg = MetricsRegistry()
    inj = tfail.FaultInjector(torn_write_at=[3], crash_write_at=[4])
    m = tck.CheckpointManager(tmp_path, max_to_keep=3, fault_injector=inj,
                              registry=reg)
    assert m.restore_tree(tparams) is None and m.latest_step() is None
    m.save_tree(tparams, 1)
    zero = {k: (v * 0 if not isinstance(v, dict)
                else {kk: vv * 0 for kk, vv in v.items()})
            for k, v in tparams.items()}
    m.save_tree(zero, 2)
    m.save_tree(tparams, 3)                   # torn after publication
    with pytest.raises(tfail.TrainingFailure):
        m.save_tree(tparams, 4)               # dies before the rename
    assert m.all_steps() == [1, 2, 3] and inj.writes_torn == 1
    assert m.verify_step(2) and not m.verify_step(3)
    tree, step = m.restore_tree(tparams, with_step=True)
    assert step == 2 and float(tree["Wout"].abs().sum()) == 0.0
    with pytest.raises(tck.CheckpointCorruptError):
        m.restore_tree(tparams, step=3)
    # a new manager sweeps the dead writer's staging directory
    assert (tmp_path / "step_4.tmp").exists()
    m2 = tck.CheckpointManager(tmp_path, max_to_keep=3, registry=reg)
    assert not (tmp_path / "step_4.tmp").exists()
    for s in (5, 6):
        m2.save_tree(tparams, s, meta={"s": s})
    assert m2.all_steps() == [3, 5, 6] and m2.read_meta(6) == {"s": 6}
    assert m2.read_meta(2) is None
    snap = json_snapshot(reg)
    saves = {s["labels"]["mode"]: s["value"]
             for s in snap["checkpoint_saves_total"]["samples"]}
    assert saves == {"sync": 5.0}
    assert snap["checkpoint_write_seconds"]["samples"][0]["count"] == 6
    assert snap["checkpoint_verify_failures_total"]["samples"][0]["value"] >= 2
    assert snap["checkpoint_async_pending"]["samples"][0]["value"] == 0
    # a tree of another shape is refused, not restored
    other = dict(tparams, Wout=torch.zeros(3, 3))
    with pytest.raises(tck.CheckpointCorruptError, match="structure"):
        m2.restore_tree(other, step=6)


def test_orbax_directory_refused(tmp_path):
    (tmp_path / "o" / "7" / "default").mkdir(parents=True)
    (tmp_path / "o" / "7" / "_CHECKPOINT_METADATA").write_text("{}")
    with pytest.raises(tck.CheckpointFormatError, match="orbax"):
        tck.CheckpointManager(tmp_path / "o", registry=MetricsRegistry())
    with pytest.raises(tck.CheckpointFormatError, match="npz"):
        tck.CheckpointManager(tmp_path / "n", use_orbax=True,
                              registry=MetricsRegistry())
    eng = teng.InferenceEngine(TCFG, ttf.init_params(TCFG, device="cpu"),
                               teng.EngineConfig(), device="cpu")
    with pytest.raises(tck.CheckpointFormatError):
        eng.reload_weights(str(tmp_path / "o"))


# ---------------------------------------------------------------------------
# hot reload against JAX's engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("writer", ["jax", "port"])
def test_reload_swaps_and_restores_like_jax(make, ckpts, writer):
    """New admissions use the new tree (zeroed weights change the
    output), the original tree restores it, and health / stats / the
    series report it, as on JAX's engine; the checkpoints either side
    wrote serve both."""
    out = {}
    for side in SIDES:
        eng = make(side)
        before = _serve(eng, [_prompt()])
        src = ckpts[writer].directory
        assert eng.reload_weights(str(src), step=2) == 2
        after = _serve(eng, [_prompt()])
        assert eng.health()["weights_step"] == 2
        assert eng.reload_weights(str(src), step=1) == 1
        again = _serve(eng, [_prompt()])
        out[side] = (eng, _gen(before), _gen(after), _gen(again))
    (je, *j), (te, *t) = out["jax"], out["port"]
    assert t == j
    assert t[0] == t[2] and t[0] != t[1]
    assert te.stats["reloads"] == je.stats["reloads"] == 2
    assert te.debugz()["weights_step"] == 1
    assert json_snapshot(te.registry)["serving_weight_reloads"][
        "samples"] == [{"labels": {}, "value": 2.0}]


def test_reload_falls_back_past_corrupt_and_torn(make, tmp_path, tparams):
    m = tck.CheckpointManager(tmp_path / "w", registry=MetricsRegistry())
    m.save_tree(tparams, 1)
    m.save_tree(tparams, 2)
    (m.directory / "step_2" / "arrays.npz").unlink()
    eng = make("port")
    before = _serve(eng, [_prompt()])
    assert eng.reload_weights(m) == 1
    assert _gen(_serve(eng, [_prompt()])) == _gen(before)
    inj = tfail.FaultInjector(torn_write_at=[7])
    m2 = tck.CheckpointManager(tmp_path / "w2", fault_injector=inj,
                               registry=MetricsRegistry())
    m2.save_tree({k: (v * 0 if not isinstance(v, dict) else
                      {kk: vv * 0 for kk, vv in v.items()})
                  for k, v in tparams.items()}, 7)
    with pytest.raises(RuntimeError, match="no readable checkpoint"):
        eng.reload_weights(m2)
    assert eng.health()["weights_step"] == 1
    assert _gen(_serve(eng, [_prompt()])) == _gen(before)
    with pytest.raises(FileNotFoundError):
        eng.reload_weights(str(tmp_path / "none"))


RELOAD_POOLS = {"contiguous": {}, "chunked": dict(prefill_chunk=4),
                "paged": dict(paged=True, page_size=4)}


@pytest.mark.parametrize("pool", sorted(RELOAD_POOLS))
@pytest.mark.parametrize("pipeline", [False, True], ids=["sync",
                                                         "pipelined"])
def test_reload_preempts_inflight_like_jax(make, ckpts, pipeline, pool):
    """Mid-stream: the in-flight request is evicted and requeued with its
    committed tokens (the stats and the ``preempted`` event as JAX's),
    re-prefills under the zeroed tree and completes; back on the old
    tree a fresh request reproduces the old run, on every pool."""
    out = {}
    for side in (("jax", "port") if not pipeline else ("port",)):
        eng = make(side, max_new_tokens=10, pipeline=pipeline,
                   **RELOAD_POOLS[pool])
        h = eng.submit(_prompt())
        for _ in range(4):
            eng.tick()
            committed = h.generated.copy()
            if committed.shape[0] > 0:
                break
        assert 0 < committed.shape[0] < 10
        assert eng.reload_weights(ckpts[side].directory, step=2) == 2
        assert eng.stats["preempted"] == 1
        assert h.status == "queued" and h._pending_n == 0
        eng.run_pending()
        assert h.status == "completed"
        np.testing.assert_array_equal(h.generated[:committed.shape[0]],
                                      committed)
        assert eng.reload_weights(ckpts[side].directory, step=1) == 1
        again = _serve(eng, [_prompt()])
        out[side] = (committed.tolist(), h.generated.tolist(),
                     _gen(again),
                     [e.data for e in h.trace.events
                      if e.kind == "preempted"])
    ref = make("port", max_new_tokens=10)
    hr = _serve(ref, [_prompt()])
    for side, (c, g, again, pre) in out.items():
        assert again == _gen(hr) and g != hr[0].generated.tolist()
        assert pre == [{"reason": "reload"}]
    if not pipeline:
        assert out["port"] == out["jax"]


def test_reload_with_pending_tick_discards_uncommitted(make, ckpts):
    """JAX's test_reload_mid_pipeline_discards_uncommitted contract held
    on the port itself: a reload to the same weights with a tick in
    flight requeues the request with its committed tokens only, the
    pending commit commits nothing into it, and the result equals an
    uninterrupted run."""
    ref = _gen(_serve(make("port", max_new_tokens=12), [_prompt(8, 2)]))
    eng = make("port", pipeline=True, max_new_tokens=12)
    h = eng.submit(_prompt(8, 2))
    eng.tick()
    eng.tick()
    assert len(eng._pending) == 1
    held = h.generated.copy()
    assert eng.reload_weights(ckpts["port"], step=1) == 1
    assert h.status == "queued" and h._pending_n == 0
    eng.tick()                      # commits the stale tick: nothing lands
    assert h.generated.shape[0] == held.shape[0]
    eng.run_pending()
    assert _gen([h]) == ref
    assert eng.stats["preempted"] == 1 and eng.drained()


def test_paged_reload_flushes_prefix_cache(make, ckpts, jparams):
    """JAX test_serving_paged.py :440 on the port: the in-flight request
    is preempted, the prefix cache is flushed and every page returns;
    later traffic hitting a re-populated prefix decodes under the new
    tree, equal to a contiguous engine built on it."""
    p = _prompt(26, 7)
    eng = make("port", paged=True, page_size=4, max_new_tokens=10)
    warm = _serve(eng, [p])
    h = eng.submit(p)
    for _ in range(4):
        eng.tick()
        committed = h.generated.copy()
        if committed.shape[0] > 0:
            break
    assert 0 < committed.shape[0] < 10
    assert eng.reload_weights(ckpts["port"], step=2) == 2
    assert h.status == "queued"
    assert eng.prefix_cache_pages == 0 and eng.counts["pages_used"] == 0
    eng.run_pending()
    np.testing.assert_array_equal(h.generated[:committed.shape[0]],
                                  committed)
    nxt = _serve(eng, [p])
    zeroed = jax.tree_util.tree_map(lambda a: a * 0, jparams)
    hz = _serve(make("port", params=zeroed, max_new_tokens=10), [p])
    jz = _serve(make("jax", params=zeroed, max_new_tokens=10), [p])
    assert _gen(nxt) == _gen(hz) == _gen(jz)
    assert warm[0].status == "completed"
    assert eng.counts["pages_used"] == eng.prefix_cache_pages


def test_spec_reload_rebuilds_drafter(make, tmp_path, jparams):
    """The drafter is derived again from the new tree: the spec engine's
    tokens after the reload equal a plain engine's on that tree, as
    JAX's do."""
    half = jax.tree_util.tree_map(lambda a: a * 0.5, jparams)
    m = tck.CheckpointManager(tmp_path, registry=MetricsRegistry())
    m.save_tree(_port_tree(jparams), 1)
    m.save_tree(_port_tree(half), 2)
    eng = make("port", spec_decode=True, spec_k=3, draft="int8",
               max_new_tokens=11)
    old = eng._draft_params
    assert eng.reload_weights(m, step=2) == 2
    assert eng._draft_params is not old
    got = _gen(_serve(eng, [_prompt()]))
    plain = _gen(_serve(make("port", params=half, max_new_tokens=11),
                        [_prompt()]))
    jplain = _gen(_serve(make("jax", params=half, max_new_tokens=11),
                         [_prompt()]))
    assert got == plain == jplain


def test_int8_reload_requantizes(make, tmp_path, jparams, tparams):
    """A quantized engine restores the float checkpoint against its float
    template and quantizes it again: equal to an int8 engine built from
    the same float tree, JAX's tokens too."""
    half = jax.tree_util.tree_map(lambda a: a * 0.5, jparams)
    m = tck.CheckpointManager(tmp_path, registry=MetricsRegistry())
    m.save_tree(_port_tree(half), 1)
    eng = make("port", quantize="int8", kv_quantize="int8")
    assert eng._float_template["Wout"].device.type == "meta"
    assert eng.reload_weights(m) == 1
    from deeplearning4j_tpu_torch.quant.core import QuantizedTensor
    assert isinstance(eng._params["Wout"], QuantizedTensor)
    got = _gen(_serve(eng, [_prompt(), _prompt(6, 3)]))
    fresh = _gen(_serve(make("port", params=half, quantize="int8",
                             kv_quantize="int8"),
                        [_prompt(), _prompt(6, 3)]))
    jm = jck.CheckpointManager(str(tmp_path / "j"), use_orbax=False)
    jm.save_tree(half, 1)
    je = make("jax", quantize="int8", kv_quantize="int8")
    je.reload_weights(jm)
    assert got == fresh == _gen(_serve(je, [_prompt(), _prompt(6, 3)]))
    assert eng.stats["param_bytes"] == je.stats["param_bytes"]


def test_batch_mode_reloads_between_batches(make, ckpts):
    """A batch engine serves each batch on the tree it started with; a
    reload serves the next batch on the new tree, as JAX's."""
    out = {}
    for side in SIDES:
        eng = make(side, mode="batch", decode_chunk=4)
        a = _serve(eng, [_prompt(), _prompt(8, 1)])
        eng.reload_weights(ckpts[side].directory, step=2)
        b = _serve(eng, [_prompt(), _prompt(8, 1)])
        out[side] = (_gen(a), _gen(b), eng.stats["reloads"],
                     eng.stats["batches"])
    assert out["port"] == out["jax"]
    assert out["port"][0] != out["port"][1]


def test_reloads_from_other_threads_while_the_worker_serves(make, ckpts):
    """Reloads race the background worker: four threads reload the same
    weights twice each while the worker ticks a wave. Each swap waits for
    the running tick, so every request completes with the tokens of an
    uninterrupted run (a request evicted mid-stream resumes from its
    committed tokens) and nothing stays queued or pending."""
    import sys
    import threading
    prompts = [_prompt(8 + k, k) for k in range(8)]
    ref = _gen(_serve(make("port", num_slots=4, max_new_tokens=8),
                      prompts))
    eng = make("port", num_slots=4, max_new_tokens=8, pipeline=True)
    errors = []

    def reloader():
        try:
            for _ in range(2):
                eng.reload_weights(ckpts["port"], step=1)
        except Exception as e:      # surfaced by the assert below
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        eng.start()
        hs = [eng.submit(p) for p in prompts]
        threads = [threading.Thread(target=reloader) for _ in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads) and not errors
        eng.drain(wait=True, timeout=120)
        eng.stop()
    finally:
        sys.setswitchinterval(interval)
    assert eng._thread is None and eng.drained()
    assert eng.stats["reloads"] == 8
    assert _gen(hs) == ref

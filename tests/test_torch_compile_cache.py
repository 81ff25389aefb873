"""The port's compile cache, program cache and warm-up, on the CPU.

The contracts of tests/test_compile_cache.py, held on the port
(deeplearning4j_tpu_torch/serving/compile_cache.py and the engine):

- entries publish atomically (staging suffix, one os.replace; orphaned
  staging files swept) and round-trip; a corrupt, truncated or foreign
  entry fails closed (None, deleted, counted); keys are salted by the
  environment and the caller's salt; stray cache directories sweep;
- a cold engine publishes its programs' manifests (every warm-up
  resolution ``source="jit"``); after a simulated restart (the
  process-wide program cache and `ops._build`'s loaded libraries
  cleared) the same config resolves its whole warm-up set from the cache
  (``jit == 0``, ``aot_cache == programs``), token for token, also on
  int8-KV and paged pools, and equal to JAX's engine (greedy float32);
- one corrupt entry costs exactly one in-process resolution, which
  republishes it; tokens unchanged;
- after `warmup()` mixed traffic adds no resolution and no program-cache
  entry, and the warm-up leaves the pool bit-identical (plain, paged,
  int8, spec, chunked; a paged pool's scratch page 0 apart, which no
  unmasked read sees);
- ``program_cache_size=2`` evicts (counted in
  ``serving_program_cache_evictions``), never holds more than 2 entries
  and serves the tokens of an unbounded engine; the size validates;
- library entries: the seam in `ops._build` fetches a library missing
  from the build directory from the cache (checked before it is
  written), publishes what nvcc built, and rebuilds over a corrupt
  entry. No nvcc here: a stand-in script writes the "library" bytes.
"""
import os
import pathlib
import stat

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402

from deeplearning4j_tpu.models import transformer as jtf  # noqa: E402
from deeplearning4j_tpu.parallel.mesh import MeshSpec, make_mesh  # noqa
from deeplearning4j_tpu.serving import engine as jeng  # noqa: E402

from deeplearning4j_tpu_torch.models import transformer as ttf  # noqa
from deeplearning4j_tpu_torch.models.convert import \
    params_from_numpy  # noqa: E402
from deeplearning4j_tpu_torch.ops import _build  # noqa: E402
from deeplearning4j_tpu_torch.serving import engine as teng  # noqa: E402
from deeplearning4j_tpu_torch.serving.compile_cache import (  # noqa: E402
    _STAGING_SUFFIX, KIND_LIBRARY, KIND_PROGRAM, CompileCache,
    sweep_stray_caches)

# max_len 80: JAX's program caches are process-wide, and
# tests/test_profiling.py leaves AOT-loaded executables of its 64-position
# config in them for any later file on its worker
FIELDS = dict(vocab_size=32, d_model=32, n_heads=4, n_layers=2, max_len=80)
TCFG = ttf.TransformerConfig(**FIELDS)


@pytest.fixture(scope="module")
def tparams():
    return ttf.init_params(TCFG, seed=0, device="cpu")


@pytest.fixture(autouse=True)
def _restore_program_cache_size():
    yield
    teng.set_program_cache_size(teng.DEFAULT_PROGRAM_CACHE_SIZE)


def _prompt(t0, seed):
    return np.random.default_rng(seed).integers(
        0, FIELDS["vocab_size"], size=t0).astype(np.int32)


PROMPTS = [_prompt(6 + i, i) for i in range(4)]


def _fresh_process():
    """A restart inside this process: the program cache and the loaded
    libraries forgotten; only the on-disk cache survives."""
    teng.program_cache_clear()
    _build._loaded.clear()
    _build.origin.clear()


def _engine(tparams, **kw):
    base = dict(decode_chunk=2, max_new_tokens=6, num_slots=4,
                pipeline=False)
    base.update(kw)
    return teng.InferenceEngine(TCFG, tparams, teng.EngineConfig(**base),
                                device="cpu")


def _run(tparams, prompts=PROMPTS, **kw):
    eng = _engine(tparams, **kw)
    hs = [eng.submit(p) for p in prompts]
    eng.run_pending()
    return eng, [h.result() for h in hs]


def _compiles(eng, source):
    return sum(int(c.value) for labels, c in eng._m_compiles.collect()
               if labels[1] == source)


# -- CompileCache ------------------------------------------------------------

def test_store_load_roundtrip_and_atomic_publish(tmp_path):
    stray = tmp_path / ("x.bin" + _STAGING_SUFFIX + "-123-9")
    stray.write_bytes(b"torn half-write")
    cache = CompileCache(tmp_path, device="cpu")
    assert not stray.exists(), "orphaned staging file must be swept"
    key = cache.entry_key("decode", (("chunk", 2),))
    assert cache.load(key, KIND_PROGRAM) is None
    assert cache.store_manifest(key, "decode", [("decode_attention",
                                                 "abc")])
    assert not any(_STAGING_SUFFIX in p.name for p in tmp_path.iterdir())
    assert cache.load_manifest(key) == [("decode_attention", "abc")]
    lk = cache.library_key("flash_fwd", "d1")
    assert cache.store(lk, KIND_LIBRARY, b"\x7fELF library bytes")
    assert cache.load(lk, KIND_LIBRARY) == b"\x7fELF library bytes"
    st = cache.stats()
    assert (st["stores"], st["hits"], st["misses"], st["corrupt"]) == \
        (2, 2, 1, 0)
    assert st["entries"] == 2 and st["bytes"] == cache.nbytes() > 0
    assert CompileCache.available()


def test_corrupt_entry_fails_closed_and_is_deleted(tmp_path):
    cache = CompileCache(tmp_path, device="cpu")
    key = cache.library_key("decode_window", "d2")
    blob = bytes(range(256)) * 4
    cache.store(key, KIND_LIBRARY, blob)
    p = cache.path(key)
    full = p.read_bytes()
    p.write_bytes(full[:len(full) // 2])                 # truncated
    assert cache.load(key, KIND_LIBRARY) is None and not p.exists()
    cache.store(key, KIND_LIBRARY, blob)
    raw = bytearray(p.read_bytes())
    raw[len(raw) // 2] ^= 0xFF                           # bit flip
    p.write_bytes(bytes(raw))
    assert cache.load(key, KIND_LIBRARY) is None and not p.exists()
    p.write_bytes(b"not a cache entry at all")           # foreign file
    assert cache.load(key, KIND_LIBRARY) is None
    cache.store(key, KIND_LIBRARY, blob)                 # another kind
    assert cache.load(key, KIND_PROGRAM) is None
    assert cache.stats()["corrupt"] == 4


def test_keys_are_salted_by_environment_and_user_salt(tmp_path):
    a = CompileCache(tmp_path, salt="A", device="cpu")
    b = CompileCache(tmp_path, salt="B", device="cpu")
    fields = (("bucket", 16), ("slots", 4))
    ka = a.entry_key("prefill", fields)
    assert ka != b.entry_key("prefill", fields)
    assert ka == a.entry_key("prefill", fields)           # stable
    assert a.entry_key("decode", fields) != ka            # program name
    assert a.library_key("flash_fwd", "x") != a.library_key("flash_fwd",
                                                            "y")
    env = a.environment()
    assert env[0] == torch.__version__ and env[-1] == ("cpu",)
    # another device (or runtime) misses: its environment is a key input
    other = CompileCache(tmp_path, salt="A", device="cpu")
    other._env = env[:-1] + (("NVIDIA H100", (9, 0)),)
    assert other.entry_key("prefill", fields) != ka


def test_sweep_stray_caches(tmp_path):
    (tmp_path / "dl4j-aot-test-abc").mkdir()
    (tmp_path / "dl4j-aot-test-def").mkdir()
    (tmp_path / "unrelated").mkdir()
    assert sweep_stray_caches(root=tmp_path, prefix="dl4j-aot-test-") == 2
    assert (tmp_path / "unrelated").exists()
    assert not (tmp_path / "dl4j-aot-test-abc").exists()


# -- engine: cold start, warm start ------------------------------------------

@pytest.fixture(scope="module")
def jax_tokens():
    """JAX's engine on the same weights (greedy float32): the tokens
    every port run here must give."""
    jcfg = jtf.TransformerConfig(**FIELDS)
    jp = jtf.init_params(jcfg, jax.random.PRNGKey(0))
    mesh = make_mesh(MeshSpec(data=1, model=1))
    eng = jeng.InferenceEngine(jcfg, mesh, jp, jeng.EngineConfig(
        decode_chunk=2, max_new_tokens=6, num_slots=4, pipeline=False))
    hs = [eng.submit(p) for p in PROMPTS]
    eng.run_pending()
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                           device="cpu")
    return tp, [h.result() for h in hs]


def test_cold_then_warm_restart_loads_instead_of_compiling(tmp_path,
                                                           jax_tokens):
    tp, ref = jax_tokens
    _fresh_process()
    cold, got = _run(tp, compile_cache_dir=str(tmp_path),
                     warmup_on_init=True)
    assert [g.tolist() for g in got] == [r.tolist() for r in ref]
    w = cold.last_warmup
    assert w["jit"] == w["programs"] > 0 and w["aot_cache"] == 0
    assert w["aot"]["stores"] == w["programs"]
    assert cold.health()["last_warmup"] == w
    _fresh_process()
    warm, got2 = _run(tp, compile_cache_dir=str(tmp_path),
                      warmup_on_init=True)
    assert [g.tolist() for g in got2] == [r.tolist() for r in ref]
    assert warm.last_warmup["jit"] == 0
    assert warm.last_warmup["aot_cache"] == warm.last_warmup["programs"]
    assert warm.health()["compiles_by_source"] == {
        "aot_cache": warm.last_warmup["programs"]}
    assert warm.debugz()["compile_cache"]["aot"]["hits"] >= \
        warm.last_warmup["programs"]


def test_corrupt_cache_entry_recompiles_token_exact(tmp_path, tparams):
    _fresh_process()
    _, ref = _run(tparams, PROMPTS[:1], compile_cache_dir=str(tmp_path),
                  warmup_on_init=True)
    victim = sorted(pathlib.Path(tmp_path).glob("*.bin"))[0]
    victim.write_bytes(victim.read_bytes()[:20])
    _fresh_process()
    eng, got = _run(tparams, PROMPTS[:1], compile_cache_dir=str(tmp_path),
                    warmup_on_init=True)
    np.testing.assert_array_equal(ref[0], got[0])
    assert eng._aot.stats()["corrupt"] == 1
    assert eng.last_warmup["jit"] == 1
    assert eng.last_warmup["aot_cache"] == eng.last_warmup["programs"] - 1
    assert victim.exists(), "the re-resolution must republish the entry"


def test_warmup_makes_traffic_compile_free(tmp_path, tparams):
    _fresh_process()
    eng = _engine(tparams, compile_cache_dir=str(tmp_path))
    report = eng.warmup()
    assert report["programs"] == 1 + 4     # decode, buckets 16..64, 80
    jit0, aot0 = _compiles(eng, "jit"), _compiles(eng, "aot_cache")
    size0 = teng.program_cache_info().currsize
    keys0 = sorted(eng._programs)
    hs = [eng.submit(_prompt(4 + 9 * i, i)) for i in range(6)]
    eng.run_pending()
    assert all(h.done() for h in hs)
    assert (_compiles(eng, "jit"), _compiles(eng, "aot_cache")) == \
        (jit0, aot0)
    assert teng.program_cache_info().currsize == size0
    assert sorted(eng._programs) == keys0


def _pool(eng):
    """The engine's pool (a paged pool without its scratch page) and its
    host state, as copies."""
    planes = [t.clone() for t in eng._slot_state]
    if eng._paged:
        planes = [t[:, 1:].clone() for t in planes[:-2]] + planes[-2:]
        planes.append(torch.from_numpy(eng._bt.copy()))
    return planes


@pytest.mark.parametrize("kw", [
    {}, {"paged": True, "page_size": 4}, {"kv_quantize": "int8"},
    {"spec_decode": True, "spec_k": 4, "draft": "layers:1"},
    {"prefill_chunk": 8}, {"prefill_chunk": 8, "paged": True,
                           "page_size": 4}],
    ids=["plain", "paged", "int8", "spec", "chunked", "paged-chunked"])
def test_warmup_leaves_the_pool_bit_identical(tparams, kw):
    """Warm-up runs every program once on the live pool with every slot
    inactive: after a served wave, and with a request still seated
    mid-decode, the pool is bit-identical before and after."""
    eng = _engine(tparams, max_new_tokens=10, **kw)
    hs = [eng.submit(p) for p in PROMPTS[:3]]
    eng.run_pending()
    held = eng.submit(PROMPTS[3])
    eng.tick()
    assert not held.done()
    before = _pool(eng)
    eng.warmup()
    after = _pool(eng)
    assert all(torch.equal(a, b) for a, b in zip(before, after))
    eng.run_pending()
    ref = _engine(tparams, max_new_tokens=10, **kw)
    rh = [ref.submit(p) for p in PROMPTS]
    ref.run_pending()
    assert [h.result().tolist() for h in hs + [held]] == \
        [h.result().tolist() for h in rh]


@pytest.mark.parametrize("kw", [{"kv_quantize": "int8"},
                                {"paged": True, "page_size": 8}],
                         ids=["int8", "paged"])
def test_quantized_and_paged_geometries_roundtrip(tmp_path, tparams, kw):
    prompts = PROMPTS[:2]
    _fresh_process()
    _, ref = _run(tparams, prompts, **kw)
    _fresh_process()
    _, cold = _run(tparams, prompts, compile_cache_dir=str(tmp_path),
                   warmup_on_init=True, **kw)
    _fresh_process()
    warm_eng, warm = _run(tparams, prompts,
                          compile_cache_dir=str(tmp_path),
                          warmup_on_init=True, **kw)
    for a, b, c in zip(ref, cold, warm):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
    assert warm_eng.last_warmup["jit"] == 0
    assert warm_eng.last_warmup["aot_cache"] == \
        warm_eng.last_warmup["programs"]


# -- the process-wide program cache -------------------------------------------

def test_program_cache_size_unified_and_evictions_published(tparams):
    ref_eng = _engine(tparams, num_slots=2, max_new_tokens=4)
    eng = _engine(tparams, num_slots=2, max_new_tokens=4,
                  program_cache_size=2)
    outs = []
    for t0 in (8, 24, 40):          # 3 buckets + the decode program > 2
        h = eng.submit(_prompt(t0, 1))
        eng.run_pending()
        outs.append(h.result())
        assert teng.program_cache_info().currsize <= 2
    assert teng.program_cache_info().maxsize == 2
    evicted = eng.registry.get("serving_program_cache_evictions").value
    assert evicted > 0
    # an evicted key resolves again: more resolutions than keys
    assert _compiles(eng, "jit") > len(eng._programs)
    teng.set_program_cache_size(teng.DEFAULT_PROGRAM_CACHE_SIZE)
    for t0, want in zip((8, 24, 40), outs):
        h = ref_eng.submit(_prompt(t0, 1))
        ref_eng.run_pending()
        np.testing.assert_array_equal(h.result(), want)
    assert ref_eng.registry.get(
        "serving_program_cache_evictions").value == 0


def test_entries_of_dropped_engines_go_first(tparams):
    """Over the bound, the keys of engines that are gone are dropped
    before a live engine's, and silently."""
    teng.program_cache_clear()
    gone = _engine(tparams, num_slots=3, max_new_tokens=2)
    gone.submit(PROMPTS[0])
    gone.run_pending()
    del gone
    live = _engine(tparams, num_slots=2, max_new_tokens=2,
                   program_cache_size=2)
    live.submit(PROMPTS[0])
    live.run_pending()
    assert teng.program_cache_info().currsize == 2
    assert live.registry.get("serving_program_cache_evictions").value == 0


def test_program_cache_size_validates(tparams):
    with pytest.raises(ValueError, match="program_cache_size"):
        teng.set_program_cache_size(0)
    with pytest.raises(ValueError, match="program_cache_size"):
        _engine(tparams, program_cache_size=0)


def test_compile_metrics_have_samples(tparams):
    _fresh_process()
    eng, _ = _run(tparams, PROMPTS[:1])
    assert _compiles(eng, "jit") >= 2           # prefill + decode
    fams = {labels[0] for labels, _ in eng._m_compile_seconds.collect()}
    assert {"prefill", "decode"} <= fams
    # engines of one geometry share a program, and each counts its own
    # first resolution of it
    other, _ = _run(tparams, PROMPTS[:1])
    assert _compiles(other, "jit") == _compiles(eng, "jit")
    fn = eng._program("decode", 2)
    assert other._program("decode", 2) is fn


def test_batch_mode_programs_go_through_the_cache_uncounted(tparams):
    eng = _engine(tparams, mode="batch", max_batch_size=2)
    h = eng.submit(PROMPTS[0])
    eng.run_pending()
    assert h.status == "completed"
    assert list(eng._programs) == [("generate", 2)]
    assert _compiles(eng, "jit") == 0
    with pytest.raises(ValueError, match="continuous"):
        eng.warmup()


# -- library entries: the ops._build seam -------------------------------------

@pytest.fixture
def fake_nvcc(tmp_path, monkeypatch):
    """A build directory of the test's own and a stand-in for nvcc that
    writes known bytes to its ``-o`` path (or fails with ``FAIL`` set)."""
    script = tmp_path / "nvcc"
    script.write_text(
        "#!/bin/sh\n"
        "while [ $# -gt 0 ]; do\n"
        "  if [ \"$1\" = \"-o\" ]; then out=\"$2\"; fi; shift\n"
        "done\n"
        "if [ -n \"$FAIL\" ]; then echo 'error: no' >&2; exit 3; fi\n"
        "printf 'library bytes' > \"$out\"\n"
        "echo 'ptxas info    : 0 bytes gmem' >&2\n")
    script.chmod(script.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(_build, "nvcc_path", lambda: str(script))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "nvcc_runs", {})
    monkeypatch.setattr(_build, "origin", {})
    return CompileCache(tmp_path / "cache", device="cpu")


def test_library_built_once_then_fetched_from_the_cache(fake_nvcc):
    cache = fake_nvcc
    path = _build.ensure_built("decode_attention", cache=cache)
    assert path.read_bytes() == b"library bytes"
    assert _build.nvcc_runs == {"decode_attention": 1}
    assert _build.origin["decode_attention"] == "nvcc"
    key = cache.library_key("decode_attention",
                            _build._digest("decode_attention"))
    assert cache.load(key, KIND_LIBRARY) == b"library bytes"
    # a fresh build directory (a new checkout): no nvcc, the cache's
    # bytes, checked, at the library's path
    for p in list(_build.BUILD_DIR.iterdir()):
        p.unlink()
    _build.origin.clear()
    path = _build.ensure_built("decode_attention", cache=cache)
    assert path.read_bytes() == b"library bytes"
    assert _build.nvcc_runs == {"decode_attention": 1}
    assert _build.origin["decode_attention"] == "cache"
    assert not any(p.name.endswith(".tmp")
                   for p in _build.BUILD_DIR.iterdir())
    # a library found built is published where the cache lacks it
    cache.path(key).unlink()
    _build.ensure_built("decode_attention", cache=cache)
    assert cache.path(key).exists()


def test_corrupt_library_entry_is_rebuilt_never_loaded(fake_nvcc):
    cache = fake_nvcc
    _build.ensure_built("decode_window", cache=cache)
    key = cache.library_key("decode_window",
                            _build._digest("decode_window"))
    blob = bytearray(cache.path(key).read_bytes())
    blob[-1] ^= 0xFF
    cache.path(key).write_bytes(bytes(blob))
    out = _build.library_path("decode_window")
    out.unlink()
    _build.ensure_built("decode_window", cache=cache)
    assert _build.nvcc_runs == {"decode_window": 2}
    assert out.read_bytes() == b"library bytes"
    assert cache.stats()["corrupt"] == 1
    assert cache.load(key, KIND_LIBRARY) == b"library bytes"


def test_failed_nvcc_raises_and_publishes_nothing(fake_nvcc, monkeypatch):
    cache = fake_nvcc
    monkeypatch.setenv("FAIL", "1")
    with pytest.raises(RuntimeError, match="nvcc failed"):
        _build.ensure_built("flash_fwd", cache=cache)
    assert not _build.library_path("flash_fwd").exists()
    assert fake_nvcc.entries() == []


def test_build_without_a_cache_touches_no_cache(fake_nvcc):
    """The cache is an argument, not process state: a build given none
    (a second engine without ``compile_cache_dir``) neither reads nor
    publishes the one an earlier build was given."""
    cache = fake_nvcc
    _build.ensure_built("decode_window", cache=cache)
    _build.library_path("decode_window").unlink()
    _build.ensure_built("decode_window")
    assert _build.nvcc_runs == {"decode_window": 2}
    _build.ensure_built("flash_fwd")
    assert cache.stats()["hits"] == 0
    assert [e.split("-")[1] for e in cache.entries()] == ["decode_window"]


def test_other_salt_misses_the_library(fake_nvcc, tmp_path):
    _build.ensure_built("flash_fwd", cache=fake_nvcc)
    other = CompileCache(fake_nvcc.directory, salt="another card",
                         device="cpu")
    _build.library_path("flash_fwd").unlink()
    _build.ensure_built("flash_fwd", cache=other)
    assert _build.nvcc_runs == {"flash_fwd": 2}
    assert os.path.exists(_build.library_path("flash_fwd"))

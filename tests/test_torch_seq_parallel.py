"""Sequence-parallel attention of the port (parallel/ring.py,
parallel/ulysses.py) against JAX's `ring_attention` / `ulysses_attention`
under `shard_map` (tests/test_megatron.py:53-90), causal, float32.

One start of four gloo CPU ranks (module scope) runs every case:
`torch_parallel_helpers.seq_attention_job` gives each rank's output
block and its q / k / v gradient blocks of sum(out * ct). JAX computes
the same on conftest's virtual devices, once a module. Tolerance 1e-5
(outputs and gradients).
"""
from functools import partial

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh, PartitionSpec as P  # noqa: E402

from deeplearning4j_tpu.parallel.ring import ring_attention  # noqa: E402
from deeplearning4j_tpu.parallel.ulysses import \
    ulysses_attention  # noqa: E402

from deeplearning4j_tpu_torch.parallel.multihost import \
    MultiHostLauncher  # noqa: E402

import torch_parallel_helpers as H  # noqa: E402

try:
    from jax import shard_map
except ImportError:      # jax<0.6: pre-promotion location
    from jax.experimental.shard_map import shard_map

TOL = 1e-5
CASES = [(impl, s) for impl in ("ring", "ulysses") for s in (2, 4)]


def _inputs():
    rng = np.random.RandomState(0)
    return [rng.randn(2, 32, 4, 8).astype(np.float32) for _ in range(4)]


@pytest.fixture(scope="module")
def port():
    q, k, v, ct = _inputs()
    cases = [(f"{impl}{s}", impl, s, q, k, v, ct) for impl, s in CASES]
    bad = np.random.RandomState(1).randn(2, 8, 3, 8).astype(np.float32)
    cases.append(("ulysses_bad_heads", "ulysses", 2, bad, bad, bad, bad))
    return MultiHostLauncher(4, device="cpu").run(
        H.seq_attention_job, timeout=240, args=(cases,))


@pytest.fixture(scope="module")
def jax_ref():
    import inspect
    q, k, v, ct = (jnp.asarray(a) for a in _inputs())
    compat = ({} if "check_vma" in inspect.signature(shard_map).parameters
              else {"check_rep": False})
    out = {}
    for impl, s in CASES:
        mesh = Mesh(np.array(jax.devices()[:s]).reshape(s), ("seq",))
        attn = ring_attention if impl == "ring" else ulysses_attention
        fn = jax.jit(shard_map(
            partial(attn, axis_name="seq", causal=True), mesh=mesh,
            in_specs=(P(None, "seq"),) * 3, out_specs=P(None, "seq"),
            **compat))
        o, pull = jax.vjp(fn, q, k, v)
        dq, dk, dv = pull(ct)
        out[f"{impl}{s}"] = tuple(np.asarray(a) for a in (o, dq, dk, dv))
    return out


@pytest.mark.parametrize("impl,s", CASES,
                         ids=[f"{i}-seq{s}" for i, s in CASES])
def test_matches_jax_forward_and_grads(port, jax_ref, impl, s):
    name = f"{impl}{s}"
    want = jax_ref[name]
    blocks = sorted((r[name] for r in port if name in r),
                    key=lambda b: b["index"])
    assert len(blocks) == s
    for j, key in enumerate(("out", "dq", "dk", "dv")):
        got = np.concatenate([b[key] for b in blocks], axis=1)
        np.testing.assert_allclose(got, want[j], atol=TOL, rtol=0,
                                   err_msg=f"{name} {key}")


def test_ulysses_head_divisibility_error(port):
    """JAX's message when local heads do not divide by the 'seq' size."""
    errs = [r["ulysses_bad_heads"] for r in port
            if "ulysses_bad_heads" in r]
    assert len(errs) == 2
    for e in errs:
        assert e["error"] == ("ulysses_attention: local head count 3 not "
                              "divisible by 'seq' axis size 2")

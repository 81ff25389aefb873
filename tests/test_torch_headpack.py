"""Port parity: the head-packing experiment's backward vs the JAX package.

The port's plain twin `packed2_backward_reference` (what
csrc/flash_bwd_packed2.cu computes) runs on the CPU against the JAX
experiment's own Pallas kernel, benchmarks/headpack_experiment.py
`_packed2_kernel`, in interpret mode: the test builds the same
`pl.pallas_call` as the experiment's `_packed2_call` (same specs, grid and
scratch) with ``interpret=True``, since `_packed2_call` takes no interpret
flag. The q-chunked path runs JAX's own `packed2_backward` with that call
in place of `_packed2_call`. Inputs are numpy draws from fixed seeds.

Tolerances: float32 1e-5 absolute plus 1e-5 relative (the same f32 math
summed in another order; measured differences stay below 5e-7). bfloat16
per gradient row, 2^-6 of the JAX row's largest entry plus 1e-5: P and dS
are rounded to bf16 inside the sums, and the two sides may round a value
whose f32 inputs differ in the last bit to neighbouring bf16 values (the
card gate of the same kernel, chip_smoke.py BF16_BWD_ROW_RTOL).
"""
import functools
import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from deeplearning4j_tpu.ops.flash_attention import (  # noqa: E402
    _flash_forward, _inner_block)

from deeplearning4j_tpu_torch.benchmarks import (  # noqa: E402
    headpack_experiment as thx)
from deeplearning4j_tpu_torch.ops import flash_attention as tfa  # noqa

ROOT = Path(__file__).resolve().parent.parent
F32 = dict(rtol=1e-5, atol=1e-5)
BF16_ROW_RTOL = 2.0 ** -6


def _load_experiment():
    spec = importlib.util.spec_from_file_location(
        "headpack_experiment", ROOT / "benchmarks" / "headpack_experiment.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


jhx = _load_experiment()


def _packed2_call_interpret(q3, k3, v3, o3, m, logl, g, scale, causal,
                            q_offset, kv_offset):
    """headpack_experiment.py:176-202 with interpret=True."""
    import jax.experimental.pallas as pl
    from jax.experimental.pallas import tpu as pltpu

    bh, tq, d = q3.shape
    assert bh % 2 == 0
    sk = k3.shape[1]
    bq = _inner_block(tq)
    bk = _inner_block(sk, 256)
    delta = jnp.sum(g.astype(jnp.float32) * o3.astype(jnp.float32), -1,
                    keepdims=True)
    statics = dict(scale=scale, causal=causal, qo=int(q_offset),
                   ko=int(kv_offset), bq=bq, bk=bk)
    full = pl.BlockSpec((2, tq, d), lambda b, j: (b, 0, 0))
    kspec = pl.BlockSpec((2, sk, d), lambda b, j: (b, j, 0))
    col = pl.BlockSpec((2, tq, 1), lambda b, j: (b, 0, 0))
    return pl.pallas_call(
        functools.partial(jhx._packed2_kernel, **statics),
        out_shape=[jax.ShapeDtypeStruct((bh, tq, d), q3.dtype),
                   jax.ShapeDtypeStruct((bh, sk, d), k3.dtype),
                   jax.ShapeDtypeStruct((bh, sk, d), v3.dtype)],
        grid=(bh // 2, 1),
        in_specs=[full, kspec, kspec, full, col, col, col],
        out_specs=[full, kspec, kspec],
        scratch_shapes=[pltpu.VMEM((2, tq, d), jnp.float32)],
        interpret=True,
    )(q3, k3, v3, g, m, logl, delta)


def _inputs(bh, tq, sk, dh, causal, qo, ko, dtype=np.float32, seed=0):
    """Seeded q, k, v, dO; the JAX forward's (o, m, log l) in interpret
    mode; both sides' arguments."""
    rng = np.random.default_rng(seed)
    q, k, v, do = (rng.normal(size=(bh, n, dh)).astype(np.float32)
                   for n in (tq, sk, sk, tq))
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    jq, jk, jv, jdo = (jnp.asarray(x, jdt) for x in (q, k, v, do))
    jo, jm, jl = _flash_forward(jq, jk, jv, dh ** -0.5, causal, qo, ko, True)

    def tt(x):
        return torch.from_numpy(np.array(x.astype(jnp.float32))).to(tdt)

    tq_, tk, tv, tdo, to = (tt(x) for x in (jq, jk, jv, jdo, jo))
    tm, tl = (torch.from_numpy(np.array(x)) for x in (jm, jl))
    delta = (tdo.float() * to.float()).sum(-1, keepdim=True)
    return (jq, jk, jv, jo, jm, jl, jdo), (tq_, tk, tv, tdo, tm, tl, delta)


def _assert_grads_close(got, want, dtype):
    for g, w, name in zip(got, want, ("dq", "dk", "dv")):
        g = g.float().numpy()
        w = np.asarray(w, np.float32)
        if dtype == "bfloat16":
            limit = np.abs(w).max(-1, keepdims=True) * BF16_ROW_RTOL + 1e-5
            worst = float((np.abs(g - w) / limit).max())
            assert worst <= 1.0, f"{name}: {worst} x its bf16 row limit"
        else:
            np.testing.assert_allclose(g, w, err_msg=name, **F32)


@pytest.mark.parametrize("causal,tq,sk,qo,ko,dtype", [
    (True, 128, 128, 0, 0, np.float32),      # causal, T = S
    (False, 64, 128, 0, 0, np.float32),      # non-causal, S != T
    (True, 64, 128, 64, 0, np.float32),      # a q chunk at q_offset 64
    (True, 64, 64, 0, 32, np.float32),       # kv after q: masked rows
    (True, 128, 128, 0, 0, "bfloat16"),
])
def test_packed2_twin_matches_jax_kernel(causal, tq, sk, qo, ko, dtype):
    jargs, targs = _inputs(4, tq, sk, 16, causal, qo, ko, dtype)
    scale = 16 ** -0.5
    want = _packed2_call_interpret(*jargs, scale, causal, qo, ko)
    got = tfa.packed2_backward_reference(*targs, scale, causal, qo, ko)
    assert [x.dtype for x in got] == [targs[0].dtype] * 3
    _assert_grads_close(got, want, dtype)


@pytest.mark.parametrize("causal,tq,sk,qo,ko", [
    (True, 100, 100, 0, 0),       # one ragged tile
    (True, 64, 96, 0, 32),        # fully-masked rows (q before kv)
    (True, 77, 200, 123, 0),      # q after kv
    (False, 77, 150, 0, 0),       # full attention, S != T
    (True, 256, 1024, 512, 0),    # several k tiles, a q_offset chunk
])
def test_packed2_twin_matches_flash_backward_twin(causal, tq, sk, qo, ko):
    """Same function as the production backward's twin."""
    rng = np.random.default_rng(1)
    q, do = (torch.from_numpy(rng.normal(size=(4, tq, 16)).astype(
        np.float32)) for _ in range(2))
    k, v = (torch.from_numpy(rng.normal(size=(4, sk, 16)).astype(
        np.float32)) for _ in range(2))
    o, m, logl = tfa.flash_forward_reference(q, k, v, 0.25, causal, qo, ko)
    delta = (do * o).sum(-1, keepdim=True)
    args = (q, k, v, do, m, logl, delta, 0.25, causal, qo, ko)
    got = tfa.packed2_backward_reference(*args)
    want = tfa.flash_backward_reference(*args)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **F32)


def test_q_chunked_packed2_matches_jax_packed2_backward(monkeypatch):
    """tq 1024 chunked at 512 (two chunks, dk / dv summed in f32 over
    them, dq concatenated): the port's dispatcher on CPU tensors against
    JAX's own `packed2_backward` running the interpret call."""
    monkeypatch.setattr(jhx, "_packed2_call", _packed2_call_interpret)
    jargs, targs = _inputs(2, 1024, 1024, 8, True, 0, 0, seed=3)
    scale = 8 ** -0.5
    before = tfa.packed2_backward_cuda.launches
    got = tfa.packed2_backward(*targs, scale, True)
    jq, jk, jv, jo, jm, jl, jdo = jargs
    want = jhx.packed2_backward(jq, jk, jv, jo, jm, jl, jdo, scale, True, 0,
                                0)
    assert tfa.packed2_backward_cuda.launches == before
    _assert_grads_close(got, want, np.float32)


def test_packed2_refuses_odd_batch_heads():
    x = torch.zeros((3, 8, 16))
    m = torch.zeros((3, 8, 1))
    with pytest.raises(ValueError, match="even"):
        tfa.packed2_backward_reference(x, x, x, x, m, m, m, 0.25, True)
    with pytest.raises(ValueError, match="even"):
        tfa.packed2_backward(x, x, x, x, m, m, m, 0.25, True)


def test_inner_block_copy_matches_jax():
    for n in (1, 8, 100, 256, 512, 768, 1000, 1024, 2048, 4096, 4100):
        for cap in (256, 512):
            assert tfa._inner_block(n, cap) == _inner_block(n, cap), (n, cap)


def test_headpack_experiment_runs_on_cpu(capsys):
    rec = thx.main(["--device", "cpu", "--small"])
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()
             if x.startswith("{")]
    assert lines == [rec]
    assert rec["experiment"] == "headpack2_fused_backward"
    assert rec["shape"] == "bh4_T1024_Dh16" and rec["device"] == "cpu"
    assert rec["card"] is None and rec["timer"] == "host perf_counter"
    for key in ("production_ms", "packed2_q512_ms", "production_q512_ms",
                "speedup_vs_production", "speedup_vs_chunked_control"):
        assert rec[key] > 0, key
    # the correctness call, the warm call and n * reps timed calls; the
    # plain twins launch no kernel
    assert rec["packed2_q512_calls"] == 3
    assert rec["launches"] == {"flash_bwd_packed2": 0, "flash_bwd": 0}

"""Port parity: the decode sweep's split-S twin vs the JAX package.

`reference_split_decode_attention` (what csrc/decode_sweep.cu computes:
float32 partials per bs-row split, then their merge) runs on the CPU
against JAX's `reference_decode_attention`
(deeplearning4j_tpu/ops/flash_decode.py:93), for every bs of the sweep's
grid scaled to a small cache (S = 64: bs 4..64, plus one bs that does not
divide S), with scalar and [B] pos, 0 and S-1 included, and through the
dispatcher on a stacked [L, B, S, D] cache with a layer selected. The
Pallas `_decode_kernel` does not trace in interpret mode on this JAX
version (tests/test_flash_decode.py), so the JAX side is its plain
reference, as in tests/test_torch_attention.py. Inputs are numpy draws
from fixed seeds; float32 tolerance 1e-5 (the same f32 math summed in
another order).
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from deeplearning4j_tpu.ops import flash_decode as jdec  # noqa: E402

from deeplearning4j_tpu_torch.benchmarks import (  # noqa: E402
    decode_kernel_sweep as tsw)
from deeplearning4j_tpu_torch.ops import flash_decode as tdec  # noqa: E402

F32 = dict(rtol=0, atol=1e-5)
B, H, DH, S = 4, 2, 16, 64
POS = [0, 17, S - 1, np.array([0, S - 1, 30, 5], np.int32),
       np.array(17, np.int32)]


def _rand(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("bs", [4, 8, 16, 32, 64, 24])
@pytest.mark.parametrize("pos", POS,
                         ids=["0", "17", "S-1", "vector", "0-d tensor"])
def test_split_twin_matches_jax_reference(bs, pos):
    q = _rand((B, H, DH), 0)
    k, v = _rand((B, S, H * DH), 1), _rand((B, S, H * DH), 2)
    want = jdec.reference_decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos), H)
    tpos = torch.from_numpy(pos) if isinstance(pos, np.ndarray) else pos
    got = tdec.reference_split_decode_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), tpos,
        H, bs)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


@pytest.mark.parametrize("bs,warps", [(8, 4), (16, 8), (64, 4), (64, 8)])
def test_dispatcher_stacked_cache_layer_matches_jax(bs, warps):
    """decode_sweep on CPU tensors: the stacked cache's layer plane, the
    twin at bs (warps only shape the kernel's launch)."""
    q = _rand((B, H, DH), 3)
    k, v = _rand((3, B, S, H * DH), 4), _rand((3, B, S, H * DH), 5)
    pos = np.array([S - 1, 0, 40, 9], np.int32)
    want = jdec.reference_decode_attention(
        jnp.asarray(q), jnp.asarray(k[2]), jnp.asarray(v[2]),
        jnp.asarray(pos), H)
    before = (tdec.decode_sweep_cuda.launches,
              tdec.decode_attention_cuda.launches)
    got = tdec.decode_sweep(torch.from_numpy(q), torch.from_numpy(k),
                            torch.from_numpy(v), torch.from_numpy(pos), H,
                            bs, warps, layer=2)
    assert (tdec.decode_sweep_cuda.launches,
            tdec.decode_attention_cuda.launches) == before
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


def test_split_twin_bf16_matches_plain_decode():
    """bf16: partials round each split's probabilities to bf16 against
    the split's own max, so the twin is held per row to one bf16 rounding
    (2^-7 of the row's largest entry plus 1e-5) of the port's plain
    decode reference."""
    q = torch.from_numpy(_rand((B, H, DH), 6)).bfloat16()
    k = torch.from_numpy(_rand((B, S, H * DH), 7)).bfloat16()
    v = torch.from_numpy(_rand((B, S, H * DH), 8)).bfloat16()
    pos = torch.tensor([S - 1, 0, 33, 12])
    want = tdec.reference_decode_attention(q, k, v, pos, H).float()
    for bs in (4, 16, 64):
        got = tdec.reference_split_decode_attention(q, k, v, pos, H, bs)
        assert got.dtype == torch.bfloat16
        limit = want.abs().amax(-1, keepdim=True) * 2.0 ** -7 + 1e-5
        assert float(((got.float() - want).abs() / limit).max()) <= 1.0


def test_production_geometry_rule():
    assert tdec.is_production_geometry(2048, 4, 2048)
    assert not tdec.is_production_geometry(2048, 8, 2048)
    assert not tdec.is_production_geometry(1024, 4, 2048)
    assert tsw.SWEEP_BS == (128, 256, 512, 1024, 2048)
    assert tdec.SWEEP_WARPS == (4, 8)


def test_sweep_script_runs_on_cpu(capsys):
    recs = tsw.main(["--device", "cpu", "--small"])
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()
             if x.startswith("{")]
    assert lines == recs and len(recs) == 5 * 2 * 2
    assert {(r["bs"], r["warps"], r["pos"]) for r in recs} == {
        (bs, w, p) for bs in (4, 8, 16, 32, 64) for w in (4, 8)
        for p in (3, 62)}
    for r in recs:
        assert r["ms_per_call"] > 0 and r["bound_ms"] > 0
        assert r["row_rel_err"] <= 1.0 and r["device"] == "cpu"
        assert r["grid"] == [-(-S // r["bs"]), H, B]
        assert r["launches"] == {"decode_sweep": 0, "decode_attention": 0}
    assert [r["production"] for r in recs].count(True) == 2


def test_bandwidth_probe_runs_on_cpu(capsys):
    rec = tsw.main(["--device", "cpu", "--small", "--bandwidth"])
    out = json.loads(capsys.readouterr().out.strip())
    assert out == rec and rec["probe"] == "hbm_copy_bandwidth"
    assert rec["gb_per_s"] > 0 and rec["bytes"] == 1 << 20
    assert rec["datasheet_gb_per_s"] == 3350.0 and rec["card"] is None

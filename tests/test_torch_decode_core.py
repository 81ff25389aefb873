"""Port parity: the split of the bf16 / f16 decode and window kernels.

csrc/decode_tc.cuh cuts each (batch row, head)'s cache into chunks of
`DECODE_CH` rows over a cluster of `decode_cluster(S)` CTAs (rank r takes
chunks r, r + C, ...), and merges the ranks' softmax states in rank order,
skipping a rank with no live key. The launch's Python side (grid, cluster
size, chunk partition, which CTAs load anything) is held against cases
worked by hand, and the plain chunked twin
`reference_chunked_window_attention` (and its decode form), which follows
that partition, against JAX's `reference_window_attention` /
`reference_decode_attention` (deeplearning4j_tpu/ops/flash_decode.py:93,
139) on numpy draws from fixed seeds: T = 1, 5 and 8; pos at 0, CH - 1,
CH, CH + 1, S - 1 and past S - 8 (the window clamps at S - 1); S not a
multiple of CH; flat [B, S, D] and stacked [L, B, S, D] caches.

Tolerances: float32 1e-5 (the same f32 math summed in another order);
bfloat16 per output row, 2^-7 of the row's largest entry plus 1e-5 (one
bf16 rounding: the twin rounds each rank's unnormalised probabilities to
bf16 and the output once). In bf16 the JAX side runs in float32 on the
same bf16 values: the twin, like the Pallas kernels it stands for, keeps
the scores' float32 sum (the kernels' jnp.sum(..., dtype=float32)),
where JAX's jnp reference in bf16 rounds them to bf16 in its einsum, a
rounding that alone moves the window rows by up to 1.25 of that limit
(measured here at T=5 and 8).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401

import jax.numpy as jnp  # noqa: E402

from deeplearning4j_tpu.ops import flash_decode as jdec  # noqa: E402

from deeplearning4j_tpu_torch.ops import flash_decode as tdec  # noqa: E402

CH = tdec.DECODE_CH
B, H, DH = 2, 2, 16


def _rand(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


# -- the launch's Python side ------------------------------------------------

def test_split_constants():
    assert (tdec.DECODE_CH, tdec.DECODE_MAX_CLUSTER,
            tdec.DECODE_TILE_ROWS) == (512, 8, 16)


@pytest.mark.parametrize("s,c", [(1, 1), (512, 1), (513, 2), (1124, 3),
                                 (2048, 4), (3584, 7), (4096, 8),
                                 (4097, 8), (10000, 8)])
def test_cluster_size_from_s(s, c):
    assert tdec.decode_cluster(s) == c


@pytest.mark.parametrize("s,t,grid", [
    (2048, 1, (4, 8, 64)),     # decode at the serving shape
    (2048, 8, (4, 8, 64)),     # the K=7 verify window: one row tile
    (2048, 16, (4, 8, 64)),
    (2048, 17, (8, 8, 64)),    # a second row tile
    (300, 5, (1, 8, 64)),
    (5000, 3, (8, 8, 64)),
])
def test_grid_from_s_and_t(s, t, grid):
    assert tdec.decode_grid(s, t, 8, 64) == grid


@pytest.mark.parametrize("s,rank,starts", [
    (2048, 0, [0]), (2048, 3, [1536]),
    (4096, 0, [0]), (4096, 7, [3584]),
    (5000, 0, [0, 4096]), (5000, 1, [512, 4608]), (5000, 2, [1024]),
    (1124, 0, [0]), (1124, 2, [1024]),
])
def test_chunk_partition(s, rank, starts):
    assert tdec.decode_chunks(s, rank) == starts


def test_chunks_cover_the_cache_once():
    for s in (1, 511, 512, 1124, 2048, 4097, 5000, 10000):
        got = sorted(x for r in range(tdec.decode_cluster(s))
                     for x in tdec.decode_chunks(s, r))
        assert got == list(range(0, s, CH)), s


def test_live_ctas_for_a_pos_vector():
    pos = torch.tensor([0, 511, 512, 2047, 1000, -5, 1536])
    live = tdec.decode_live_ctas(pos, 2048, 1, 7)
    assert live.shape == (7, 1, 4)
    assert live[:, 0].sum(-1).tolist() == [1, 1, 2, 4, 2, 1, 4]
    assert live[4, 0].tolist() == [True, True, False, False]
    # the K=7 window at pos 505 reaches row 512, rank 1's first
    live = tdec.decode_live_ctas(torch.tensor([504, 505, 2045]), 2048, 8,
                                 3)
    assert live[:, 0].sum(-1).tolist() == [1, 2, 4]
    # T = 17 at pos 0: tile 0's last row is 15, tile 1's (one row) 16
    live = tdec.decode_live_ctas(0, 2048, 17, 1)
    assert live.shape == (1, 2, 4)
    assert live[0].sum(-1).tolist() == [1, 1]
    # a scalar pos broadcasts; S = 1124 has three ranks
    live = tdec.decode_live_ctas(1023, 1124, 2, 3)
    assert live.shape == (3, 1, 3)
    assert live[:, 0].sum(-1).tolist() == [3, 3, 3]
    # S = 5000: eight ranks, rank 0 also takes the chunk at 4096
    live = tdec.decode_live_ctas(torch.tensor([4500, 3583]), 5000, 1, 2)
    assert live[:, 0].sum(-1).tolist() == [8, 7]


# -- the chunked twin against JAX ----------------------------------------------

def _assert_row_close(got, want):
    g = got.float().numpy()
    w = np.asarray(want, np.float32)
    limit = np.abs(w).max(-1, keepdims=True) * 2.0 ** -7 + 1e-5
    worst = float((np.abs(g - w) / limit).max())
    assert worst <= 1.0, f"{worst} x its bf16 row limit"


def _jax_window(q, k, v, pos, t):
    """JAX's reference at T rows (decode's at T = 1), pos a scalar or
    [B] vector."""
    if t == 1:
        return np.asarray(jdec.reference_decode_attention(
            jnp.asarray(q[:, 0]), jnp.asarray(k), jnp.asarray(v),
            jnp.asarray(pos), H))[:, None]
    pv = np.broadcast_to(np.asarray(pos, np.int32), (q.shape[0],))
    return np.asarray(jdec.reference_window_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(pv), H))


S_ODD = 2 * CH + 100   # three ranks, the last chunk ragged
POS_EDGES = [0, CH - 1, CH, CH + 1, S_ODD - 1, S_ODD - 3]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("pos", POS_EDGES,
                         ids=["0", "CH-1", "CH", "CH+1", "S-1", "S-3"])
@pytest.mark.parametrize("t", [1, 5, 8])
def test_chunked_twin_matches_jax(t, pos, dtype):
    q = _rand((B, t, H, DH), 10 + t)
    k, v = _rand((B, S_ODD, H * DH), 11), _rand((B, S_ODD, H * DH), 12)
    if dtype == "bfloat16":   # both sides see the same bf16 values
        q, k, v = (np.asarray(jnp.asarray(x, jnp.bfloat16), np.float32)
                   for x in (q, k, v))
    want = _jax_window(q, k, v, pos, t)
    tq, tk, tv = (torch.from_numpy(np.asarray(x, np.float32)).to(
        getattr(torch, dtype)) for x in (q, k, v))
    if t == 1:
        got = tdec.reference_chunked_decode_attention(tq[:, 0], tk, tv, pos,
                                                      H)[:, None]
    else:
        got = tdec.reference_chunked_window_attention(tq, tk, tv, pos, H)
    assert got.dtype == getattr(torch, dtype)
    assert got.shape == (B, t, H, DH)
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    else:
        _assert_row_close(got, want)


@pytest.mark.parametrize("t", [1, 5, 8])
def test_chunked_twin_stacked_cache_and_pos_vector(t):
    """A stacked [L, B, S, D] cache with a layer selected, S = 4200
    (rank 0 takes chunks 0 and 4096), each batch row at its own
    prefix."""
    s = 4200
    q = _rand((3, t, H, DH), 20)
    k, v = _rand((2, 3, s, H * DH), 21), _rand((2, 3, s, H * DH), 22)
    pos = np.array([4190, 0, 1500], np.int32)
    want = _jax_window(q, k[1], v[1], pos, t)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    tpos = torch.from_numpy(pos)
    if t == 1:
        got = tdec.reference_chunked_decode_attention(tq[:, 0], tk, tv, tpos,
                                                      H, layer=1)[:, None]
    else:
        got = tdec.reference_chunked_window_attention(tq, tk, tv, tpos, H,
                                                      layer=1)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def test_chunked_twin_equals_plain_twin_in_float32():
    """In float32 the rank split changes only the order of the sums: the
    chunked twin and the port's plain reference agree to 1e-5 at every
    position of a window that crosses two chunk edges."""
    s = S_ODD
    q = torch.from_numpy(_rand((B, 8, H, DH), 30))
    k = torch.from_numpy(_rand((B, s, H * DH), 31))
    v = torch.from_numpy(_rand((B, s, H * DH), 32))
    for pos in (CH - 4, 2 * CH - 4, torch.tensor([0, s - 3])):
        got = tdec.reference_chunked_window_attention(q, k, v, pos, H)
        want = tdec.reference_window_attention(q, k, v, pos, H)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                                   atol=1e-5)

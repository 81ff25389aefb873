"""Port parity: attention ops of deeplearning4j_tpu_torch vs the JAX package.

Same numpy inputs (fixed seeds) go through the JAX function and through
the port's plain PyTorch twin on the CPU. The flash forward and backward
run JAX's Pallas kernels in interpret mode, as
tests/test_flash_attention.py does; decode attention runs JAX's plain
reference path (`reference_decode_attention`, what `decode_attention`
dispatches to off the TPU), because the Pallas decode kernel does not
trace in interpret mode on this JAX version (tests/test_flash_decode.py
fails the same way). Tolerances: float32 1e-5 (the same f32 math summed in another
order), float64 1e-12.

The kernels themselves are held against these plain twins on the card by
tests/test_torch_kernels.py and chip_smoke.py.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from deeplearning4j_tpu.nn.layers import attention as jattn  # noqa: E402
from deeplearning4j_tpu.ops import flash_decode as jdec  # noqa: E402
from deeplearning4j_tpu.ops.flash_attention import (  # noqa: E402
    _flash_backward, _flash_forward)

from deeplearning4j_tpu_torch.nn.layers import attention as tattn  # noqa
from deeplearning4j_tpu_torch.ops import flash_attention as tfa  # noqa
from deeplearning4j_tpu_torch.ops import flash_decode as tdec  # noqa

F32 = dict(rtol=0, atol=1e-5)
F64 = dict(rtol=0, atol=1e-12)


@pytest.fixture()
def interpret_mode(monkeypatch):
    monkeypatch.setenv("DL4JTPU_FLASH", "interpret")


def _rand(shape, seed, dtype=np.float32):
    return np.random.default_rng(seed).normal(size=shape).astype(dtype)


# ---------------------------------------------------------------------------
# flash forward: plain twin vs JAX's Pallas kernel (interpret) -> (o, m, logl)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("causal,tq,sk,qo,ko", [
    (True, 128, 128, 0, 0),        # causal self-attention
    (False, 64, 96, 0, 0),         # full attention, S != T
    (True, 64, 128, 64, 0),        # q block after the kv block
    (True, 64, 64, 0, 32),         # kv_offset > q_offset: masked rows
    (True, 100, 100, 0, 0),        # T not a multiple of 128
    (True, 200, 200, 0, 0),        # ragged past one 128 tile
])
def test_flash_forward_plain_matches_jax(causal, tq, sk, qo, ko):
    bh, dh = 3, 16
    q, k, v = (_rand((bh, n, dh), s) for s, n in ((0, tq), (1, sk),
                                                  (2, sk)))
    scale = dh ** -0.5
    jo, jm, jl = _flash_forward(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), scale, causal, qo, ko,
                                interpret=True)
    o, m, logl = tfa.flash_forward_reference(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        scale, causal, qo, ko)
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), **F32)
    np.testing.assert_allclose(m.numpy(), np.asarray(jm), **F32)
    np.testing.assert_allclose(logl.numpy(), np.asarray(jl), **F32)
    if ko > qo:   # the first rows see no key at all: uniform average
        np.testing.assert_allclose(m.numpy()[:, 0, 0], -1e30, rtol=1e-6)
        np.testing.assert_allclose(logl.numpy()[:, 0, 0], np.log(sk),
                                   **F32)


@pytest.mark.parametrize("causal,tq,sk,qo,ko", [
    (True, 128, 128, 0, 0),        # causal self-attention
    (True, 64, 64, 0, 32),         # kv_offset > q_offset: masked rows
    (True, 64, 128, 64, 0),        # q block after the kv block
    (False, 64, 96, 0, 0),         # full attention, S != T
])
def test_flash_backward_plain_matches_jax(causal, tq, sk, qo, ko):
    """flash_backward_reference vs JAX's Pallas backward (interpret) on
    the same (q, k, v, o, m, logl, dO); 1e-5."""
    bh, dh = 3, 16
    q, k, v = (_rand((bh, n, dh), s) for s, n in ((40, tq), (41, sk),
                                                  (42, sk)))
    do = _rand((bh, tq, dh), 43)
    scale = dh ** -0.5
    jq, jk, jv, jdo = (jnp.asarray(x) for x in (q, k, v, do))
    jo, jm, jl = _flash_forward(jq, jk, jv, scale, causal, qo, ko,
                                interpret=True)
    want = _flash_backward(jq, jk, jv, jo, jm, jl, jdo, scale, causal, qo,
                           ko, interpret=True)
    o, m, logl = (torch.from_numpy(np.array(x)) for x in (jo, jm, jl))
    tdo = torch.from_numpy(do)
    delta = (tdo * o).sum(-1, keepdim=True)
    got = tfa.flash_backward_reference(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), tdo,
        m, logl, delta, scale, causal, qo, ko)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **F32)


# bf16: the roundings that the card's tensor-core tile fixes into its
# operand types (P to V's dtype, dS to q's) held against JAX's Pallas
# kernels in interpret mode, at Dh 64 on the float32 tests' shapes. JAX
# sums over 128-wide tiles and the twin over 64-wide ones, so the two may
# round an output element to neighbouring bf16 values: O is held per row
# to 2^-7 of the row's largest entry + 1e-5 (one bf16 ulp), the gradients
# to 2^-6 (one more for the roundings of P and dS inside the sums), and
# the float32 statistics m and log l to 1e-5.

def _row_rel_err(got, want, rtol):
    g, w = np.asarray(got, np.float32), np.asarray(want, np.float32)
    limit = np.abs(w).max(axis=-1, keepdims=True) * rtol + 1e-5
    return float((np.abs(g - w) / limit).max())


def _bf16(x):
    return jnp.asarray(x).astype(jnp.bfloat16), \
        torch.from_numpy(x).to(torch.bfloat16)


@pytest.mark.parametrize("causal,tq,sk,qo,ko", [
    (True, 128, 128, 0, 0),        # causal self-attention
    (False, 64, 96, 0, 0),         # full attention, S != T
    (True, 64, 128, 64, 0),        # q block after the kv block
    (True, 64, 64, 0, 32),         # kv_offset > q_offset: masked rows
    (True, 100, 100, 0, 0),        # T not a multiple of 128
    (True, 200, 200, 0, 0),        # ragged past one 128 tile
])
def test_flash_forward_plain_matches_jax_bf16(causal, tq, sk, qo, ko):
    bh, dh = 3, 64
    (jq, q), (jk, k), (jv, v) = (_bf16(_rand((bh, n, dh), s))
                                 for s, n in ((0, tq), (1, sk), (2, sk)))
    scale = dh ** -0.5
    jo, jm, jl = _flash_forward(jq, jk, jv, scale, causal, qo, ko,
                                interpret=True)
    o, m, logl = tfa.flash_forward_reference(q, k, v, scale, causal, qo, ko)
    assert o.dtype == torch.bfloat16
    assert _row_rel_err(o.float().numpy(), np.asarray(jo, np.float32),
                        2.0 ** -7) <= 1.0
    np.testing.assert_allclose(m.numpy(), np.asarray(jm), **F32)
    np.testing.assert_allclose(logl.numpy(), np.asarray(jl), **F32)


@pytest.mark.parametrize("causal,tq,sk,qo,ko", [
    (True, 128, 128, 0, 0),        # causal self-attention
    (True, 64, 64, 0, 32),         # kv_offset > q_offset: masked rows
    (True, 64, 128, 64, 0),        # q block after the kv block
    (False, 64, 96, 0, 0),         # full attention, S != T
])
def test_flash_backward_plain_matches_jax_bf16(causal, tq, sk, qo, ko):
    """flash_backward_reference vs JAX's Pallas backward (interpret) on
    the same bf16 (q, k, v, dO) and float32 (m, log l); 2^-6 per row."""
    bh, dh = 3, 64
    (jq, q), (jk, k), (jv, v), (jdo, do) = (
        _bf16(_rand((bh, n, dh), s))
        for s, n in ((40, tq), (41, sk), (42, sk), (43, tq)))
    scale = dh ** -0.5
    jo, jm, jl = _flash_forward(jq, jk, jv, scale, causal, qo, ko,
                                interpret=True)
    want = _flash_backward(jq, jk, jv, jo, jm, jl, jdo, scale, causal, qo,
                           ko, interpret=True)
    o = torch.from_numpy(np.asarray(jo, np.float32)).to(torch.bfloat16)
    m, logl = (torch.from_numpy(np.array(x)) for x in (jm, jl))
    delta = (do.float() * o.float()).sum(-1, keepdim=True)
    got = tfa.flash_backward_reference(q, k, v, do, m, logl, delta, scale,
                                       causal, qo, ko)
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        assert _row_rel_err(g.float().numpy(), np.asarray(w, np.float32),
                            2.0 ** -6) <= 1.0


def test_flash_attention_layout_matches_reference_attention():
    """[B, T, H, Dh] wrapper == the [B*H, T, Dh] plain reference."""
    b, t, h, dh = 2, 70, 4, 16
    q, k, v = (_rand((b, t, h, dh), s) for s in (3, 4, 5))
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    got = tfa.flash_attention(tq, tk, tv, causal=True)
    to3 = lambda x: x.permute(0, 2, 1, 3).reshape(b * h, t, dh)  # noqa
    want = tfa._reference_attention(to3(tq), to3(tk), to3(tv),
                                    dh ** -0.5, True, 0, 0)
    np.testing.assert_allclose(
        got.permute(0, 2, 1, 3).reshape(b * h, t, dh).numpy(),
        want.numpy(), **F32)


def test_flash_forward_refuses_gradients():
    """The raw (o, m, logl) forward records no graph (as the reference's
    `_flash_forward`); gradients go through `flash_attention`."""
    q = torch.ones(1, 8, 16, requires_grad=True)
    o, m, logl = tfa.flash_forward(q, q, q, 0.25, True)
    assert not (o.requires_grad or m.requires_grad or logl.requires_grad)
    out = tfa.flash_attention(q[:, :, None], q[:, :, None], q[:, :, None],
                              causal=True)
    assert out.requires_grad
    out.sum().backward()
    assert q.grad is not None and q.grad.shape == q.shape


# ---------------------------------------------------------------------------
# decode attention: plain twin vs JAX's plain reference path
# ---------------------------------------------------------------------------

def _decode_inputs(b=4, h=4, dh=16, s=128, layers=None, seed=0):
    d = h * dh
    shape = (b, s, d) if layers is None else (layers, b, s, d)
    return (_rand((b, h, dh), seed), _rand(shape, seed + 1),
            _rand(shape, seed + 2))


@pytest.mark.parametrize("pos", [0, 77, 127, [0, 5, 127, 64]])
def test_decode_attention_matches_jax(pos):
    q, k, v = _decode_inputs()
    jpos = jnp.asarray(pos, jnp.int32)
    want = jdec.reference_decode_attention(jnp.asarray(q), jnp.asarray(k),
                                           jnp.asarray(v), jpos, n_heads=4)
    tpos = torch.tensor(pos, dtype=torch.int32) if isinstance(pos, list) \
        else pos
    got = tdec.decode_attention(torch.from_numpy(q), torch.from_numpy(k),
                                torch.from_numpy(v), tpos, n_heads=4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


@pytest.mark.parametrize("layer", [0, 2])
def test_decode_attention_stacked_layer_matches_jax(layer):
    q, k, v = _decode_inputs(layers=3, seed=7)
    pos = [3, 127, 0, 90]
    want = jdec.decode_attention(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v),
                                 jnp.asarray(pos, jnp.int32), n_heads=4,
                                 layer=layer)
    got = tdec.decode_attention(torch.from_numpy(q), torch.from_numpy(k),
                                torch.from_numpy(v),
                                torch.tensor(pos, dtype=torch.int32),
                                n_heads=4, layer=layer)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


def test_decode_attention_refuses_quantized_kv():
    q, k, v = (torch.from_numpy(x) for x in _decode_inputs())
    with pytest.raises(NotImplementedError, match="A4"):
        tdec.decode_attention(q, k, v, 3, n_heads=4,
                              k_scale=torch.ones(4, 128),
                              v_scale=torch.ones(4, 128))


# ---------------------------------------------------------------------------
# dot_product_attention and layer_norm vs JAX
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype,tol", [(np.float32, F32),
                                       (np.float64, F64)])
@pytest.mark.parametrize("causal", [False, True])
def test_dot_product_attention_matches_jax(interpret_mode, dtype, tol,
                                           causal):
    """f32 reaches JAX's flash kernel (interpret); f64 its jnp path."""
    b, t, h, dh = 2, 24, 2, 8
    q, k, v = (_rand((b, t, h, dh), s, dtype) for s in (10, 11, 12))
    want = jattn.dot_product_attention(jnp.asarray(q), jnp.asarray(k),
                                       jnp.asarray(v), causal=causal,
                                       q_offset=0, kv_offset=0)
    got = tattn.dot_product_attention(torch.from_numpy(q),
                                      torch.from_numpy(k),
                                      torch.from_numpy(v), causal=causal)
    assert got.dtype == torch.from_numpy(q).dtype
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)


@pytest.mark.parametrize("causal", [False, True])
def test_dot_product_attention_gradients_match_jax(interpret_mode, causal):
    """d(sum(out * w))/d(q, k, v): the port's FlashAttention backward
    (plain twin on the CPU) vs jax.grad through JAX's Pallas backward in
    interpret mode; 1e-5."""
    b, t, h, dh = 2, 64, 2, 16
    q, k, v, w = (_rand((b, t, h, dh), s) for s in (13, 14, 15, 16))

    def jloss(q, k, v):
        return jnp.sum(jattn.dot_product_attention(
            q, k, v, causal=causal, q_offset=0, kv_offset=0) * w)

    want = jax.grad(jloss, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = tattn.dot_product_attention(*leaves, causal=causal)
    (out * torch.from_numpy(w)).sum().backward()
    for x, g in zip(leaves, want):
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(g), **F32)


def test_dot_product_attention_masked_matches_jax():
    b, t, h, dh = 2, 16, 2, 8
    q, k, v = (_rand((b, t, h, dh), s) for s in (20, 21, 22))
    mask = np.ones((b, t), np.float32)
    mask[0, 10:] = 0
    mask[1, :] = 0        # every key masked: uniform average
    want = jattn.dot_product_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
        mask=jnp.asarray(mask))
    got = tattn.dot_product_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=True, mask=torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


@pytest.mark.parametrize("dtype,tol", [(np.float32, F32),
                                       (np.float64, F64)])
def test_layer_norm_matches_jax(dtype, tol):
    x = _rand((3, 5, 32), 30, dtype) * 3 + 1
    g = _rand((32,), 31, dtype)
    bb = _rand((32,), 32, dtype)
    want = jattn.layer_norm(jnp.asarray(x), jnp.asarray(g), jnp.asarray(bb))
    got = tattn.layer_norm(torch.from_numpy(x), torch.from_numpy(g),
                           torch.from_numpy(bb))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)


# ---------------------------------------------------------------------------
# verify-window attention: plain twin vs JAX's reference_window_attention
# (what JAX's decode_window_attention dispatches to off the TPU; its Pallas
# window kernel does not trace in interpret mode on this JAX version)
# ---------------------------------------------------------------------------

def _window_inputs(t, b=4, h=4, dh=16, s=128, layers=None, seed=0):
    d = h * dh
    shape = (b, s, d) if layers is None else (layers, b, s, d)
    return (_rand((b, t, h, dh), seed), _rand(shape, seed + 1),
            _rand(shape, seed + 2))


@pytest.mark.parametrize("t,pos", [
    (1, [0, 5, 127, 64]),          # T=1: one decode row per batch row
    (5, [0, 5, 60, 64]),           # vector pos, every row inside S
    (5, [0, 124, 127, 126]),       # rows past S-1 clamp to S-1
    (5, 30),                       # scalar pos (JAX: the [B] broadcast)
])
def test_window_attention_matches_jax(t, pos):
    """1e-6: the same f32 math; JAX's einsum and the port's sum the
    Dh=16 products in other orders."""
    q, k, v = _window_inputs(t)
    want = jdec.reference_window_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        jnp.broadcast_to(jnp.asarray(pos, jnp.int32), (4,)), n_heads=4)
    tpos = torch.tensor(pos, dtype=torch.int32) if isinstance(pos, list) \
        else pos
    got = tdec.decode_window_attention(torch.from_numpy(q),
                                       torch.from_numpy(k),
                                       torch.from_numpy(v), tpos, n_heads=4)
    assert got.shape == (4, t, 4, 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)


@pytest.mark.parametrize("layer", [0, 2])
def test_window_attention_stacked_layer_matches_jax(layer):
    q, k, v = _window_inputs(5, layers=3, seed=7)
    pos = [3, 123, 0, 90]
    want = jdec.reference_window_attention(
        jnp.asarray(q), jnp.asarray(k[layer]), jnp.asarray(v[layer]),
        jnp.asarray(pos, jnp.int32), n_heads=4)
    got = tdec.decode_window_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.tensor(pos, dtype=torch.int32), n_heads=4, layer=layer)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)


def test_window_rows_match_decode_twin():
    """Row t of the window twin == the port's decode twin at pos + t
    (clamped at S-1), 1e-6 (a [T]-row and a 1-row einsum sum the same
    products in other orders on the CPU)."""
    q, k, v = (torch.from_numpy(x) for x in _window_inputs(6, seed=11))
    pos = torch.tensor([0, 40, 125, 127], dtype=torch.int32)
    got = tdec.reference_window_attention(q, k, v, pos, n_heads=4)
    for t in range(6):
        want = tdec.reference_decode_attention(
            q[:, t], k, v, torch.clamp(pos + t, max=127), n_heads=4)
        np.testing.assert_allclose(got[:, t].numpy(), want.numpy(), rtol=0,
                                   atol=1e-6)


def test_window_attention_refuses_quantized_kv():
    q, k, v = (torch.from_numpy(x) for x in _window_inputs(3))
    with pytest.raises(NotImplementedError, match="A4"):
        tdec.decode_window_attention(q, k, v, 3, n_heads=4,
                                     k_scale=torch.ones(4, 128),
                                     v_scale=torch.ones(4, 128))

"""The port's CUDA kernels against their plain PyTorch twins, on the card.

Every test here needs a CUDA device and skips without one (the decision is
taken inside the `requires_cuda` fixture, never at import). The file imports
nothing of JAX, so it also runs on a machine that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py

Tolerances: float32 1e-5 (same f32 math, other summation order); bfloat16
and float16 per output row, 2^-7 of the plain row's largest entry plus
1e-5 (one rounding of the output and of the probabilities, in the row's
own scale). The backward's half-precision gradients get two such units
(2^-6): one for the
rounding of the output, one for the bf16 roundings of P and dS that the
kernel and its twin may take to neighbouring values from float32 inputs
that differ in their last bits, summed over up to S products.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from deeplearning4j_tpu_torch.ops import flash_attention as tfa  # noqa
from deeplearning4j_tpu_torch.ops import flash_decode as tdec  # noqa

F32 = dict(rtol=0, atol=1e-5)
F32_BWD = dict(rtol=1e-5, atol=1e-5)

pytestmark = pytest.mark.cuda


def _assert_close(got, want, dtype, row_rtol=2.0 ** -7):
    g, w = got.float().cpu(), want.float().cpu()
    if dtype == torch.float32:
        np.testing.assert_allclose(g.numpy(), w.numpy(), **F32)
        return
    limit = w.abs().amax(dim=-1, keepdim=True) * row_rtol + 1e-5
    worst = float(((g - w).abs() / limit).max())
    assert worst <= 1.0, f"bf16 error {worst} x its per-row limit"


@pytest.fixture()
def requires_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernel vs plain runs on the card)")
    return torch.device("cuda")


def _rand(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("dh", [32, 64, 128])
@pytest.mark.parametrize("causal,tq,sk,qo,ko", [
    (True, 100, 100, 0, 0),       # ragged tail inside one tile
    (True, 64, 64, 0, 32),        # kv_offset > q_offset: masked rows
    (True, 130, 200, 70, 0),      # causal skip with q after kv
    (False, 77, 150, 0, 0),       # full attention, S != T
])
def test_flash_kernel_matches_plain_on_card(requires_cuda, dh, causal, tq,
                                            sk, qo, ko):
    q, k, v = (torch.from_numpy(_rand((3, n, dh), s)).to(requires_cuda)
               for s, n in ((40, tq), (41, sk), (42, sk)))
    before = tfa.flash_forward_cuda.launches
    got = tfa.flash_forward(q, k, v, dh ** -0.5, causal, qo, ko)
    want = tfa.flash_forward_reference(q, k, v, dh ** -0.5, causal, qo, ko)
    torch.cuda.synchronize()
    assert tfa.flash_forward_cuda.launches == before + 1
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(),
                                   rtol=1e-6, atol=1e-5)


# the half-precision path (the tensor-core tile): bf16 and f16 over the
# float32 tests' odd shapes, every head dim, plus the aligned causal case
HALF_DTYPES = [torch.bfloat16, torch.float16]


@pytest.mark.parametrize("dtype", HALF_DTYPES)
@pytest.mark.parametrize("dh", [32, 64, 128])
@pytest.mark.parametrize("causal,tq,sk,qo,ko", [
    (True, 300, 300, 0, 0),       # aligned causal self-attention
    (True, 100, 100, 0, 0),       # ragged tail inside one tile
    (True, 64, 64, 0, 32),        # kv_offset > q_offset: masked rows
    (True, 130, 200, 70, 0),      # causal skip with q after kv
    (False, 77, 150, 0, 0),       # full attention, S != T
])
def test_flash_kernel_bf16_on_card(requires_cuda, dtype, dh, causal, tq, sk,
                                   qo, ko):
    q, k, v = (torch.from_numpy(_rand((4, n, dh), s)).to(requires_cuda, dtype)
               for s, n in ((50, tq), (51, sk), (52, sk)))
    scale = dh ** -0.5
    o, m, logl = tfa.flash_forward(q, k, v, scale, causal, qo, ko)
    ro, rm, rl = tfa.flash_forward_reference(q, k, v, scale, causal, qo, ko)
    assert o.dtype == dtype
    _assert_close(o, ro, dtype)
    np.testing.assert_allclose(m.cpu().numpy(), rm.cpu().numpy(), **F32)
    np.testing.assert_allclose(logl.cpu().numpy(), rl.cpu().numpy(), **F32)


# every dtype of the decode and window kernels: float32 is the SIMT row
# loop, bf16 and f16 the tensor-core split-S core (csrc/decode_tc.cuh)
DECODE_DTYPES = [torch.float32, torch.float16, torch.bfloat16]
CH = tdec.DECODE_CH
# S = 2*CH + 100: three cluster ranks, the last chunk ragged; the
# positions sit on chunk edges and at the clamp
S_EDGES = 2 * CH + 100
POS_EDGES = [0, CH - 1, CH, CH + 1, 2 * CH, S_EDGES - 1]


@pytest.mark.parametrize("dtype", DECODE_DTYPES)
@pytest.mark.parametrize("dh", [32, 64, 128])
def test_decode_kernel_matches_plain_on_card(requires_cuda, dtype, dh):
    """The decode kernel against its plain twin and (bf16 / f16) its
    chunked twin at positions on chunk edges, on the stacked cache's
    layer 1 with a pos vector, and at a scalar pos on layer 0."""
    b, h, s = 6, 2, S_EDGES
    dev = requires_cuda
    q = torch.from_numpy(_rand((b, h, dh), 60)).to(dev, dtype)
    k = torch.from_numpy(_rand((2, b, s, h * dh), 61)).to(dev, dtype)
    v = torch.from_numpy(_rand((2, b, s, h * dh), 62)).to(dev, dtype)
    pos = torch.tensor(POS_EDGES, dtype=torch.int32, device=dev)
    before = tdec.decode_attention_cuda.launches
    got = tdec.decode_attention(q, k, v, pos, n_heads=h, layer=1)
    want = tdec.reference_decode_attention(q, k[1], v[1], pos, n_heads=h)
    torch.cuda.synchronize()
    assert tdec.decode_attention_cuda.launches == before + 1
    _assert_close(got, want, dtype)
    _assert_close(got, tdec.reference_chunked_decode_attention(
        q, k, v, pos, h, layer=1), dtype)
    for p in (123, CH, S_EDGES + 5):
        got_s = tdec.decode_attention(q, k, v, p, n_heads=h, layer=0)
        want_s = tdec.reference_decode_attention(q, k[0], v[0], p,
                                                 n_heads=h)
        _assert_close(got_s, want_s, dtype)


def _bwd_inputs(dev, dtype, tq, sk, dh, causal, qo, ko, seed=70):
    q, k, v = (torch.from_numpy(_rand((3, n, dh), seed + i)).to(dev, dtype)
               for i, n in enumerate((tq, sk, sk)))
    do = torch.from_numpy(_rand((3, tq, dh), seed + 3)).to(dev, dtype)
    o, m, logl = tfa.flash_forward_reference(q, k, v, dh ** -0.5, causal,
                                             qo, ko)
    delta = (do.float() * o.float()).sum(-1, keepdim=True)
    return q, k, v, do, m, logl, delta


@pytest.mark.parametrize("dh", [32, 64, 128])
@pytest.mark.parametrize("causal,tq,sk,qo,ko", [
    (True, 100, 100, 0, 0),       # ragged tail inside one tile
    (True, 64, 96, 0, 32),        # kv_offset > q_offset: masked rows
    (True, 130, 200, 70, 0),      # causal skip with q after kv
    (False, 77, 150, 0, 0),       # full attention, S != T
])
def test_flash_backward_kernel_matches_plain_on_card(requires_cuda, dh,
                                                     causal, tq, sk, qo,
                                                     ko):
    args = _bwd_inputs(requires_cuda, torch.float32, tq, sk, dh, causal,
                       qo, ko)
    before = tfa.flash_backward_cuda.launches
    got = tfa.flash_backward(*args, dh ** -0.5, causal, qo, ko)
    want = tfa.flash_backward_reference(*args, dh ** -0.5, causal, qo, ko)
    torch.cuda.synchronize()
    assert tfa.flash_backward_cuda.launches == before + 1
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(),
                                   **F32_BWD)


@pytest.mark.parametrize("dtype", HALF_DTYPES)
@pytest.mark.parametrize("dh", [32, 64, 128])
@pytest.mark.parametrize("causal,tq,sk,qo,ko", [
    (True, 300, 300, 0, 0),       # aligned causal self-attention
    (True, 100, 100, 0, 0),       # ragged tail inside one tile
    (True, 64, 96, 0, 32),        # kv_offset > q_offset: masked rows
    (True, 130, 200, 70, 0),      # causal skip with q after kv
    (False, 77, 150, 0, 0),       # full attention, S != T
])
def test_flash_backward_kernel_bf16_on_card(requires_cuda, dtype, dh, causal,
                                            tq, sk, qo, ko):
    args = _bwd_inputs(requires_cuda, dtype, tq, sk, dh, causal, qo, ko)
    got = tfa.flash_backward(*args, dh ** -0.5, causal, qo, ko)
    want = tfa.flash_backward_reference(*args, dh ** -0.5, causal, qo, ko)
    for a, b in zip(got, want):
        assert a.dtype == dtype
        _assert_close(a, b, dtype, row_rtol=2.0 ** -6)


@pytest.mark.parametrize("causal,qo,ko", [(True, 0, 0), (True, 0, 40),
                                          (False, 0, 0)])
def test_flash_attention_gradients_on_card(requires_cuda, causal, qo, ko):
    """Gradients through the kernel-backed autograd.Function == autograd
    through the plain reference attention, float32 on the card
    (1e-4: two algorithms, f32 sums in other orders)."""
    b, t, h, dh = 2, 90, 3, 32
    dev = requires_cuda
    q, k, v, w = (torch.from_numpy(_rand((b, t, h, dh), s)).to(dev)
                  for s in (80, 81, 82, 83))

    def to3(x):
        return x.permute(0, 2, 1, 3).reshape(b * h, t, dh)

    def grads(fn):
        leaves = [x.clone().requires_grad_() for x in (q, k, v)]
        (fn(*leaves) * w).sum().backward()
        return [x.grad for x in leaves]

    f_before = tfa.flash_forward_cuda.launches
    b_before = tfa.flash_backward_cuda.launches
    got = grads(lambda a, bb, c: tfa.flash_attention(
        a, bb, c, causal=causal, q_offset=qo, kv_offset=ko))
    torch.cuda.synchronize()
    assert tfa.flash_forward_cuda.launches == f_before + 1
    assert tfa.flash_backward_cuda.launches == b_before + 1
    want = grads(lambda a, bb, c: tfa._reference_attention(
        to3(a), to3(bb), to3(c), dh ** -0.5, causal, qo, ko).reshape(
            b, h, t, dh).permute(0, 2, 1, 3))
    for a, bb in zip(got, want):
        np.testing.assert_allclose(a.cpu().numpy(), bb.cpu().numpy(),
                                   rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("causal,qo,ko", [(True, 0, 0), (True, 0, 40),
                                          (False, 0, 0)])
def test_flash_attention_gradients_bf16_on_card(requires_cuda, causal, qo,
                                                ko):
    """bf16 gradients through the `FlashAttention` autograd.Function: the
    kernels on the card against the same Function on the CPU, where it
    runs the plain twins; per row to 2^-6 (the backward's bf16 limit)."""
    b, t, h, dh = 2, 90, 3, 64
    q, k, v, w = (torch.from_numpy(_rand((b, t, h, dh), s)).to(torch.bfloat16)
                  for s in (84, 85, 86, 87))

    def grads(dev):
        leaves = [x.to(dev).requires_grad_() for x in (q, k, v)]
        out = tfa.flash_attention(*leaves, causal=causal, q_offset=qo,
                                  kv_offset=ko)
        (out.float() * w.to(dev).float()).sum().backward()
        return [x.grad for x in leaves]

    before = tfa.flash_backward_cuda.launches
    got = grads(requires_cuda)
    torch.cuda.synchronize()
    assert tfa.flash_backward_cuda.launches == before + 1
    for a, bb in zip(got, grads(torch.device("cpu"))):
        assert a.dtype == torch.bfloat16
        _assert_close(a, bb, torch.bfloat16, row_rtol=2.0 ** -6)


def test_flash_kernels_deterministic_on_card(requires_cuda):
    """No atomics: two calls on the same inputs give the same bits."""
    args = _bwd_inputs(requires_cuda, torch.bfloat16, 512, 512, 64, True, 0,
                       0)
    args = [torch.cat([a, a.flip(0)]) for a in args]
    q, k, v = args[:3]
    for fn, inputs in ((tfa.flash_forward_cuda, (q, k, v, 0.125, True)),
                       (tfa.flash_backward_cuda, (*args, 0.125, True)),
                       (tfa.packed2_backward_cuda, (*args, 0.125, True))):
        first, second = fn(*inputs), fn(*inputs)
        assert all(torch.equal(a, b) for a, b in zip(first, second)), fn


def test_flash_kernels_refuse_unaligned_pointers_on_card(requires_cuda):
    """cp.async takes 16-byte aligned rows: a view at an odd offset raises."""
    flat = torch.zeros(2 * 8 * 64 + 1, device=requires_cuda,
                       dtype=torch.bfloat16)
    q = flat[1:].view(2, 8, 64)
    ok = torch.zeros(2, 8, 64, device=requires_cuda, dtype=torch.bfloat16)
    st = torch.zeros(2, 8, 1, device=requires_cuda)
    with pytest.raises(ValueError, match="16-byte aligned"):
        tfa.flash_forward(q, ok, ok, 0.1, True)
    with pytest.raises(ValueError, match="16-byte aligned"):
        tfa.flash_backward(q, ok, ok, ok, st, st, st, 0.1, True)
    with pytest.raises(ValueError, match="16-byte aligned"):
        tfa.packed2_backward_cuda(q, ok, ok, ok, st, st, st, 0.1, True)


def test_flash_kernels_take_element_aligned_f32_and_statistics_on_card(
        requires_cuda):
    """Only the half-precision q, k, v and dO go through 16-byte cp.async:
    float32 inputs and the statistics at a 4-byte offset still launch and
    agree with the plain twins."""
    g = torch.Generator().manual_seed(3)

    def odd(*shape, dtype=torch.float32):
        n = int(np.prod(shape))
        flat = torch.randn(n + 1, generator=g).to(requires_cuda, dtype)
        return flat[1:].view(*shape)

    q, k, v = (odd(2, 40, 64) for _ in range(3))
    o, m, logl = tfa.flash_forward(q, k, v, 0.125, True)
    ro, rm, rl = tfa.flash_forward_reference(q, k, v, 0.125, True)
    torch.testing.assert_close(o, ro, **F32)
    args = _bwd_inputs(requires_cuda, torch.bfloat16, 64, 64, 64, True, 0, 0)
    stats = [odd(*a.shape).copy_(a) for a in args[4:]]
    got = tfa.flash_backward(*args[:4], *stats, 0.125, True)
    want = tfa.flash_backward(*args, 0.125, True)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_kernels_refuse_unsupported_inputs_on_card(requires_cuda):
    q = torch.zeros(2, 8, 48, device=requires_cuda)
    with pytest.raises(ValueError, match="head dim"):
        tfa.flash_forward(q, q, q, 0.1, True)
    with pytest.raises(TypeError):
        tfa.flash_forward(q.double(), q.double(), q.double(), 0.1, True)
    st = torch.zeros(2, 8, 1, device=requires_cuda)
    with pytest.raises(ValueError, match="head dim"):
        tfa.flash_backward(q, q, q, q, st, st, st, 0.1, True)
    q2 = torch.zeros(2, 8, 64, device=requires_cuda)
    with pytest.raises(ValueError, match="logl"):
        tfa.flash_backward(q2, q2, q2, q2, st, st.double(), st, 0.1, True)
    qd = torch.zeros(2, 2, 48, device=requires_cuda)
    cache = torch.zeros(2, 16, 96, device=requires_cuda)
    with pytest.raises(ValueError, match="head dim"):
        tdec.decode_attention(qd, cache, cache, 3, n_heads=2)


@pytest.mark.parametrize("dtype", DECODE_DTYPES)
@pytest.mark.parametrize("dh", [32, 64, 128])
@pytest.mark.parametrize("t", [1, 2, 3, 4, 5, 6, 7, 8, 9, 16, 17])
def test_window_kernel_matches_plain_and_decode_on_card(requires_cuda,
                                                        dtype, dh, t):
    """The verify-window kernel against its plain twin (the tolerances
    above; T=9 spans two float32 CTA groups of 8, T=17 two bf16 / f16
    row tiles of 16), with positions on chunk edges and the clamp at
    S-1, and each window row bitwise against the decode kernel at
    pos + t."""
    b, h, s = 6, 2, S_EDGES
    dev = requires_cuda
    q = torch.from_numpy(_rand((b, t, h, dh), 90)).to(dev, dtype)
    k = torch.from_numpy(_rand((2, b, s, h * dh), 91)).to(dev, dtype)
    v = torch.from_numpy(_rand((2, b, s, h * dh), 92)).to(dev, dtype)
    pos = torch.tensor(POS_EDGES, dtype=torch.int32, device=dev) - t // 2
    before = tdec.decode_window_attention_cuda.launches
    got = tdec.decode_window_attention(q, k, v, pos, n_heads=h, layer=1)
    want = tdec.reference_window_attention(q, k[1], v[1], pos, n_heads=h)
    torch.cuda.synchronize()
    assert tdec.decode_window_attention_cuda.launches == before + 1
    _assert_close(got, want, dtype)
    _assert_close(got, tdec.reference_chunked_window_attention(
        q, k, v, pos, h, layer=1), dtype)
    for ti in range(t):
        row = tdec.decode_attention(q[:, ti], k, v, pos + ti, n_heads=h,
                                    layer=1)
        assert torch.equal(got[:, ti], row), f"window row {ti}"
    got_s = tdec.decode_window_attention(q, k, v, 150, n_heads=h, layer=0)
    want_s = tdec.reference_window_attention(q, k[0], v[0], 150, n_heads=h)
    _assert_close(got_s, want_s, dtype)


@pytest.mark.parametrize("dtype", DECODE_DTYPES)
def test_decode_and_window_kernels_deterministic_on_card(requires_cuda,
                                                         dtype):
    """Two calls on the same inputs give equal bits (fixed merge orders,
    no atomics), and at the serving shape (S = 2048, eight cluster ranks)
    every window row equals the decode kernel at pos + t."""
    b, h, dh, s, t = 8, 4, 64, 2048, 8
    dev = requires_cuda
    q = torch.from_numpy(_rand((b, t, h, dh), 80)).to(dev, dtype)
    k = torch.from_numpy(_rand((b, s, h * dh), 81)).to(dev, dtype)
    v = torch.from_numpy(_rand((b, s, h * dh), 82)).to(dev, dtype)
    pos = torch.tensor([0, 255, 256, 1000, 1791, 1792, 2040, 2047],
                       dtype=torch.int32, device=dev)
    w1 = tdec.decode_window_attention(q, k, v, pos, n_heads=h)
    w2 = tdec.decode_window_attention(q, k, v, pos, n_heads=h)
    d1 = tdec.decode_attention(q[:, 0], k, v, pos, n_heads=h)
    d2 = tdec.decode_attention(q[:, 0], k, v, pos, n_heads=h)
    torch.cuda.synchronize()
    assert torch.equal(w1, w2) and torch.equal(d1, d2)
    for ti in range(t):
        row = tdec.decode_attention(q[:, ti], k, v, pos + ti, n_heads=h)
        assert torch.equal(w1[:, ti], row), f"window row {ti}"


def test_decode_kernels_refuse_another_split_on_card(requires_cuda):
    """The C entry points take the wrappers' (CH, cluster) and refuse any
    other split than the one they were built with."""
    from deeplearning4j_tpu_torch.ops import _build
    dev = requires_cuda
    q = torch.zeros(2, 2, 64, device=dev, dtype=torch.bfloat16)
    cache = torch.zeros(2, 600, 128, device=dev, dtype=torch.bfloat16)
    o = torch.empty_like(q)
    fn = _build.load("decode_attention")
    args = (q.data_ptr(), cache.data_ptr(), cache.data_ptr(), o.data_ptr(),
            None, 5, 2, 2, 64, 600, _build.DTYPE_BF16, 0.125)
    stream = _build.stream_ptr(dev)
    assert fn(*args, CH, tdec.decode_cluster(600), stream) == 0
    assert fn(*args, CH // 2, tdec.decode_cluster(600), stream) != 0
    assert fn(*args, CH, tdec.decode_cluster(600) + 1, stream) != 0
    torch.cuda.synchronize()


def test_window_kernel_refuses_unsupported_inputs_on_card(requires_cuda):
    q = torch.zeros(2, 3, 2, 48, device=requires_cuda)
    cache = torch.zeros(2, 16, 96, device=requires_cuda)
    with pytest.raises(ValueError, match="head dim"):
        tdec.decode_window_attention(q, cache, cache, 3, n_heads=2)
    q = torch.zeros(2, 3, 2, 32, device=requires_cuda)
    with pytest.raises(TypeError):
        tdec.decode_window_attention(q.half(), cache[..., :64],
                                     cache[..., :64], 3, n_heads=2)


# -- the quantized decode and window entries (int8 / e4m3 cache) ----------
# The cache is quantize_rows of float rows, so kernel and twin read the same
# one-byte values and scales; both compute in float32 and differ only in
# summation order: float32 outputs within 1e-5, bf16 / f16 per row within
# 2^-7 (one rounding of the output).

QUANT_CACHES = ["int8", "fp8"]


def _quant_cache(shape, seed, kv_mode, dev):
    from deeplearning4j_tpu_torch.quant.kv import quantize_rows
    return quantize_rows(torch.from_numpy(_rand(shape, seed)).to(dev),
                         kv_mode)


@pytest.mark.parametrize("dtype", DECODE_DTYPES)
@pytest.mark.parametrize("kv_mode", QUANT_CACHES)
@pytest.mark.parametrize("dh", [32, 64, 128])
def test_quantized_decode_kernel_matches_plain_on_card(requires_cuda, dtype,
                                                       kv_mode, dh):
    """The quantized decode entry against the scaled twin on the stacked
    cache's layer 1 with its stacked [L, B, S, 1] scales and a pos vector,
    and at scalar positions with [B, S] scales on layer 0."""
    b, h, s = 6, 2, S_EDGES
    dev = requires_cuda
    q = torch.from_numpy(_rand((b, h, dh), 160)).to(dev, dtype)
    k, ks = _quant_cache((2, b, s, h * dh), 161, kv_mode, dev)
    v, vs = _quant_cache((2, b, s, h * dh), 162, kv_mode, dev)
    assert k.dtype == (torch.int8 if kv_mode == "int8"
                       else torch.float8_e4m3fn)
    ks4, vs4 = ks[..., None].contiguous(), vs[..., None].contiguous()
    pos = torch.tensor(POS_EDGES, dtype=torch.int32, device=dev)
    before = (tdec.decode_attention_q_cuda.launches,
              tdec.decode_attention_cuda.launches)
    got = tdec.decode_attention(q, k, v, pos, n_heads=h, layer=1,
                                k_scale=ks4, v_scale=vs4)
    want = tdec.reference_decode_attention(q, k[1], v[1], pos, n_heads=h,
                                           k_scale=ks[1], v_scale=vs[1])
    torch.cuda.synchronize()
    assert (tdec.decode_attention_q_cuda.launches,
            tdec.decode_attention_cuda.launches) == (before[0] + 1,
                                                     before[1])
    _assert_close(got, want, dtype)
    for p in (123, CH, S_EDGES + 5):
        got_s = tdec.decode_attention(q, k[0], v[0], p, n_heads=h,
                                      k_scale=ks[0].contiguous(),
                                      v_scale=vs[0].contiguous())
        want_s = tdec.reference_decode_attention(
            q, k[0], v[0], p, n_heads=h, k_scale=ks[0], v_scale=vs[0])
        _assert_close(got_s, want_s, dtype)


@pytest.mark.parametrize("dtype", DECODE_DTYPES)
@pytest.mark.parametrize("kv_mode", QUANT_CACHES)
@pytest.mark.parametrize("t", [1, 3, 4, 5, 8, 9])
def test_quantized_window_kernel_matches_plain_and_decode_on_card(
        requires_cuda, dtype, kv_mode, t):
    """The quantized window entry against the scaled twin (T=5 and 9
    span two and three CTA groups of 4) and each window row bitwise
    against the quantized decode kernel at pos + t."""
    b, h, dh, s = 6, 2, 64, S_EDGES
    dev = requires_cuda
    q = torch.from_numpy(_rand((b, t, h, dh), 190)).to(dev, dtype)
    k, ks = _quant_cache((2, b, s, h * dh), 191, kv_mode, dev)
    v, vs = _quant_cache((2, b, s, h * dh), 192, kv_mode, dev)
    ks4, vs4 = ks[..., None].contiguous(), vs[..., None].contiguous()
    pos = torch.tensor(POS_EDGES, dtype=torch.int32, device=dev) - t // 2
    before = tdec.decode_window_attention_q_cuda.launches
    got = tdec.decode_window_attention(q, k, v, pos, n_heads=h, layer=1,
                                       k_scale=ks4, v_scale=vs4)
    want = tdec.reference_window_attention(q, k[1], v[1], pos, n_heads=h,
                                           k_scale=ks[1], v_scale=vs[1])
    torch.cuda.synchronize()
    assert tdec.decode_window_attention_q_cuda.launches == before + 1
    _assert_close(got, want, dtype)
    for ti in range(t):
        row = tdec.decode_attention(q[:, ti], k, v, pos + ti, n_heads=h,
                                    layer=1, k_scale=ks4, v_scale=vs4)
        assert torch.equal(got[:, ti], row), f"window row {ti}"


@pytest.mark.parametrize("kv_mode", QUANT_CACHES)
def test_quantized_kernels_deterministic_on_card(requires_cuda, kv_mode):
    """Two calls give equal bits, and a [B, S] scale plane reads as the
    stacked plane's layer does (a pointer offset, not a copy)."""
    b, h, dh, s, t = 8, 4, 64, 2048, 8
    dev = requires_cuda
    q = torch.from_numpy(_rand((b, t, h, dh), 180)).to(dev, torch.bfloat16)
    k, ks = _quant_cache((3, b, s, h * dh), 181, kv_mode, dev)
    v, vs = _quant_cache((3, b, s, h * dh), 182, kv_mode, dev)
    ks4, vs4 = ks[..., None].contiguous(), vs[..., None].contiguous()
    pos = torch.tensor([0, 255, 256, 1000, 1791, 1792, 2040, 2047],
                       dtype=torch.int32, device=dev)
    kw = dict(n_heads=h, layer=2, k_scale=ks4, v_scale=vs4)
    w1 = tdec.decode_window_attention(q, k, v, pos, **kw)
    w2 = tdec.decode_window_attention(q, k, v, pos, **kw)
    d1 = tdec.decode_attention(q[:, 0], k, v, pos, **kw)
    d2 = tdec.decode_attention(q[:, 0], k, v, pos, **kw)
    d3 = tdec.decode_attention(q[:, 0], k[2], v[2], pos, n_heads=h,
                               k_scale=ks[2].contiguous(),
                               v_scale=vs[2].contiguous())
    torch.cuda.synchronize()
    assert torch.equal(w1, w2) and torch.equal(d1, d2)
    assert torch.equal(d1, d3)


def test_quantized_kernels_refuse_unsupported_inputs_on_card(requires_cuda):
    dev = requires_cuda
    q = torch.zeros(2, 2, 64, device=dev)
    k, ks = _quant_cache((2, 16, 128), 170, "int8", dev)
    with pytest.raises(ValueError, match="both"):
        tdec.decode_attention(q, k, k, 3, n_heads=2, k_scale=ks)
    with pytest.raises(ValueError, match="int8 or float8"):
        tdec.decode_attention(q, k.float(), k.float(), 3, n_heads=2,
                              k_scale=ks, v_scale=ks)
    with pytest.raises(ValueError, match="int8 or float8"):
        tdec.decode_attention(q, k, k, 3, n_heads=2)
    with pytest.raises(ValueError, match="float32"):
        tdec.decode_attention(q, k, k, 3, n_heads=2, k_scale=ks.half(),
                              v_scale=ks.half())
    with pytest.raises(ValueError, match=r"\[B, S\]"):
        tdec.decode_attention(q, k, k, 3, n_heads=2,
                              k_scale=ks[:, :8].contiguous(),
                              v_scale=ks[:, :8].contiguous())
    with pytest.raises(TypeError):
        tdec.decode_attention(q.double(), k, k, 3, n_heads=2, k_scale=ks,
                              v_scale=ks)
    q48 = torch.zeros(2, 3, 2, 48, device=dev)
    k96, ks96 = _quant_cache((2, 16, 96), 171, "int8", dev)
    with pytest.raises(ValueError, match="head dim"):
        tdec.decode_window_attention(q48, k96, k96, 3, n_heads=2,
                                     k_scale=ks96, v_scale=ks96)


# -- the fused LSTM scan (csrc/lstm_scan.cu) -------------------------------
# Kernel and twin cast the same inputs to float32 at the same points and
# differ only in the order of the recurrent product's sum, so float32 and
# bfloat16 inputs alike are held to 1e-5 + 1e-5 |plain| on hs, cs and gates.
# xw is drawn at the scale of the char-RNN's input projections (std 0.5):
# the recurrence carries each step's rounding into the next, and at std 1
# over T=64 the float32 twin alone drifts from a float64 run by up to 0.73
# of that limit (B=1024, H=200, measured on the CPU), so two float32
# summation orders can land a limit apart there.

LSTM_TOL = dict(rtol=1e-5, atol=1e-5)


def _lstm_inputs(t, b, h, x_dtype, w_dtype, dev, seed=0):
    xw = (0.5 * torch.from_numpy(_rand((t, b, 4 * h), seed))).to(
        dev, x_dtype)
    h0, c0 = ((0.5 * torch.from_numpy(_rand((b, h), seed + i))).to(
        dev, x_dtype) for i in (1, 2))
    rw = (h ** -0.5 * torch.from_numpy(_rand((h, 4 * h), seed + 3))).to(
        dev, w_dtype)
    rest = [(0.3 * torch.from_numpy(_rand((n,), seed + 4 + i))).to(
        dev, w_dtype) for i, n in enumerate((4 * h, h, h, h))]
    return [xw, h0, c0, rw] + rest


@pytest.mark.parametrize("t,b,h", [(64, 1024, 200), (7, 5, 37), (1, 1, 200),
                                   (3, 13, 300), (2, 3, 1100)])
@pytest.mark.parametrize("x_dtype,w_dtype", [
    (torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
    (torch.bfloat16, torch.float32)])
def test_lstm_scan_kernel_matches_plain_on_card(requires_cuda, t, b, h,
                                                x_dtype, w_dtype):
    args = _lstm_inputs(t, b, h, x_dtype, w_dtype, requires_cuda)
    from deeplearning4j_tpu_torch.ops import lstm as tlstm
    # a bf16 RW takes the tensor-core kernel at these H; float32 RW
    # and H = 1100 the SIMT kernel
    variant = "tc" if w_dtype == torch.bfloat16 and h <= 352 else "simt"
    counter = f"launches_{variant}"
    before = tlstm.lstm_scan_cuda.launches
    before_v = getattr(tlstm.lstm_scan_cuda, counter)
    got = tlstm.lstm_scan(*args)
    want = tlstm.lstm_scan_reference(*args)
    torch.cuda.synchronize()
    assert tlstm.lstm_scan_cuda.launches == before + 1
    assert getattr(tlstm.lstm_scan_cuda, counter) == before_v + 1
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(),
                                   **LSTM_TOL)


# The tensor-core variant (csrc/lstm_scan_tc.cuh): a bf16 RW at H up to
# 352 (every smaller H takes it too, tests/test_torch_lstm.py), held to
# the exact function: the plain twin in float64. Where the plain float32
# twin is within the 1e-5 + 1e-5 |exact| limit, the kernel must be too;
# where it is not, the kernel must be no farther from the exact function
# than the float32 twin. At H = 352, T = 64 these inputs make the
# recurrence amplify float32 rounding past the limit: on an H100 the
# float32 twin lands 1.76x the limit from float64 and the kernel 0.87x
# (two float32 twins that differ only in summation order, plain and split,
# 1.82x apart), so a direct float32-vs-float32 gate would measure the
# conditioning, not the kernel.


def _rel_to(got, exact):
    g, e = got.double().cpu(), exact.double().cpu()
    return float(((g - e).abs() / (1e-5 + 1e-5 * e.abs())).max())


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("t", [1, 7, 64])
@pytest.mark.parametrize("b", [1, 5, 33, 1024])
@pytest.mark.parametrize("h", [37, 200, 256, 352])
def test_lstm_scan_tc_kernel_matches_plain_on_card(requires_cuda, h, b, t,
                                                   reverse):
    from deeplearning4j_tpu_torch.ops import lstm as tlstm
    args = _lstm_inputs(t, b, h, torch.bfloat16, torch.bfloat16,
                        requires_cuda, seed=h + b + t)
    if reverse:
        args[0] = args[0].flip(0).contiguous()
    k = tlstm.lstm_scan_cuda
    before = (k.launches, k.launches_tc, k.launches_simt)
    got = tlstm.lstm_scan(*args)
    plain = tlstm.lstm_scan_reference(*args)
    exact = tlstm.lstm_scan_reference(*args, dtype=torch.float64)
    torch.cuda.synchronize()
    assert (k.launches, k.launches_tc, k.launches_simt) == (
        before[0] + 1, before[1] + 1, before[2])
    for g, p, e in zip(got, plain, exact):
        assert g.dtype == torch.float32
        err, err_plain = _rel_to(g, e), _rel_to(p, e)
        assert err <= max(1.0, err_plain), (
            f"kernel {err} x the limit from float64, float32 twin "
            f"{err_plain}")


def test_lstm_scan_tc_kernel_refuses_unaligned_xw_on_card(requires_cuda):
    """The tensor-core kernel reads xw by 8-byte cp.async: a bf16 xw at a
    2-byte offset raises before any launch; the SIMT kernel takes it."""
    from deeplearning4j_tpu_torch.ops import lstm as tlstm
    args = _lstm_inputs(7, 5, 36, torch.bfloat16, torch.bfloat16,
                        requires_cuda, seed=13)
    flat = torch.zeros(args[0].numel() + 1, device=requires_cuda,
                       dtype=torch.bfloat16)
    xw = flat[1:].view_as(args[0])
    xw.copy_(args[0])
    k = tlstm.lstm_scan_cuda
    before = (k.launches, k.launches_tc)
    with pytest.raises(ValueError, match="8-byte"):
        tlstm.lstm_scan(xw, *args[1:])
    assert (k.launches, k.launches_tc) == before
    got = k(xw, *args[1:], variant="simt")
    want = tlstm.lstm_scan_reference(xw, *args[1:])
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(),
                                   **LSTM_TOL)


@pytest.mark.parametrize("t,b,h", [(64, 1024, 200), (7, 5, 37)])
def test_lstm_scan_tc_kernel_takes_float32_xw_on_card(requires_cuda, t, b,
                                                      h):
    """A float32 xw with a bf16 RW also takes the tensor-core kernel."""
    from deeplearning4j_tpu_torch.ops import lstm as tlstm
    args = _lstm_inputs(t, b, h, torch.float32, torch.bfloat16,
                        requires_cuda, seed=9)
    before = tlstm.lstm_scan_cuda.launches_tc
    got = tlstm.lstm_scan(*args)
    want = tlstm.lstm_scan_reference(*args)
    torch.cuda.synchronize()
    assert tlstm.lstm_scan_cuda.launches_tc == before + 1
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(),
                                   **LSTM_TOL)


@pytest.mark.parametrize("variant", ["tc", "simt"])
@pytest.mark.parametrize("t,b,h", [(64, 1024, 200), (7, 33, 37)])
def test_lstm_scan_kernels_deterministic_on_card(requires_cuda, variant, t,
                                                 b, h):
    """Two calls on the same inputs give equal bits (no atomics), in
    either variant on the same bf16 inputs."""
    from deeplearning4j_tpu_torch.ops import lstm as tlstm
    args = _lstm_inputs(t, b, h, torch.bfloat16, torch.bfloat16,
                        requires_cuda, seed=11)
    a = tlstm.lstm_scan_cuda(*args, variant=variant)
    c = tlstm.lstm_scan_cuda(*args, variant=variant)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(a, c))


def test_lstm_core_gradients_on_card(requires_cuda):
    """LSTMCore on the card (kernel forward) against the same Function on
    the CPU (twin forward): outputs and every input's gradient."""
    from deeplearning4j_tpu_torch.ops import lstm as tlstm
    args = _lstm_inputs(9, 6, 40, torch.float32, torch.float32, "cpu", 5)
    outs = {}
    for dev in ("cpu", requires_cuda):
        leaves = [a.to(dev).requires_grad_(True) for a in args]
        ys, hf, cf = tlstm.LSTMCore.apply(*leaves)
        w = torch.linspace(-1, 1, ys.numel(), device=dev).reshape(ys.shape)
        grads = torch.autograd.grad((ys * w).sum() + (hf * cf).sum(),
                                    leaves)
        outs[str(dev)] = [x.detach().cpu() for x in (ys, hf, cf, *grads)]
    for a, b in zip(outs["cpu"], outs[str(requires_cuda)]):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-4,
                                   atol=1e-5)


def test_lstm_scan_kernel_refuses_unsupported_inputs_on_card(requires_cuda):
    from deeplearning4j_tpu_torch.ops import lstm as tlstm
    args = _lstm_inputs(2, 3, 16, torch.float32, torch.float32,
                        requires_cuda)
    with pytest.raises(TypeError):
        tlstm.lstm_scan(args[0].half(), *args[1:])
    h = 8400                           # 28 * H bytes a row > 227 KB
    big = [torch.zeros(s, device=requires_cuda) for s in (
        (1, 1, 4 * h), (1, h), (1, h), (h, 4 * h), (4 * h,), (h,), (h,),
        (h,))]
    with pytest.raises(ValueError, match="shared memory"):
        tlstm.lstm_scan(*big)
    del big
    with pytest.raises(ValueError, match="carries"):
        tlstm.lstm_scan(args[0], args[1][:2], *args[2:])
    with pytest.raises(ValueError, match="tc kernel"):   # a float32 RW
        tlstm.lstm_scan_cuda(*args, variant="tc")


# -- the head-packing experiment's backward (csrc/flash_bwd_packed2.cu) ----
# The same function as flash_bwd.cu in one launch, two batch-heads per CTA:
# held to the backward's limits (float32 1e-5 + 1e-5 |plain|; bf16 rows to
# 2^-6) against its twin, and against the production kernel in bf16.

@pytest.mark.parametrize("dh", [32, 64])
@pytest.mark.parametrize("causal,tq,sk,qo,ko", [
    (True, 100, 100, 0, 0),       # ragged tail inside one tile
    (True, 64, 96, 0, 32),        # kv_offset > q_offset: masked rows
    (True, 130, 200, 70, 0),      # causal skip with q after kv
    (False, 77, 150, 0, 0),       # full attention, S != T
    (True, 512, 1024, 512, 0),    # a q512 chunk at q_offset 512
])
def test_packed2_kernel_matches_plain_on_card(requires_cuda, dh, causal, tq,
                                              sk, qo, ko):
    args = _bwd_inputs(requires_cuda, torch.float32, tq, sk, dh, causal, qo,
                       ko)
    args = [torch.cat([a, a.flip(0)]) for a in args]   # bh 6: three pairs
    before = tfa.packed2_backward_cuda.launches
    got = tfa.packed2_backward_cuda(*args, dh ** -0.5, causal, qo, ko)
    want = tfa.packed2_backward_reference(*args, dh ** -0.5, causal, qo, ko)
    torch.cuda.synchronize()
    assert tfa.packed2_backward_cuda.launches == before + 1
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(),
                                   **F32_BWD)


@pytest.mark.parametrize("dtype", HALF_DTYPES)
@pytest.mark.parametrize("dh", [32, 64])
@pytest.mark.parametrize("causal,tq,sk,qo,ko", [
    (True, 1024, 1024, 0, 0),     # two q512 chunks
    (True, 100, 100, 0, 0),       # ragged tail inside one tile
    (True, 64, 96, 0, 32),        # kv_offset > q_offset: masked rows
    (True, 130, 200, 70, 0),      # causal skip with q after kv
    (False, 77, 150, 0, 0),       # full attention, S != T
])
def test_packed2_kernel_bf16_q_chunked_on_card(requires_cuda, dtype, dh,
                                               causal, tq, sk, qo, ko):
    args = _bwd_inputs(requires_cuda, dtype, tq, sk, dh, causal, qo, ko)
    args = [torch.cat([a, a.flip(0)]) for a in args]
    scale = dh ** -0.5
    chunk = tfa.PACKED2_Q_CHUNK
    chunks = tq // chunk if tq > chunk and tq % chunk == 0 else 1
    before = tfa.packed2_backward_cuda.launches
    got = tfa.packed2_backward(*args, scale, causal, qo, ko)
    torch.cuda.synchronize()
    assert tfa.packed2_backward_cuda.launches == before + chunks
    twin = tfa.q_chunked(tfa.packed2_backward_reference, *args, scale,
                         causal, qo, ko)
    prod = tfa.flash_backward_cuda(*args, scale, causal, qo, ko)
    for a, b, c in zip(got, twin, prod):
        assert a.dtype == dtype
        _assert_close(a, b, dtype, row_rtol=2.0 ** -6)
        _assert_close(a, c, dtype, row_rtol=2.0 ** -6)


def test_packed2_kernel_refuses_unsupported_inputs_on_card(requires_cuda):
    st = torch.zeros(3, 8, 1, device=requires_cuda)
    q = torch.zeros(3, 8, 64, device=requires_cuda)
    with pytest.raises(ValueError, match="even"):
        tfa.packed2_backward(q, q, q, q, st, st, st, 0.1, True)
    st, q = st[:2], torch.zeros(2, 8, 128, device=requires_cuda)
    with pytest.raises(ValueError, match="head dim 32 or 64"):
        tfa.packed2_backward(q, q, q, q, st, st, st, 0.1, True)


# -- the decode sweep (csrc/decode_sweep.cu) ------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("warps", [4, 8])
@pytest.mark.parametrize("bs", [128, 256, 512, 1024, 2048])
def test_decode_sweep_kernel_matches_plain_on_card(requires_cuda, dtype,
                                                   warps, bs):
    b, h, dh, s = 4, 2, 64, 2048
    dev = requires_cuda
    q = torch.from_numpy(_rand((b, h, dh), 90)).to(dev, dtype)
    k = torch.from_numpy(_rand((2, b, s, h * dh), 91)).to(dev, dtype)
    v = torch.from_numpy(_rand((2, b, s, h * dh), 92)).to(dev, dtype)
    for pos in (torch.tensor([0, s - 1, 700, 100], dtype=torch.int32,
                             device=dev), 2000):
        before = tdec.decode_sweep_cuda.launches
        got = tdec.decode_sweep_cuda(q, k, v, pos, h, bs, warps, layer=1)
        want = tdec.reference_split_decode_attention(q, k[1], v[1], pos, h,
                                                     bs)
        torch.cuda.synchronize()
        assert tdec.decode_sweep_cuda.launches == before + 1
        _assert_close(got, want, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dh", [32, 64, 128])
def test_decode_sweep_production_point_equals_decode_kernel(requires_cuda,
                                                            dtype, dh):
    """bs = S with 4 warps: the dispatcher launches the production kernel.
    The sweep kernel itself, forced there, reproduces the float32 decode
    kernel bit for bit (the same SIMT loop, one split, merge weight
    expf(0) = 1); in bf16 production is the tensor-core split-S core, a
    different design, so there the forced point is held to it and to its
    twin at the bf16 row tolerance."""
    b, h, s = 4, 2, 300
    dev = requires_cuda
    q = torch.from_numpy(_rand((b, h, dh), 93)).to(dev, dtype)
    k = torch.from_numpy(_rand((b, s, h * dh), 94)).to(dev, dtype)
    v = torch.from_numpy(_rand((b, s, h * dh), 95)).to(dev, dtype)
    pos = torch.tensor([0, s - 1, 17, 150], dtype=torch.int32, device=dev)
    before = (tdec.decode_sweep_cuda.launches,
              tdec.decode_attention_cuda.launches)
    routed = tdec.decode_sweep(q, k, v, pos, h, s, 4)
    assert (tdec.decode_sweep_cuda.launches,
            tdec.decode_attention_cuda.launches) == (before[0],
                                                     before[1] + 1)
    prod = tdec.decode_attention_cuda(q, k, v, pos, h)
    own = tdec.decode_sweep_cuda(q, k, v, pos, h, s, 4)
    assert torch.equal(routed, prod)
    if dtype == torch.float32:
        assert torch.equal(own, prod)
    else:
        _assert_close(own, prod, dtype)
        _assert_close(own, tdec.reference_split_decode_attention(
            q, k, v, pos, h, s), dtype)


def test_decode_sweep_kernel_refuses_unsupported_inputs_on_card(
        requires_cuda):
    q = torch.zeros(2, 2, 48, device=requires_cuda)
    cache = torch.zeros(2, 16, 96, device=requires_cuda)
    with pytest.raises(ValueError, match="head dim"):
        tdec.decode_sweep(q, cache, cache, 3, 2, 8, 4)
    q, cache = q[..., :32], cache[..., :64]
    with pytest.raises(ValueError, match="warps"):
        tdec.decode_sweep(q, cache, cache, 3, 2, 8, 2)
    with pytest.raises(TypeError):
        tdec.decode_sweep(q.half(), cache, cache, 3, 2, 8, 4)


def test_graph_timing_replays_the_kernels_on_card(requires_cuda):
    """The experiments' timer captures its calls in a CUDA graph: the
    wrappers run (and count) once per captured call, and every replay
    re-runs the captured kernels on the same buffers."""
    from deeplearning4j_tpu_torch.benchmarks import _timing
    dev = requires_cuda
    b, h, dh, s = 4, 2, 64, 512
    q = torch.from_numpy(_rand((b, h, dh), 96)).to(dev, torch.bfloat16)
    k = torch.from_numpy(_rand((b, s, h * dh), 97)).to(dev, torch.bfloat16)
    v = torch.from_numpy(_rand((b, s, h * dh), 98)).to(dev, torch.bfloat16)
    outs = []
    before = tdec.decode_sweep_cuda.launches
    ms = _timing.time_ms(
        lambda: outs.append(tdec.decode_sweep(q, k, v, 300, h, 128, 8)),
        dev, 3, 2)
    torch.cuda.synchronize()
    assert 0 < ms < float("inf")
    assert tdec.decode_sweep_cuda.launches == before + 4    # warm + 3
    want = tdec.reference_split_decode_attention(q, k, v, 300, h, 128)
    for got in outs:
        _assert_close(got, want, torch.bfloat16)
    args = _bwd_inputs(dev, torch.float32, 64, 64, 64, True, 0, 0)
    args = [torch.cat([a, a.flip(0)]) for a in args]   # bh 6: three pairs
    before = tfa.packed2_backward_cuda.launches
    ms = _timing.time_ms(lambda: tfa.packed2_backward(*args, 0.125, True),
                         dev, 2, 1)
    assert 0 < ms < float("inf")
    assert tfa.packed2_backward_cuda.launches == before + 3


# ---------------------------------------------------------------------------
# the paged pool: the kernels over the gathered view of the pages
# ---------------------------------------------------------------------------

def _paged_copy(ck, cv, ps, seed):
    """The stacked caches [L, B, S, D] scattered over pages in a shuffled
    order (page 0, the scratch page, filled with 1e4): (kp, vp, bt) whose
    gathered view equals the caches."""
    n_l, b, s, d = ck.shape
    mp = s // ps
    order = np.random.default_rng(seed).permutation(b * mp) + 1
    bt = torch.from_numpy(order.reshape(b, mp).astype(np.int32)).to(
        ck.device)
    kp = torch.full((n_l, b * mp + 1, ps, d), 1e4, dtype=ck.dtype,
                    device=ck.device)
    vp = kp.clone()
    kp[:, bt.reshape(-1).long()] = ck.reshape(n_l, b * mp, ps, d)
    vp[:, bt.reshape(-1).long()] = cv.reshape(n_l, b * mp, ps, d)
    return kp, vp, bt


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t", [1, 5])
def test_paged_view_kernels_equal_contiguous_on_card(requires_cuda, dtype,
                                                     t):
    """Decode (T = 1) and the verify window (T = 5) over the gathered
    view of a shuffled page pool return the bits they return over the
    equal contiguous cache, one launch each."""
    from deeplearning4j_tpu_torch.parallel.serving import _gather_pages
    b, h, dh, s, ps = 6, 2, 64, S_EDGES - 100 + 16, 16
    dev = requires_cuda
    q = torch.from_numpy(_rand((b, t, h, dh), 95)).to(dev, dtype)
    ck = torch.from_numpy(_rand((2, b, s, h * dh), 96)).to(dev, dtype)
    cv = torch.from_numpy(_rand((2, b, s, h * dh), 97)).to(dev, dtype)
    kp, vp, bt = _paged_copy(ck, cv, ps, 98)
    pos = torch.tensor(POS_EDGES, dtype=torch.int32, device=dev) - t // 2
    pos = torch.clamp(pos, 0, s - 1)
    kh, vh = (_gather_pages(p[1], bt, b, s) for p in (kp, vp))
    assert torch.equal(kh, ck[1]) and torch.equal(vh, cv[1])
    if t == 1:
        counter = tdec.decode_attention_cuda
        before = counter.launches
        got = tdec.decode_attention(q[:, 0], kh, vh, pos, n_heads=h)
        want = tdec.decode_attention(q[:, 0], ck, cv, pos, n_heads=h,
                                     layer=1)
    else:
        counter = tdec.decode_window_attention_cuda
        before = counter.launches
        got = tdec.decode_window_attention(q, kh, vh, pos, n_heads=h)
        want = tdec.decode_window_attention(q, ck, cv, pos, n_heads=h,
                                            layer=1)
    torch.cuda.synchronize()
    assert counter.launches == before + 2
    assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_decode_program_equals_contiguous_on_card(requires_cuda,
                                                        dtype):
    """One decode chunk of the paged program over a shuffled pool holding
    the contiguous pool's values: the same tokens, and each written row
    where the contiguous program wrote it, bit for bit."""
    from deeplearning4j_tpu_torch.models import transformer as tf
    from deeplearning4j_tpu_torch.parallel import serving as sv
    name = "float32" if dtype == torch.float32 else "bfloat16"
    cfg = tf.TransformerConfig(vocab_size=64, d_model=128, n_heads=2,
                               n_layers=2, max_len=256, dtype=name)
    dev = requires_cuda
    params = tf.init_params(cfg, seed=3, device=dev)
    ns, ps = 4, 16
    ck, cv, pos, tok = sv.init_slot_state(cfg, ns, dev)
    ck.copy_(torch.from_numpy(_rand(tuple(ck.shape), 99)).to(dev, dtype))
    cv.copy_(torch.from_numpy(_rand(tuple(cv.shape), 100)).to(dev, dtype))
    pos.copy_(torch.tensor([5, 100, 200, 17], dtype=torch.int32))
    tok.copy_(torch.tensor([1, 2, 3, 4], dtype=torch.int32))
    kp, vp, bt = _paged_copy(ck, cv, ps, 101)
    ppos, ptok = pos.clone(), tok.clone()
    active = torch.tensor([True, True, True, False], device=dev)
    rem = torch.tensor([4, 2, 4, 4], dtype=torch.int32, device=dev)
    mp, npg = cfg.max_len // ps, kp.shape[1]
    *_, want = sv.make_continuous_decode(cfg, 4, ns)(
        params, ck, cv, pos, tok, active, rem, 0)
    *_, got = sv.make_paged_decode(cfg, 4, ns, ps, mp, npg)(
        params, kp, vp, ppos, ptok, bt, active, rem, 0)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert torch.equal(ppos, pos) and torch.equal(ptok, tok)
    for layer in range(cfg.n_layers):
        assert torch.equal(sv._gather_pages(kp[layer], bt, ns, 256)[:3],
                           ck[layer][:3])


def test_paged_spec_equals_paged_plain_bf16_on_card(requires_cuda):
    """bf16 at a small config: the paged spec engine (K=4, "layers:1",
    on a tree whose deep layers are zeroed so drafts are accepted) gives
    the paged plain engine's tokens, window rows being decode bit for
    bit. The spec round replays as a CUDA graph: the window wrapper
    launches n_layers times at each round program's eager first call and
    again at its capture, and every later round is a replay."""
    from deeplearning4j_tpu_torch.models import transformer as tf
    from deeplearning4j_tpu_torch.serving.engine import (EngineConfig,
                                                         InferenceEngine)
    cfg = tf.TransformerConfig(vocab_size=64, d_model=128, n_heads=2,
                               n_layers=3, max_len=256, dtype="bfloat16")
    dev = requires_cuda
    params = tf.init_params(cfg, seed=4, device=dev)
    for leaf in ("Wo", "W2", "b2"):
        params["blocks"][leaf][1:] = 0
    rng = np.random.default_rng(5)
    sys_prompt = rng.integers(0, 64, 40).astype(np.int32)
    prompts = [np.concatenate([sys_prompt, rng.integers(0, 64, n).astype(
        np.int32)]) for n in (3, 20, 41, 7, 60, 1)]
    out = {}
    for arm, kw in (("plain", {}), ("spec", dict(spec_decode=True, spec_k=4,
                                                 draft="layers:1"))):
        eng = InferenceEngine(cfg, params, EngineConfig(
            num_slots=4, decode_chunk=4, max_new_tokens=24, paged=True,
            page_size=16, **kw), device=dev)
        win0 = tdec.decode_window_attention_cuda.launches
        out[arm] = [eng.submit(p) for p in prompts + prompts]
        eng.run_pending()
        n_win = tdec.decode_window_attention_cuda.launches - win0
    c = eng.counts
    assert c["spec_rounds"] > 0 and c["prefix_hits"] > 0
    rounds = [k for k in eng._graphs.keys() if k[0] == "paged_spec"]
    assert rounds and n_win == 2 * cfg.n_layers * len(rounds)
    assert c["graph_replays"] == (c["spec_rounds"] + c["decode_chunks"]
                                  - len(eng._graphs.keys()))
    for a, b in zip(out["spec"], out["plain"]):
        np.testing.assert_array_equal(a.result(), b.result())


@pytest.mark.parametrize("spec", [False, True], ids=["plain", "spec"])
def test_graph_replay_after_reload_uses_new_weights_on_card(requires_cuda,
                                                            tmp_path, spec):
    """Graphs hold their weight trees by identity, so a hot reload drops
    them: the next call of each key captures again on the new tree and
    every later replay computes with it. After a reload to another tree
    the engine's tokens (greedy, bf16) equal a fresh engine's on that
    tree, replays ran after the new capture, and the reload back gives
    the first tokens again."""
    from deeplearning4j_tpu_torch.models import transformer as tf
    from deeplearning4j_tpu_torch.observability.metrics import \
        MetricsRegistry
    from deeplearning4j_tpu_torch.serving.engine import (EngineConfig,
                                                         InferenceEngine)
    from deeplearning4j_tpu_torch.util.checkpointing import \
        CheckpointManager
    dev = requires_cuda
    cfg = tf.TransformerConfig(vocab_size=64, d_model=128, n_heads=2,
                               n_layers=3, max_len=256, dtype="bfloat16")
    a = tf.init_params(cfg, seed=3, device=dev)
    b = tf.init_params(cfg, seed=7, device=dev)
    mgr = CheckpointManager(tmp_path, registry=MetricsRegistry())
    mgr.save_tree(a, 1)
    mgr.save_tree(b, 2)
    kw = dict(num_slots=4, decode_chunk=4, max_new_tokens=12)
    if spec:
        kw.update(spec_decode=True, spec_k=3, draft="layers:1")
    prompts = [np.arange(n, dtype=np.int32) * 7 % 64 for n in (5, 9, 13)]

    def serve(eng):
        hs = [eng.submit(p) for p in prompts]
        eng.run_pending()
        return [h.result().tolist() for h in hs]

    eng = InferenceEngine(cfg, a, EngineConfig(**kw), device=dev)
    first = serve(eng)
    caps = eng.counts["graph_captures"]
    assert caps >= 1 and eng.counts["graph_replays"] >= 1
    assert eng.reload_weights(mgr, step=2) == 2
    assert eng._graphs.keys() == []
    r0 = eng.counts["graph_replays"]
    got = serve(eng)
    assert eng.counts["graph_captures"] > caps
    assert eng.counts["graph_replays"] > r0
    assert got == serve(InferenceEngine(cfg, b, EngineConfig(**kw),
                                        device=dev))
    assert got != first
    assert eng.reload_weights(mgr, step=1) == 1
    assert serve(eng) == first


@pytest.mark.parametrize("temperature", [0.0, 0.9])
@pytest.mark.parametrize("kind", ["decode", "paged_decode", "spec",
                                  "paged_spec"])
def test_slot_program_graph_replay_equals_eager_on_card(requires_cuda, kind,
                                                        temperature):
    """The engine's per-tick programs (bf16, small config) replayed as
    CUDA graphs (`serving.graphs.SlotGraphs`) return the eager program's
    bits, outputs and pool alike, greedy and sampled (top-k 8), on two
    calls with other masks and budgets. The kernels' counters count the
    wrappers' launches: the first call's eager run and its capture each
    add what one eager call adds, and a replay adds nothing."""
    from deeplearning4j_tpu_torch.models import transformer as tf
    from deeplearning4j_tpu_torch.ops import flash_decode as fd
    from deeplearning4j_tpu_torch.parallel import serving as sv
    from deeplearning4j_tpu_torch.observability.metrics import \
        MetricsRegistry
    from deeplearning4j_tpu_torch.serving.graphs import SlotGraphs
    counted = (fd.decode_attention_cuda, fd.decode_attention_q_cuda,
               fd.decode_window_attention_cuda,
               fd.decode_window_attention_q_cuda)
    cfg = tf.TransformerConfig(vocab_size=64, d_model=128, n_heads=2,
                               n_layers=3, max_len=256, dtype="bfloat16")
    dev = requires_cuda
    params = tf.init_params(cfg, seed=3, device=dev)
    ns, ps, size = 4, 16, 4
    ck, cv, pos, tok = sv.init_slot_state(cfg, ns, dev)
    ck.copy_(torch.from_numpy(_rand(tuple(ck.shape), 99)).to(dev, ck.dtype))
    cv.copy_(torch.from_numpy(_rand(tuple(cv.shape), 100)).to(dev, cv.dtype))
    pos.copy_(torch.tensor([5, 100, 200, 17], dtype=torch.int32))
    tok.copy_(torch.tensor([1, 2, 3, 4], dtype=torch.int32))
    samp = dict(temperature=temperature, top_k=8)
    lead, state = (), (ck, cv, pos, tok)
    if kind.startswith("paged"):
        kp, vp, bt = _paged_copy(ck, cv, ps, 101)
        state, lead = (kp, vp, pos, tok), (bt,)
        geo = (ps, cfg.max_len // ps, kp.shape[1])
        fn = (sv.make_paged_decode(cfg, size, ns, *geo, **samp)
              if kind == "paged_decode" else
              sv.make_paged_speculative_decode(cfg, size, ns, *geo,
                                               draft_layers=1, **samp))
    else:
        fn = (sv.make_continuous_decode(cfg, size, ns, **samp)
              if kind == "decode" else
              sv.make_speculative_decode(cfg, size, ns, draft_layers=1,
                                         **samp))
    trees = (params,) if kind.endswith("decode") else (params, params)
    twin = tuple(x.clone() for x in state)
    reg = MetricsRegistry()
    captures, replays = reg.counter("captures"), reg.counter("replays")
    graphs = SlotGraphs(dev, captures, replays, reg.gauge("pool_bytes"))
    calls = [([True, True, True, False], [9, 2, 9, 9]),
             ([True, False, True, True], [1, 9, 3, 9]),
             ([True, True, True, True], [9, 9, 9, 2])]
    for n, (active, rem) in enumerate(calls):
        dyn = (*lead, torch.tensor(active, device=dev),
               torch.tensor(rem, dtype=torch.int32, device=dev))
        if not kind.endswith("decode"):
            dyn += (torch.zeros(ns, dtype=torch.bool, device=dev),)
        before = [w.launches for w in counted]
        got = graphs.call((kind, size), fn, (*trees, *state), dyn, 7)
        mid = [w.launches for w in counted]
        want = fn(*trees, *twin, *dyn, 7)
        after = [w.launches for w in counted]
        torch.cuda.synchronize()
        assert replays.value == n
        eager = [a - m for m, a in zip(mid, after)]
        assert any(eager)
        assert [m - b for b, m in zip(before, mid)] == \
            [(2 if n == 0 else 0) * e for e in eager]
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    assert captures.value == 1
    assert replays.value == len(calls) - 1


@pytest.mark.parametrize("pipeline", [False, True], ids=["sync", "pipelined"])
@pytest.mark.parametrize("spec", [False, True], ids=["plain", "spec"])
def test_constrained_engine_new_grammar_replays_on_card(requires_cuda,
                                                        pipeline, spec):
    """A warm, graphed bf16 engine (its masked decode chunk or spec round
    captured under ``[ab]+``) admits two grammars it has not seen, mixed
    with unconstrained requests: nothing is captured, every committed
    token is legal, and the table's device tensors are the captured ones,
    rewritten in place to equal the host table."""
    from deeplearning4j_tpu_torch.models import transformer as tf
    from deeplearning4j_tpu_torch.serving.constrain import compile_grammar
    from deeplearning4j_tpu_torch.serving.engine import (EngineConfig,
                                                         InferenceEngine)
    cfg = tf.TransformerConfig(vocab_size=256, d_model=128, n_heads=2,
                               n_layers=3, max_len=256, dtype="bfloat16")
    kw = dict(spec_decode=True, spec_k=3, draft="layers:1") if spec else {}
    params = tf.init_params(cfg, seed=5, device=requires_cuda)
    eng = InferenceEngine(cfg, params, EngineConfig(
        num_slots=4, decode_chunk=4, max_new_tokens=24, pipeline=pipeline,
        **kw), device=requires_cuda)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 256, size=int(n)).astype(np.int32)
               for n in rng.integers(5, 40, size=8)]
    for p in prompts[:4]:
        eng.submit(p, constrain="[ab]+")
    eng.run_pending()
    captured = eng.counts["graph_captures"]
    dev = eng._ctab.device(eng.device)
    specs = ["[cd]{2,6}", None, '(x|yz)+', None] * 2
    hs = [eng.submit(p, constrain=s) for p, s in zip(prompts, specs)]
    eng.run_pending()
    assert eng.counts["graph_captures"] == captured and \
        eng.counts["graph_replays"] > 0
    again = eng._ctab.device(eng.device)
    assert again[0] is dev[0] and again[1] is dev[1]
    assert torch.equal(dev[0].cpu(), torch.from_numpy(eng._ctab.allow))
    assert torch.equal(dev[1].cpu(), torch.from_numpy(eng._ctab.trans))
    for h, s in zip(hs, specs):
        gen = h.result()[h.prompt.shape[0]:]
        if s is None:
            assert gen.shape[0] == 24
            continue
        g, st = compile_grammar(s, 256), 0
        for t in gen.tolist():
            assert g.legal(st, t), (s, st, t)
            st = g.advance(st, t)
        # [cd]{2,6} ends terminal; (x|yz)+ runs its whole budget
        assert g.is_terminal(st) or gen.shape[0] == 24
    assert eng.counts["constrained_illegal"] == 0 and eng.drained()

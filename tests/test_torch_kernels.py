"""The port's CUDA kernels against their plain PyTorch twins, on the card.

Every test here needs a CUDA device and skips without one (the decision is
taken inside the `requires_cuda` fixture, never at import). The file imports
nothing of JAX, so it also runs on a machine that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py

Tolerances: float32 1e-5 (same f32 math, other summation order); bfloat16
per output row, 2^-7 of the plain row's largest entry plus 1e-5 (one bf16
rounding of the output and of the probabilities, in the row's own scale).
The backward's bfloat16 gradients get two such units (2^-6): one for the
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


def test_flash_kernel_bf16_on_card(requires_cuda):
    q, k, v = (torch.from_numpy(_rand((4, 300, 64), s)).to(
        requires_cuda, torch.bfloat16) for s in (50, 51, 52))
    o, m, logl = tfa.flash_forward(q, k, v, 0.125, True)
    ro, rm, rl = tfa.flash_forward_reference(q, k, v, 0.125, True)
    assert o.dtype == torch.bfloat16
    _assert_close(o, ro, torch.bfloat16)
    np.testing.assert_allclose(m.cpu().numpy(), rm.cpu().numpy(), **F32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dh", [32, 64, 128])
def test_decode_kernel_matches_plain_on_card(requires_cuda, dtype, dh):
    b, h, s = 4, 2, 300
    dev = requires_cuda
    q = torch.from_numpy(_rand((b, h, dh), 60)).to(dev, dtype)
    k = torch.from_numpy(_rand((2, b, s, h * dh), 61)).to(dev, dtype)
    v = torch.from_numpy(_rand((2, b, s, h * dh), 62)).to(dev, dtype)
    pos = torch.tensor([0, 299, 17, 150], dtype=torch.int32, device=dev)
    before = tdec.decode_attention_cuda.launches
    got = tdec.decode_attention(q, k, v, pos, n_heads=h, layer=1)
    want = tdec.reference_decode_attention(q, k[1], v[1], pos, n_heads=h)
    torch.cuda.synchronize()
    assert tdec.decode_attention_cuda.launches == before + 1
    _assert_close(got, want, dtype)
    got_s = tdec.decode_attention(q, k, v, 123, n_heads=h, layer=0)
    want_s = tdec.reference_decode_attention(q, k[0], v[0], 123, n_heads=h)
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


def test_flash_backward_kernel_bf16_on_card(requires_cuda):
    args = _bwd_inputs(requires_cuda, torch.bfloat16, 300, 300, 64, True,
                       0, 0)
    got = tfa.flash_backward(*args, 0.125, True)
    want = tfa.flash_backward_reference(*args, 0.125, True)
    for a, b in zip(got, want):
        assert a.dtype == torch.bfloat16
        _assert_close(a, b, torch.bfloat16, row_rtol=2.0 ** -6)


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


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16,
                                   torch.bfloat16])
@pytest.mark.parametrize("dh", [32, 64, 128])
@pytest.mark.parametrize("t", [1, 5, 9])
def test_window_kernel_matches_plain_and_decode_on_card(requires_cuda,
                                                        dtype, dh, t):
    """The verify-window kernel against its plain twin (the tolerances
    above; T=9 spans two CTA groups of 8), and each window row bitwise
    against the decode kernel at pos + t, the clamp at S-1 included."""
    b, h, s = 4, 2, 300
    dev = requires_cuda
    q = torch.from_numpy(_rand((b, t, h, dh), 90)).to(dev, dtype)
    k = torch.from_numpy(_rand((2, b, s, h * dh), 91)).to(dev, dtype)
    v = torch.from_numpy(_rand((2, b, s, h * dh), 92)).to(dev, dtype)
    pos = torch.tensor([0, 299, 17, 294], dtype=torch.int32, device=dev)
    before = tdec.decode_window_attention_cuda.launches
    got = tdec.decode_window_attention(q, k, v, pos, n_heads=h, layer=1)
    want = tdec.reference_window_attention(q, k[1], v[1], pos, n_heads=h)
    torch.cuda.synchronize()
    assert tdec.decode_window_attention_cuda.launches == before + 1
    _assert_close(got, want, dtype)
    for ti in range(t):
        row = tdec.decode_attention(q[:, ti], k, v, pos + ti, n_heads=h,
                                    layer=1)
        assert torch.equal(got[:, ti], row), f"window row {ti}"
    got_s = tdec.decode_window_attention(q, k, v, 150, n_heads=h, layer=0)
    want_s = tdec.reference_window_attention(q, k[0], v[0], 150, n_heads=h)
    _assert_close(got_s, want_s, dtype)


def test_window_kernel_refuses_unsupported_inputs_on_card(requires_cuda):
    q = torch.zeros(2, 3, 2, 48, device=requires_cuda)
    cache = torch.zeros(2, 16, 96, device=requires_cuda)
    with pytest.raises(ValueError, match="head dim"):
        tdec.decode_window_attention(q, cache, cache, 3, n_heads=2)
    q = torch.zeros(2, 3, 2, 32, device=requires_cuda)
    with pytest.raises(TypeError):
        tdec.decode_window_attention(q.half(), cache[..., :64],
                                     cache[..., :64], 3, n_heads=2)


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
    before = tlstm.lstm_scan_cuda.launches
    got = tlstm.lstm_scan(*args)
    want = tlstm.lstm_scan_reference(*args)
    torch.cuda.synchronize()
    assert tlstm.lstm_scan_cuda.launches == before + 1
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(),
                                   **LSTM_TOL)


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

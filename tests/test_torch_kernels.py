"""The port's CUDA kernels against their plain PyTorch twins, on the card.

Every test here needs a CUDA device and skips without one (the decision is
taken inside the `requires_cuda` fixture, never at import). The file imports
nothing of JAX, so it also runs on a machine that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py

Tolerances: float32 1e-5 (same f32 math, other summation order); bfloat16
per output row, 2^-7 of the plain row's largest entry plus 1e-5 (one bf16
rounding of the output and of the probabilities, in the row's own scale).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from deeplearning4j_tpu_torch.ops import flash_attention as tfa  # noqa
from deeplearning4j_tpu_torch.ops import flash_decode as tdec  # noqa

F32 = dict(rtol=0, atol=1e-5)


def _assert_close(got, want, dtype):
    g, w = got.float().cpu(), want.float().cpu()
    if dtype == torch.float32:
        np.testing.assert_allclose(g.numpy(), w.numpy(), **F32)
        return
    limit = w.abs().amax(dim=-1, keepdim=True) * 2.0 ** -7 + 1e-5
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


def test_kernels_refuse_unsupported_inputs_on_card(requires_cuda):
    q = torch.zeros(2, 8, 48, device=requires_cuda)
    with pytest.raises(ValueError, match="head dim"):
        tfa.flash_forward(q, q, q, 0.1, True)
    with pytest.raises(TypeError):
        tfa.flash_forward(q.double(), q.double(), q.double(), 0.1, True)
    qd = torch.zeros(2, 2, 48, device=requires_cuda)
    cache = torch.zeros(2, 16, 96, device=requires_cuda)
    with pytest.raises(ValueError, match="head dim"):
        tdec.decode_attention(qd, cache, cache, 3, n_heads=2)

"""Port parity: quantization primitives, trees, pools and the scaled twins.

Inputs come from numpy seeds and go through the JAX function and its port
on the CPU. Tolerances: the quantizers (`quantize`, `quantize_rows`,
`quantize_params`) bit-equal to JAX's, int8 values and float32 scales
alike (both compute absmax, one float32 division and round half to even);
e4m3 values bit-equal to ``jnp.asarray(x).astype(jnp.float8_e4m3fn)``
(both round to nearest even; JAX's own `quantize(mode="fp8")` resolves to
int8 on the CPU, as the port's does); dequantization bit-equal (one
float32 multiply, one cast); the scaled decode and window twins within
1e-5 of JAX's references (the same float32 algebra summed in other
orders); `max_logit_divergence` within 1e-5 of JAX's on the dense and
the MoE config.
"""
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from deeplearning4j_tpu.models import transformer as jtf  # noqa: E402
from deeplearning4j_tpu.ops import flash_decode as jdec  # noqa: E402
from deeplearning4j_tpu.parallel.mesh import MeshSpec, make_mesh  # noqa
from deeplearning4j_tpu.quant import core as jq  # noqa: E402
from deeplearning4j_tpu.quant import kv as jkv  # noqa: E402
from deeplearning4j_tpu.quant import model as jqm  # noqa: E402

from deeplearning4j_tpu_torch.models import transformer as ttf  # noqa
from deeplearning4j_tpu_torch.models.convert import \
    params_from_numpy  # noqa: E402
from deeplearning4j_tpu_torch.ops import flash_decode as tdec  # noqa: E402
from deeplearning4j_tpu_torch.quant import core as tq  # noqa: E402
from deeplearning4j_tpu_torch.quant import kv as tkv  # noqa: E402
from deeplearning4j_tpu_torch.quant import model as tqm  # noqa: E402

FIELDS = dict(vocab_size=32, d_model=32, n_heads=4, n_layers=2, max_len=64)
JCFG = jtf.TransformerConfig(**FIELDS)
TCFG = ttf.TransformerConfig(**FIELDS)
F32 = dict(rtol=0, atol=1e-5)


@pytest.fixture(scope="module")
def mesh1():
    return make_mesh(MeshSpec(data=1, model=1))


@pytest.fixture(scope="module")
def jparams():
    return jtf.init_params(JCFG, jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def tparams(jparams):
    return params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                             device="cpu")


def _rand(shape, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).normal(size=shape)).astype(
        np.float32)


def _np(x):
    """A tensor's values as numpy, e4m3 as its bytes."""
    if x.dtype == torch.float8_e4m3fn:
        return x.view(torch.uint8).numpy()
    return x.numpy()


def _jnp_bytes(x):
    a = np.asarray(x)
    return a.view(np.uint8) if a.dtype.name == "float8_e4m3fn" else a


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,axis", [((6, 40), -2), ((3, 16, 24), -2),
                                        ((24, 16), -1), ((2, 5, 7), (0, 2))])
def test_quantize_matches_jax(shape, axis):
    """int8 values and scales bit-equal to JAX's; every element within
    half a step of its channel's scale; an all-zero channel has scale 1.0
    and values 0."""
    x = _rand(shape, 1)
    if isinstance(axis, int):
        idx = [slice(None)] * len(shape)
        idx[-1 if axis == -2 else 0] = 1
        x[tuple(idx)] = 0.0                  # one all-zero channel
    j = jq.quantize(jnp.asarray(x), axis=axis)
    t = tq.quantize(torch.from_numpy(x), axis=axis)
    assert t.mode == "int8" and t.values.dtype == torch.int8
    np.testing.assert_array_equal(t.values.numpy(), np.asarray(j.values))
    np.testing.assert_array_equal(t.scales.numpy(), np.asarray(j.scales))
    err = np.abs(x - t.dequantize().numpy())
    assert (err <= t.scales.numpy() / 2 + 1e-7).all()
    if isinstance(axis, int):
        sc = t.scales.numpy()
        assert (sc == 1.0).any() and (sc > 0).all()


@pytest.mark.parametrize("kv_mode", ["int8", "fp8"])
@pytest.mark.parametrize("shape", [(5, 64), (2, 3, 7, 32)])
def test_quantize_rows_matches_jax(kv_mode, shape):
    """Row-wise values bit-equal to JAX's `quantize_rows` (int8, or the
    e4m3 bytes) and scales bit-equal; zero rows get scale 1.0."""
    x = _rand(shape, 2, 3.0)
    x.reshape(-1, shape[-1])[1] = 0.0
    jv, js = jkv.quantize_rows(jnp.asarray(x), kv_mode)
    tv, ts = tkv.quantize_rows(torch.from_numpy(x), kv_mode)
    assert tv.dtype == tkv.kv_cache_dtype(kv_mode)
    np.testing.assert_array_equal(_np(tv), _jnp_bytes(jv))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert ts.numpy().reshape(-1)[1] == 1.0
    if kv_mode == "int8":
        err = np.abs(x - tv.numpy() * ts.numpy()[..., None])
        assert (err <= ts.numpy()[..., None] / 2 + 1e-6).all()


def test_fp8_values_are_the_e4m3_cast_bit_for_bit():
    """e4m3 rows are x / scale cast by jnp's float8_e4m3fn rounding, bit
    for bit (absmax maps to 448)."""
    x = _rand((9, 48), 3, 5.0)
    tv, ts = tkv.quantize_rows(torch.from_numpy(x), "fp8")
    want = jnp.asarray(x / ts.numpy()[:, None]).astype(jnp.float8_e4m3fn)
    np.testing.assert_array_equal(_np(tv), _jnp_bytes(want))
    np.testing.assert_array_equal(
        ts.numpy(), np.abs(x).max(axis=1).astype(np.float32) / 448.0)
    assert float(tv.to(torch.float32).abs().max()) == 448.0


def test_resolve_mode_and_fp8_support_on_the_cpu():
    """fp8 resolves to int8 on the CPU, as JAX's does there; None and ""
    pass; an unknown mode raises the same error."""
    assert not tq.fp8_supported("cpu")
    assert tq.resolve_mode("fp8", "cpu") == jq.resolve_mode("fp8") == "int8"
    assert tq.resolve_mode("int8", "cpu") == "int8"
    assert tq.resolve_mode(None) is None and tq.resolve_mode("") is None
    with pytest.raises(ValueError) as e:
        jq.resolve_mode("int4")
    with pytest.raises(ValueError) as got:
        tq.resolve_mode("int4", "cpu")
    assert str(got.value) == str(e.value)
    q = tq.quantize(torch.ones(4, 4), mode="fp8")
    assert q.mode == "int8" and q.values.dtype == torch.int8


def test_quantized_tensor_surface():
    """shape / ndim / dtype / nbytes; .to(dtype) dequantizes bit-equal to
    JAX's astype (f32 multiply, then the cast); .to(device) moves values
    and scales; indexing slices both in lockstep."""
    w = _rand((3, 8, 12), 4)
    jqt = jq.quantize(jnp.asarray(w))
    qt = tq.quantize(torch.from_numpy(w))
    assert qt.shape == (3, 8, 12) and qt.ndim == 3 and qt.dtype == torch.int8
    assert qt.nbytes == jqt.nbytes == 3 * 8 * 12 + 3 * 12 * 4
    for tdt, jdt in ((torch.float32, jnp.float32),
                     (torch.bfloat16, jnp.bfloat16)):
        got = qt.to(tdt)
        assert got.dtype == tdt
        np.testing.assert_array_equal(
            got.float().numpy(), np.asarray(jqt.astype(jdt), np.float32))
    moved = qt.to("cpu")
    assert isinstance(moved, tq.QuantizedTensor) and moved.mode == "int8"
    row = qt[1]
    assert row.shape == (8, 12) and row.scales.shape == (1, 12)
    np.testing.assert_array_equal(row.to(torch.float32).numpy(),
                                  np.asarray(jqt[1].astype(jnp.float32)))
    assert "int8" in repr(qt)
    with pytest.raises(TypeError):
        qt.to(torch.float32, copy=True)


def test_fake_quant_and_quantized_matmul_match_jax():
    x = _rand((5, 8), 5)
    w = _rand((8, 6), 6)
    np.testing.assert_array_equal(
        tq.fake_quant(torch.from_numpy(w)).numpy(),
        np.asarray(jq.fake_quant(jnp.asarray(w))))
    qw_t = tq.quantize(torch.from_numpy(w))
    qw_j = jq.quantize(jnp.asarray(w))
    np.testing.assert_allclose(
        tq.quantized_matmul(torch.from_numpy(x), qw_t).numpy(),
        np.asarray(jq.quantized_matmul(jnp.asarray(x), qw_j)), **F32)
    np.testing.assert_allclose(
        tq.quantized_matmul(torch.from_numpy(x), torch.from_numpy(w)).numpy(),
        x @ w, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(
        tq.dequantize(qw_t, torch.float32).numpy(),
        np.asarray(jq.dequantize(qw_j)))


# ---------------------------------------------------------------------------
# parameter trees and drafters
# ---------------------------------------------------------------------------

def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def test_quantize_params_matches_jax(jparams, tparams):
    """Key by key: the same leaves quantized (embed on -1, Wout and the
    six block weights on -2), values and scales bit-equal; the rest
    untouched; a quantized leaf refuses to be quantized again; the
    dequantized tree and param_bytes equal JAX's."""
    jqp = jqm.quantize_params(jparams)
    tqp = tqm.quantize_params(tparams)
    jl = dict(_leaves(jqp))
    tl = dict(_leaves(tqp))
    assert jl.keys() == tl.keys()
    quantized = {k for k, v in tl.items() if isinstance(v, tq.QuantizedTensor)}
    assert quantized == {"embed", "Wout"} | {f"blocks/{n}" for n in (
        "Wq", "Wk", "Wv", "Wo", "W1", "W2")}
    for k, t in tl.items():
        j = jl[k]
        if k in quantized:
            assert isinstance(j, jq.QuantizedTensor)
            np.testing.assert_array_equal(t.values.numpy(),
                                          np.asarray(j.values), err_msg=k)
            np.testing.assert_array_equal(t.scales.numpy(),
                                          np.asarray(j.scales), err_msg=k)
        else:
            assert t is tparams["blocks"][k[7:]] if k.startswith(
                "blocks/") else t is tparams[k]
    assert tqp["embed"].scales.shape == (FIELDS["vocab_size"], 1)
    assert tqp["blocks"]["Wq"].scales.shape == (2, 1, FIELDS["d_model"])
    with pytest.raises(ValueError, match="already quantized"):
        tqm.quantize_params(tqp)
    with pytest.raises(ValueError, match="needs a mode"):
        tqm.quantize_params(tparams, mode=None)
    dq_t = dict(_leaves(tqm.dequantize_params(tqp)))
    for k, j in _leaves(jqm.dequantize_params(jqp)):
        np.testing.assert_array_equal(dq_t[k].numpy(), np.asarray(j),
                                      err_msg=k)
    assert tqm.param_bytes(tqp) == jqm.param_bytes(jqp)
    assert tqm.param_bytes(tparams) == jqm.param_bytes(jparams)
    assert tqm.param_bytes(tqp) < 0.5 * tqm.param_bytes(tparams)


def test_params_from_numpy_carries_a_jax_quantized_tree(jparams, tparams):
    """JAX's quantized tree, through tree_map(np.asarray) (leaves
    .../Wq/.values and .../Wq/.scales), converts to QuantizedTensors with
    its bytes: equal to the port's own quantization of the same tree."""
    jqp = jqm.quantize_params(jparams)
    conv = params_from_numpy(jax.tree_util.tree_map(np.asarray, jqp),
                             device="cpu")
    mine = dict(_leaves(tqm.quantize_params(tparams)))
    for k, t in _leaves(conv):
        if isinstance(mine[k], tq.QuantizedTensor):
            assert isinstance(t, tq.QuantizedTensor) and t.mode == "int8"
            assert torch.equal(t.values, mine[k].values), k
            assert torch.equal(t.scales, mine[k].scales), k
        else:
            assert torch.equal(t, mine[k]), k
    paths = [jax.tree_util.keystr(p) for p, _ in
             jax.tree_util.tree_flatten_with_path(jqp)[0]]
    assert any(p.endswith("['Wq'].values") for p in paths)


@pytest.mark.parametrize("draft", ["int8", "fp8"])
def test_quantized_drafter_matches_jax(mesh1, jparams, tparams, draft):
    """"int8" / "fp8" quantize the float tree (fp8 resolving to int8 on
    the CPU, as JAX's): the same mode and layers, bit-equal leaves; on an
    already-quantized engine the live tree is shared, not requantized."""
    jtree, jmode, jn = jqm.draft_tree(jparams, draft, JCFG, mesh1)
    ttree, tmode, tn = tqm.draft_tree(tparams, draft, TCFG)
    assert (tmode, tn) == (jmode, jn) == ("int8", 0)
    jl = dict(_leaves(jtree))
    for k, t in _leaves(ttree):
        if isinstance(t, tq.QuantizedTensor):
            np.testing.assert_array_equal(t.values.numpy(),
                                          np.asarray(jl[k].values))
            np.testing.assert_array_equal(t.scales.numpy(),
                                          np.asarray(jl[k].scales))
    jq_tree = jqm.quantize_params(jparams)
    tq_tree = tqm.quantize_params(tparams)
    _, jmode2, jn2 = jqm.draft_tree(jq_tree, draft, JCFG, mesh1,
                                    base_mode="int8")
    shared, tmode2, tn2 = tqm.draft_tree(tq_tree, draft, TCFG,
                                         base_mode="int8")
    assert shared is tq_tree and (tmode2, tn2) == (jmode2, jn2)


@pytest.mark.parametrize("draft", ["self", "layers:1", "layers:3", "bogus"])
def test_draft_tree_keeps_the_base_mode(mesh1, jparams, tparams, draft):
    """"self" / "layers:N" on a quantized engine report its mode, as
    JAX's do; the errors are JAX's."""
    jq_tree = jqm.quantize_params(jparams)
    tq_tree = tqm.quantize_params(tparams)
    try:
        _, jmode, jn = jqm.draft_tree(jq_tree, draft, JCFG, mesh1,
                                      base_mode="int8")
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            tqm.draft_tree(tq_tree, draft, TCFG, base_mode="int8")
        assert str(got.value) == str(e)
        return
    tree, tmode, tn = tqm.draft_tree(tq_tree, draft, TCFG, base_mode="int8")
    assert tree is tq_tree and (tmode, tn) == (jmode, jn)


def test_max_logit_divergence_matches_jax(jparams, tparams):
    """The dense config's divergence of the int8 tree from the float one
    equals JAX's within 1e-5, and a quantized tree serves `forward` and
    `generate` unchanged (the MoE half:
    `test_moe_max_logit_divergence_matches_jax`)."""
    toks = np.stack([(np.arange(16) * (s + 3)) % FIELDS["vocab_size"]
                     for s in range(4)]).astype(np.int32)
    jdiv = jqm.max_logit_divergence(JCFG, jparams,
                                    jqm.quantize_params(jparams),
                                    jnp.asarray(toks))
    tqp = tqm.quantize_params(tparams)
    tdiv = tqm.max_logit_divergence(TCFG, tparams, tqp, toks)
    assert abs(tdiv - jdiv) <= 1e-5, (tdiv, jdiv)
    assert 0.0 < tdiv <= 0.25
    out = ttf.generate(TCFG, tqp, torch.from_numpy(toks[:1, :8]), 6,
                       temperature=0.0)
    want = jtf.generate(JCFG, jqm.quantize_params(jparams),
                        jnp.asarray(toks[:1, :8]), 6, jax.random.PRNGKey(0),
                        temperature=0.0)
    np.testing.assert_array_equal(out.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# KV pools
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kv_mode", ["int8", "fp8"])
def test_quant_pools_match_jax(mesh1, kv_mode):
    """The 6-tuple pools: shapes and dtypes as JAX's (fp8 resolving to
    int8 on the CPU), values 0, scales 1.0; the analytic bytes equal
    JAX's for the float and the quantized pools."""
    ns, ps, npg, mp = 4, 8, 20, 8
    jst = jkv.init_quant_slot_state(JCFG, mesh1, ns, kv_mode)
    tst = tkv.init_quant_slot_state(TCFG, ns, kv_mode, "cpu")
    jpg = jkv.init_paged_quant_state(JCFG, mesh1, ns, ps, npg, kv_mode)
    tpg = tkv.init_paged_quant_state(TCFG, ns, ps, npg, kv_mode, "cpu")
    for t, j in list(zip(tst, jst)) + list(zip(tpg, jpg)):
        assert tuple(t.shape) == tuple(j.shape)
        assert t.dtype == {np.dtype(np.int8): torch.int8,
                           np.dtype(np.float32): torch.float32,
                           np.dtype(np.int32): torch.int32}[
            np.asarray(j).dtype]
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    m = tq.resolve_mode(kv_mode, "cpu")
    for km in (None, m):
        assert tkv.slot_pool_bytes(TCFG, ns, km) == \
            jkv.slot_pool_bytes(JCFG, ns, km)
        assert tkv.paged_pool_bytes(TCFG, ns, ps, npg, mp, km) == \
            jkv.paged_pool_bytes(JCFG, ns, ps, npg, mp, km)
    with pytest.raises(ValueError, match="needs kv_mode"):
        tkv.init_quant_slot_state(TCFG, ns, None, "cpu")


# ---------------------------------------------------------------------------
# the scaled decode and window twins
# ---------------------------------------------------------------------------

def _quant_cache(shape, seed):
    k, ks = tkv.quantize_rows(torch.from_numpy(_rand(shape, seed)), "int8")
    return k, ks


@pytest.mark.parametrize("pos", [77, [0, 5, 127, 64]])
def test_scaled_decode_twin_matches_jax(pos):
    """The twin and the dispatcher (stacked [L, B, S, 1] scales with a
    layer) against JAX's scaled reference, within 1e-5."""
    b, h, dh, s = 4, 4, 16, 128
    q = _rand((b, h, dh), 30)
    k, ks = _quant_cache((3, b, s, h * dh), 31)
    v, vs = _quant_cache((3, b, s, h * dh), 32)
    jp = jnp.asarray(pos, jnp.int32)
    tp = torch.tensor(pos, dtype=torch.int32)
    want = jdec.reference_decode_attention(
        jnp.asarray(q), jnp.asarray(k[2].numpy()), jnp.asarray(v[2].numpy()),
        jp, 4, k_scale=jnp.asarray(ks[2].numpy()),
        v_scale=jnp.asarray(vs[2].numpy()))
    got = tdec.reference_decode_attention(torch.from_numpy(q), k[2], v[2],
                                          tp, 4, k_scale=ks[2],
                                          v_scale=vs[2])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    disp = tdec.decode_attention(torch.from_numpy(q), k, v, tp, n_heads=4,
                                 layer=2, k_scale=ks[..., None],
                                 v_scale=vs[..., None])
    assert torch.equal(disp, got)
    jdisp = jdec.decode_attention(
        jnp.asarray(q), jnp.asarray(k.numpy()), jnp.asarray(v.numpy()), jp,
        n_heads=4, layer=2, k_scale=jnp.asarray(ks[2].numpy()),
        v_scale=jnp.asarray(vs[2].numpy()))
    np.testing.assert_allclose(disp.numpy(), np.asarray(jdisp), **F32)
    # bf16 queries: the scaled algebra in float32, the result in bf16
    qb = torch.from_numpy(q).to(torch.bfloat16)
    gotb = tdec.reference_decode_attention(qb, k[2], v[2], tp, 4,
                                           k_scale=ks[2], v_scale=vs[2])
    wantb = jdec.reference_decode_attention(
        jnp.asarray(qb.float().numpy()).astype(jnp.bfloat16),
        jnp.asarray(k[2].numpy()), jnp.asarray(v[2].numpy()), jp, 4,
        k_scale=jnp.asarray(ks[2].numpy()),
        v_scale=jnp.asarray(vs[2].numpy()))
    assert gotb.dtype == torch.bfloat16
    np.testing.assert_allclose(gotb.float().numpy(),
                               np.asarray(wantb, np.float32), rtol=2 ** -7,
                               atol=1e-5)


@pytest.mark.parametrize("pos", [3, [0, 5, 120, 64]])
def test_scaled_window_twin_matches_jax(pos):
    """The window twin and dispatcher against JAX's scaled window
    reference, within 1e-5; each window row is the scaled decode twin at
    pos + t."""
    b, t, h, dh, s = 4, 6, 4, 16, 128
    q = _rand((b, t, h, dh), 40)
    k, ks = _quant_cache((2, b, s, h * dh), 41)
    v, vs = _quant_cache((2, b, s, h * dh), 42)
    # JAX's window reference takes a [B] vector; the port's, a scalar too
    jp = jnp.broadcast_to(jnp.asarray(pos, jnp.int32), (b,))
    tp = torch.tensor(pos, dtype=torch.int32)
    want = jdec.reference_window_attention(
        jnp.asarray(q), jnp.asarray(k[1].numpy()), jnp.asarray(v[1].numpy()),
        jp, 4, k_scale=jnp.asarray(ks[1].numpy()),
        v_scale=jnp.asarray(vs[1].numpy()))
    got = tdec.decode_window_attention(torch.from_numpy(q), k, v, tp,
                                       n_heads=4, layer=1,
                                       k_scale=ks[..., None],
                                       v_scale=vs[..., None])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    for ti in range(t):
        row = tdec.reference_decode_attention(
            torch.from_numpy(q[:, ti]), k[1], v[1],
            torch.clamp(tp + ti, max=s - 1), 4, k_scale=ks[1],
            v_scale=vs[1])
        np.testing.assert_allclose(got[:, ti].numpy(), row.numpy(),
                                   rtol=0, atol=1e-6)


def test_quant_window_group_matches_the_kernel_source():
    """The Python side's rows a CTA of the quantized window kernel equals
    the source's QGROUP (the bound and the docs count its cache reads)."""
    src = (Path(tdec.__file__).resolve().parent.parent / "csrc"
           / "decode_window.cu").read_text()
    m = re.search(r"constexpr int QGROUP = (\d+);", src)
    assert m and int(m.group(1)) == tdec.DECODE_Q_WINDOW_GROUP


# ---------------------------------------------------------------------------
# mixture of experts
# ---------------------------------------------------------------------------

MOE = {**FIELDS, "n_experts": 4}


@pytest.fixture(scope="module")
def moe_trees():
    jp = jtf.init_params(jtf.TransformerConfig(**MOE), jax.random.PRNGKey(0))
    return jp, params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                 device="cpu")


def test_moe_quantize_params_matches_jax(moe_trees):
    """An MoE tree: the experts We1 [L, E, D, F] and We2 [L, E, F, D]
    quantize on axis -2 (scales [L, E, 1, out]), the router stays float;
    values and scales bit-equal to JAX's, key by key; a layer's slice
    dequantizes to JAX's dequantized slice; JAX's quantized tree converts
    to the same bytes."""
    jp, tp = moe_trees
    jqp = jqm.quantize_params(jp)
    tqp = tqm.quantize_params(tp)
    jl, tl = dict(_leaves(jqp)), dict(_leaves(tqp))
    assert jl.keys() == tl.keys()
    quantized = {k for k, v in tl.items() if isinstance(v, tq.QuantizedTensor)}
    assert quantized == {"embed", "Wout"} | {f"blocks/{n}" for n in (
        "Wq", "Wk", "Wv", "Wo", "We1", "We2")}
    for k in quantized:
        np.testing.assert_array_equal(tl[k].values.numpy(),
                                      np.asarray(jl[k].values), err_msg=k)
        np.testing.assert_array_equal(tl[k].scales.numpy(),
                                      np.asarray(jl[k].scales), err_msg=k)
    assert tqp["blocks"]["router"] is tp["blocks"]["router"]
    e, d, f = MOE["n_experts"], MOE["d_model"], 4 * MOE["d_model"]
    assert tqp["blocks"]["We1"].scales.shape == (2, e, 1, f)
    assert tqp["blocks"]["We2"].scales.shape == (2, e, 1, d)
    layer = tqp["blocks"]["We1"][1]
    assert layer.values.shape == (e, d, f) and layer.scales.shape == (e, 1, f)
    np.testing.assert_array_equal(
        layer.to(torch.float32).numpy(),
        np.asarray(jq.dequantize(jqp["blocks"]["We1"]))[1])
    conv = params_from_numpy(jax.tree_util.tree_map(np.asarray, jqp),
                             device="cpu")
    for n in ("We1", "We2"):
        assert torch.equal(conv["blocks"][n].values, tqp["blocks"][n].values)
        assert torch.equal(conv["blocks"][n].scales, tqp["blocks"][n].scales)


def test_moe_max_logit_divergence_matches_jax(moe_trees):
    """The MoE config's divergence of the int8 tree from the float one
    equals JAX's value within 1e-5, and the int8 MoE tree's greedy
    `generate` is JAX's token for token."""
    jp, tp = moe_trees
    jcfg, tcfg = jtf.TransformerConfig(**MOE), ttf.TransformerConfig(**MOE)
    toks = np.stack([(np.arange(16) * (s + 3)) % FIELDS["vocab_size"]
                     for s in range(4)]).astype(np.int32)
    jqp = jqm.quantize_params(jp)
    jdiv = jqm.max_logit_divergence(jcfg, jp, jqp, jnp.asarray(toks))
    tqp = tqm.quantize_params(tp)
    tdiv = tqm.max_logit_divergence(tcfg, tp, tqp, toks)
    assert abs(tdiv - jdiv) <= 1e-5, (tdiv, jdiv)
    out = ttf.generate(tcfg, tqp, torch.from_numpy(toks[:2, :8]), 6,
                       temperature=0.0)
    want = jtf.generate(jcfg, jqp, jnp.asarray(toks[:2, :8]), 6,
                        jax.random.PRNGKey(0), temperature=0.0)
    np.testing.assert_array_equal(out.numpy(), np.asarray(want))

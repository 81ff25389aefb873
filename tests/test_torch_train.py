"""Port parity: the TransformerLM train step of deeplearning4j_tpu_torch vs JAX.

One JAX `init_params` tree (seed 0) is converted with
`models.convert.params_from_numpy`, so both sides hold the same weights;
tokens and targets come from numpy with fixed seeds. JAX runs with
DL4JTPU_FLASH=interpret, so its attention and attention gradients go
through the Pallas flash kernels (interpret mode); the port runs on the
CPU with its plain twins (`flash_forward_reference`,
`flash_backward_reference`). Everything is float32 at 2 layers, d_model
64, T=32.

Tolerances, each stated with its test: loss 1e-5 and gradients 1e-5
(the same f32 math summed in other orders through two layers); the port
against itself (remat against none, chunked against dense loss) 1e-6;
Adam 1e-7 relative to the update; three train steps 1e-5 on the loss.
After three Adam steps the parameters are held by `_assert_adam_close`:
Adam divides each step by the gradient's own size, so a gradient that
differs by f32 noise delta (~5e-7 here) moves its parameter by about
lr * delta / |g|. That is under 1e-5 wherever |g| > 5e-5, but an element
whose gradient lies within the noise of zero can take a step of the other
sign: at most 2 * lr per step. So all but 1e-3 of each leaf's elements
must agree within 1e-5, and every element within 2 * lr * steps.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from deeplearning4j_tpu.models import transformer as jtf  # noqa: E402
from deeplearning4j_tpu.parallel import fsdp as jfsdp  # noqa: E402
from deeplearning4j_tpu.parallel import optim as joptim  # noqa: E402
from deeplearning4j_tpu.parallel.mesh import MeshSpec, make_mesh  # noqa

from deeplearning4j_tpu_torch.models import transformer as ttf  # noqa
from deeplearning4j_tpu_torch.models.convert import (  # noqa: E402
    adam_state_from_numpy, params_from_numpy)
from deeplearning4j_tpu_torch.parallel import optim as toptim  # noqa
from deeplearning4j_tpu_torch.parallel.fsdp import \
    make_fsdp_train_step  # noqa: E402

FIELDS = dict(vocab_size=64, d_model=64, n_heads=4, n_layers=2, max_len=64)
B, T = 2, 32
F32 = dict(rtol=0, atol=1e-5)
SELF = dict(rtol=0, atol=1e-6)


@pytest.fixture(autouse=True)
def _interpret_mode(monkeypatch):
    monkeypatch.setenv("DL4JTPU_FLASH", "interpret")


@pytest.fixture(scope="module")
def jparams():
    return jtf.init_params(jtf.TransformerConfig(**FIELDS),
                           jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def tree(jparams):
    return jax.tree_util.tree_map(np.asarray, jparams)


def _batch(seed=1):
    toks = np.random.default_rng(seed).integers(
        0, FIELDS["vocab_size"], size=(B, T)).astype(np.int32)
    return toks, np.roll(toks, -1, axis=1)


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + k + "/")
        else:
            yield prefix + k, v


def _port_value_and_grad(cfg, tree, toks, tgts):
    params = params_from_numpy(tree, device="cpu")
    leaves = dict(_flat(params))
    for t in leaves.values():
        t.requires_grad_()
    loss = ttf.loss_fn(cfg, params, torch.from_numpy(toks),
                       torch.from_numpy(tgts))
    loss.backward()
    grads = {k: t.grad.numpy() for k, t in leaves.items()}
    return float(loss.detach()), grads


def _jax_value_and_grad(cfg, jparams, toks, tgts):
    loss, g = jax.value_and_grad(lambda p: jtf.loss_fn(
        cfg, p, jnp.asarray(toks), jnp.asarray(tgts)))(jparams)
    return float(loss), {k: np.asarray(v) for k, v in _flat(g)}


def _assert_adam_close(got, want, lr, steps, name):
    diff = np.abs(got - want)
    assert diff.max() <= 2 * lr * steps, (name, diff.max())
    share = float((diff > 1e-5).mean())
    assert share <= 1e-3, (name, share, diff.max())


def _assert_grads(got, want, tol):
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], **tol, err_msg=k)


@pytest.mark.parametrize("xent_chunk", [0, 16])
def test_loss_and_gradients_match_jax(jparams, tree, xent_chunk):
    """Dense (xent_chunk 0) and chunked (4 panels of 16) loss: value and
    every gradient leaf against jax.value_and_grad(loss_fn); 1e-5."""
    fields = {**FIELDS, "xent_chunk": xent_chunk}
    toks, tgts = _batch()
    want_l, want_g = _jax_value_and_grad(jtf.TransformerConfig(**fields),
                                         jparams, toks, tgts)
    got_l, got_g = _port_value_and_grad(ttf.TransformerConfig(**fields),
                                        tree, toks, tgts)
    assert abs(got_l - want_l) <= 1e-5
    _assert_grads(got_g, want_g, F32)


def test_chunked_cross_entropy_equals_dense_loss(tree):
    """Same loss and gradients as the dense path, in the port; 1e-6."""
    toks, tgts = _batch(2)
    dense = _port_value_and_grad(ttf.TransformerConfig(**FIELDS), tree,
                                 toks, tgts)
    chunked = _port_value_and_grad(
        ttf.TransformerConfig(**FIELDS, xent_chunk=8), tree, toks, tgts)
    assert abs(dense[0] - chunked[0]) <= 1e-6
    _assert_grads(chunked[1], dense[1], SELF)


def test_chunked_cross_entropy_rejects_indivisible_vocab():
    h = torch.zeros(2, 3, 8)
    with pytest.raises(ValueError, match="not divisible by xent_chunk 5"):
        ttf.chunked_cross_entropy(h, torch.zeros(8, 64),
                                  torch.zeros(2, 3, dtype=torch.int64), 5)


@pytest.mark.parametrize("policy", ["full", "mlp", "dots"])
def test_remat_gradients_match_no_remat_and_jax(jparams, tree, policy):
    """remat recomputes, never changes, the gradients: equal to the
    port without remat (1e-6) and to JAX with the same policy (1e-5)."""
    toks, tgts = _batch(3)
    remat = {**FIELDS, "remat": True, "remat_policy": policy}
    plain = _port_value_and_grad(ttf.TransformerConfig(**FIELDS), tree,
                                 toks, tgts)
    got = _port_value_and_grad(ttf.TransformerConfig(**remat), tree, toks,
                               tgts)
    want = _jax_value_and_grad(jtf.TransformerConfig(**remat), jparams,
                               toks, tgts)
    assert abs(got[0] - plain[0]) <= 1e-6
    _assert_grads(got[1], plain[1], SELF)
    assert abs(got[0] - want[0]) <= 1e-5
    _assert_grads(got[1], want[1], F32)


def _backward_matmuls(policy, tree):
    """aten.mm calls run by the backward of the loss (the gradient
    products plus whatever remat recomputes)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func is torch.ops.aten.mm.default:
                self.n += 1
            return func(*args, **(kwargs or {}))

    cfg = ttf.TransformerConfig(**FIELDS, remat=policy is not None,
                                remat_policy=policy or "full")
    params = params_from_numpy(tree, device="cpu")
    for t in dict(_flat(params)).values():
        t.requires_grad_()
    toks, tgts = _batch(8)
    loss = ttf.loss_fn(cfg, params, torch.from_numpy(toks),
                       torch.from_numpy(tgts))
    count = Count()
    with count:
        loss.backward()
    return count.n


def test_remat_dots_keeps_the_matrix_products(tree):
    """'dots' saves every x @ W and re-runs none in backward; 'full'
    re-runs them."""
    plain = _backward_matmuls(None, tree)
    assert _backward_matmuls("dots", tree) == plain
    assert _backward_matmuls("full", tree) > plain


def test_unknown_remat_policy_raises(tree):
    cfg = ttf.TransformerConfig(**FIELDS, remat=True, remat_policy="attn")
    toks, _ = _batch()
    with pytest.raises(ValueError, match="unknown remat_policy 'attn'"):
        ttf.forward(cfg, params_from_numpy(tree, device="cpu"),
                    torch.from_numpy(toks))


def test_adam_update_tree_matches_jax():
    """One Adam update at step 3 from random state: params, m and v
    within 1e-7 of JAX's (both sides float32, same operation order)."""
    rng = np.random.default_rng(4)

    def rnd():
        return {"a": rng.normal(size=(5, 7)).astype(np.float32),
                "b": {"c": rng.normal(size=(3,)).astype(np.float32)}}

    p, g, m = rnd(), rnd(), rnd()
    v = jax.tree_util.tree_map(np.abs, rnd())
    kw = dict(learning_rate=1e-2, b1=0.9, b2=0.999, eps=1e-8)
    want = joptim.adam_update_tree(p, g, m, v, jnp.float32(3), **kw)
    tt = [params_from_numpy(x, device="cpu") for x in (p, g, m, v)]
    got = toptim.adam_update_tree(*tt, 3, **kw)
    for gt, wt in zip(got, want):
        for (k, a), (_, b) in zip(_flat(gt), _flat(wt)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-7,
                                       atol=1e-7, err_msg=k)


def test_three_train_steps_match_jax(jparams, tree):
    """The port's make_fsdp_train_step against JAX's on a one-device mesh,
    three steps each from the same params (remat 'full'): every loss
    within 1e-5 and the parameters by `_assert_adam_close`. JAX's final
    AdamState, carried across with adam_state_from_numpy, matches the
    port's (m and v 1e-5, count exactly)."""
    cfg_f = {**FIELDS, "remat": True}
    jstep = jfsdp.make_fsdp_train_step(jtf.TransformerConfig(**cfg_f),
                                       make_mesh(MeshSpec()))
    step = make_fsdp_train_step(ttf.TransformerConfig(**cfg_f),
                                device="cpu")
    toks, tgts = _batch(5)
    jt, jy = jnp.asarray(toks), jnp.asarray(tgts)
    jp = jax.tree_util.tree_map(jnp.array, jparams)
    jopt = joptim.init_adam_state(jp)
    params = params_from_numpy(tree, device="cpu")
    opt = toptim.init_adam_state(params)
    for _ in range(3):
        jp, jopt, jloss = jstep(jp, jopt, jt, jy)
        params, opt, loss = step(params, opt, toks, tgts)
        assert abs(float(loss) - float(jloss)) <= 1e-5
    want = dict(_flat(jax.tree_util.tree_map(np.asarray, jp)))
    for k, t in _flat(params):
        _assert_adam_close(t.numpy(), want[k], 1e-3, 3, k)
    carried = adam_state_from_numpy(
        jax.tree_util.tree_map(np.asarray, jopt.m),
        jax.tree_util.tree_map(np.asarray, jopt.v), jopt.count,
        device="cpu")
    assert int(carried.count) == int(opt.count) == 3
    for got, mine in ((carried.m, opt.m), (carried.v, opt.v)):
        for (k, a), (_, b) in zip(_flat(got), _flat(mine)):
            np.testing.assert_allclose(a.numpy(), b.numpy(), **F32,
                                       err_msg=k)


def test_train_step_lowers_the_loss_in_place(tree):
    """Three steps on one batch: the loss falls, and the params and
    optimizer state passed in are the ones updated (donation)."""
    cfg = ttf.TransformerConfig(**FIELDS)
    params = params_from_numpy(tree, device="cpu")
    opt = toptim.init_adam_state(params)
    wq = params["blocks"]["Wq"]
    before = wq.clone()
    step = make_fsdp_train_step(cfg, device="cpu")
    toks, tgts = _batch(6)
    losses = []
    for _ in range(3):
        out_p, out_opt, loss = step(params, opt, toks, tgts)
        assert out_p is params and out_opt is opt
        losses.append(float(loss))
    assert losses[2] < losses[1] < losses[0]
    assert not torch.equal(wq, before) and params["blocks"]["Wq"] is wq
    assert int(opt.count) == 3


def test_transformer_lm_loss_is_loss_fn():
    lm = ttf.TransformerLM(ttf.TransformerConfig(**FIELDS), seed=3,
                           device="cpu")
    toks, tgts = _batch(7)
    want = ttf.loss_fn(lm.cfg, lm.params, torch.from_numpy(toks),
                       torch.from_numpy(tgts))
    assert lm.loss(toks, tgts) == pytest.approx(float(want), abs=0)


# ---------------------------------------------------------------------------
# mixture of experts
# ---------------------------------------------------------------------------

# 4 experts at capacity 0.75: a call's B*T = 64 tokens give each expert
# int(0.75 * 64 / 4) = 12 places, so tokens drop
MOE = {**FIELDS, "n_experts": 4, "capacity_factor": 0.75}


@pytest.fixture(scope="module")
def moe_jparams():
    return jtf.init_params(jtf.TransformerConfig(**MOE),
                           jax.random.PRNGKey(0))


@pytest.mark.parametrize("policy", [None, "full", "dots", "mlp"],
                         ids=["none", "full", "dots", "mlp"])
def test_moe_loss_and_gradients_match_jax(moe_jparams, policy):
    """An MoE config's loss and every gradient leaf (the router's reached
    only through each kept token's gate) against jax.value_and_grad, with
    each remat policy; 1e-5."""
    fields = dict(MOE, **({"remat": True, "remat_policy": policy}
                          if policy else {}))
    toks, tgts = _batch(9)
    want_l, want_g = _jax_value_and_grad(jtf.TransformerConfig(**fields),
                                         moe_jparams, toks, tgts)
    got_l, got_g = _port_value_and_grad(
        ttf.TransformerConfig(**fields),
        jax.tree_util.tree_map(np.asarray, moe_jparams), toks, tgts)
    assert abs(got_l - want_l) <= 1e-5
    _assert_grads(got_g, want_g, F32)
    assert np.abs(got_g["blocks/router"]).max() > 0


def test_moe_two_adam_steps_match_jax(moe_jparams):
    """Two steps of the port's train step against JAX's on an MoE
    config (remat 'full'): losses within 1e-5, parameters by
    `_assert_adam_close`."""
    cfg_f = {**MOE, "remat": True}
    jstep = jfsdp.make_fsdp_train_step(jtf.TransformerConfig(**cfg_f),
                                       make_mesh(MeshSpec()))
    step = make_fsdp_train_step(ttf.TransformerConfig(**cfg_f),
                                device="cpu")
    toks, tgts = _batch(10)
    jt, jy = jnp.asarray(toks), jnp.asarray(tgts)
    jp = jax.tree_util.tree_map(jnp.array, moe_jparams)
    jopt = joptim.init_adam_state(jp)
    params = params_from_numpy(
        jax.tree_util.tree_map(np.asarray, moe_jparams), device="cpu")
    opt = toptim.init_adam_state(params)
    for _ in range(2):
        jp, jopt, jloss = jstep(jp, jopt, jt, jy)
        params, opt, loss = step(params, opt, toks, tgts)
        assert abs(float(loss) - float(jloss)) <= 1e-5
    want = dict(_flat(jax.tree_util.tree_map(np.asarray, jp)))
    for k, t in _flat(params):
        _assert_adam_close(t.numpy(), want[k], 1e-3, 2, k)

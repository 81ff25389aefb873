"""Fully-sharded data parallelism of the port (parallel/fsdp.py) against
JAX (tests/test_fsdp.py:27-104).

The leaf rule, the shardings of the transformer's tree, `zero1_partition`
and `flatten_tree` / `unflatten_tree` are compared with JAX's directly.
One start of four gloo CPU ranks (module scope) runs the sharded step
(`make_fsdp_train_step(cfg, mesh)`) for 3 Adam steps (lr 1e-2) from one
JAX `init_params` tree: the loss within 1e-4 of JAX's single-device
step, every rank's shards within 5e-4 of the same slices of JAX's params
(tests/test_fsdp.py's tolerance), and each rank holding 1/N of every
sharded leaf of the params and of Adam's m, the rest whole.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from deeplearning4j_tpu.models import transformer as jtf  # noqa: E402
from deeplearning4j_tpu.parallel import fsdp as jfsdp  # noqa: E402
from deeplearning4j_tpu.parallel.mesh import MeshSpec as JSpec  # noqa
from deeplearning4j_tpu.parallel.mesh import make_mesh as jmake  # noqa

from deeplearning4j_tpu_torch.models import transformer as ttf  # noqa
from deeplearning4j_tpu_torch.parallel import fsdp as tfsdp  # noqa: E402
from deeplearning4j_tpu_torch.parallel.mesh import (MeshSpec,  # noqa: E402
                                                    shard_of)
from deeplearning4j_tpu_torch.parallel.multihost import \
    MultiHostLauncher  # noqa: E402

import torch_parallel_helpers as H  # noqa: E402

CFG = dict(vocab_size=50, d_model=32, n_heads=4, n_layers=4, max_len=32)
N = 4
STEPS = 3


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + k + "/"))
        else:
            out[prefix + k] = v
    return out


class _At:
    """A rank's place on a 'data' mesh of n, for `shard_of`."""

    def __init__(self, coords, n=N):
        self.shape, self.coords = MeshSpec(data=n).axis_sizes(), coords


@pytest.mark.parametrize("shape,size", [
    ((4, 32, 64), 8), ((50, 32), 8), ((7, 3), 8), ((), 8), ((8,), 8),
    ((64, 64), 1), ((12, 512, 2048), 4), ((2048, 512), 2), ((3, 6), 3)])
def test_fsdp_leaf_spec_rules_match_jax(shape, size):
    assert tuple(tfsdp.fsdp_leaf_spec(shape, size)) == \
        tuple(jfsdp.fsdp_leaf_spec(shape, size))


def test_fsdp_shardings_of_the_transformer_match_jax(devices8):
    """`param_shapes` is JAX's `eval_shape` of init_params, and the
    spec of every leaf is JAX's on data meshes of 2, 4 and 8."""
    for fields in (CFG, dict(CFG, n_experts=4)):
        jcfg = jtf.TransformerConfig(**fields)
        shapes = jax.eval_shape(lambda k: jtf.init_params(jcfg, k),
                                jax.random.PRNGKey(0))
        got = _flat(tfsdp.param_shapes(ttf.TransformerConfig(**fields)))
        want = _flat(jax.tree_util.tree_map(lambda s: tuple(s.shape),
                                            shapes))
        assert got == want
        for n in (2, 4, 8):
            jm = jmake(JSpec(data=n), devices=devices8)
            js = _flat(jax.tree_util.tree_map(
                lambda s: s.spec, jfsdp.fsdp_shardings(shapes, jm)))
            ts = _flat(tfsdp.fsdp_shardings(
                tfsdp.param_shapes(ttf.TransformerConfig(**fields)),
                _At({}, n)))
            assert {k: tuple(v) for k, v in ts.items()} == \
                {k: tuple(v) for k, v in js.items()}


@pytest.mark.parametrize("n,k", [(0, 1), (10, 3), (7, 7), (5, 8), (1024, 4)])
def test_zero1_partition_matches_jax(n, k):
    assert tfsdp.zero1_partition(n, k) == jfsdp.zero1_partition(n, k)


def test_zero1_partition_rejects_bad_sizes():
    with pytest.raises(ValueError, match="n_params"):
        tfsdp.zero1_partition(-1, 2)
    with pytest.raises(ValueError, match="n_shards"):
        tfsdp.zero1_partition(4, 0)


def test_flatten_unflatten_match_jax():
    rng = np.random.RandomState(0)
    tree = {"b": {"z": rng.randn(3, 2).astype(np.float32),
                  "a": rng.randn(4).astype(np.float32)},
            "a": np.float32(2.5), "c": rng.randn(2, 2, 2)}
    vec = tfsdp.flatten_tree(tree)
    np.testing.assert_array_equal(vec, jfsdp.flatten_tree(tree))
    assert vec.dtype == np.float32
    ttree = {"b": {"z": torch.from_numpy(tree["b"]["z"]),
                   "a": torch.from_numpy(tree["b"]["a"])},
             "a": torch.tensor(2.5), "c": torch.from_numpy(tree["c"])}
    np.testing.assert_array_equal(tfsdp.flatten_tree(ttree), vec)
    back = tfsdp.unflatten_tree(vec * 2, tree)
    want = jfsdp.unflatten_tree(vec * 2, tree)
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(want)):
        np.testing.assert_array_equal(a, b)
        assert a.shape == b.shape
    with pytest.raises(ValueError, match="template needs"):
        tfsdp.unflatten_tree(vec[:-1], tree)
    assert tfsdp.flatten_tree({}).shape == (0,)


@pytest.fixture(scope="module")
def jax_run():
    cfg = jtf.TransformerConfig(**CFG)
    p = jtf.init_params(cfg, jax.random.PRNGKey(0))
    p_np = jax.tree_util.tree_map(np.array, p)     # the step donates p
    rng = np.random.RandomState(0)
    toks = rng.randint(0, 50, (8, 32)).astype(np.int32)
    tgts = np.roll(toks, -1, 1).astype(np.int32)
    mesh = jmake(JSpec())
    params = jfsdp.shard_params_fsdp(p, mesh)
    opt = jfsdp.init_fsdp_adam_state(params)
    step = jfsdp.make_fsdp_train_step(cfg, mesh, learning_rate=1e-2)
    for _ in range(STEPS):
        params, opt, loss = step(params, opt, jnp.asarray(toks),
                                 jnp.asarray(tgts))
    return (p_np, (toks, tgts),
            _flat(jax.tree_util.tree_map(np.asarray, params)), float(loss))


@pytest.fixture(scope="module")
def ranks(jax_run):
    p, data, _, _ = jax_run
    cases = [("fsdp", "fsdp", CFG, dict(data=N), "p", "d",
              {"steps": STEPS})]
    return MultiHostLauncher(N, device="cpu").run(
        H.train_cases_job, timeout=240, args=(cases, {"p": p}, {"d": data}))


def test_sharded_step_matches_jax(jax_run, ranks):
    _, _, want, want_loss = jax_run
    specs = _flat(tfsdp.fsdp_shardings(tfsdp.param_shapes(
        ttf.TransformerConfig(**CFG)), _At({})))
    for r in ranks:
        rec = r["fsdp"]
        assert len(rec["losses"]) == STEPS
        assert abs(rec["losses"][-1] - want_loss) < 1e-4
        assert rec["losses"][-1] == ranks[0]["fsdp"]["losses"][-1]
        for k, v in rec["params"].items():
            np.testing.assert_allclose(
                v, shard_of(want[k], specs[k], _At(rec["coords"])),
                atol=5e-4, rtol=0, err_msg=k)


def test_each_rank_holds_one_nth_of_every_sharded_leaf(ranks):
    specs = _flat(tfsdp.fsdp_shardings(tfsdp.param_shapes(
        ttf.TransformerConfig(**CFG)), _At({})))
    assert tuple(specs["blocks/Wq"]) == (None, "data", None)
    assert tuple(specs["embed"]) == (None, "data")
    for r in ranks:
        rec = r["fsdp"]
        for part in ("params", "m"):
            for k, v in rec[part].items():
                full = rec["full_sizes"][k]
                assert v.size == (full // N if specs[k] else full), k

"""Composite-parallel training of the port (parallel/megatron.py) against
JAX, on the meshes of tests/test_megatron.py.

One start of eight gloo CPU ranks (module scope) runs every case of
`torch_parallel_helpers.train_cases_job` from one JAX `init_params` tree
(converted by `models.convert.params_from_numpy`) and numpy-seeded
tokens: TP, SP, PP (gpipe and 1F1B, :106-112, :149-154), the
composites, 1F1B with the chunked loss and remat, Ulysses (:92), expert
parallelism over 'data' (:123) and the chunked loss on {data=2, model=2,
seq=2} (:294-305). JAX's oracle is its own: single-device training of
the same tree (`_train(cfg, MeshSpec())`, computed once a module), which
JAX's suite holds every one of its meshes to. Losses within 1e-4, every
rank's shards within ATOL_TRAIN = 5e-3 of the same slices of JAX's
params after 2 Adam steps (lr 1e-2), the loss the same on every rank,
data replicas bit-equal. Also `make_parallel_train_step`'s validation
messages against JAX's and `pipeline_bubble_fraction`.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402

from deeplearning4j_tpu.models import transformer as jtf  # noqa: E402
from deeplearning4j_tpu.parallel import megatron as jmeg  # noqa: E402
from deeplearning4j_tpu.parallel.mesh import MeshSpec as JSpec  # noqa
from deeplearning4j_tpu.parallel.mesh import make_mesh as jmake  # noqa

from deeplearning4j_tpu_torch.models import transformer as ttf  # noqa
from deeplearning4j_tpu_torch.parallel import megatron as tmeg  # noqa
from deeplearning4j_tpu_torch.parallel.mesh import (MeshSpec,  # noqa: E402
                                                    shard_of, spec_axes)
from deeplearning4j_tpu_torch.parallel.multihost import \
    MultiHostLauncher  # noqa: E402

import torch_parallel_helpers as H  # noqa: E402

ATOL_TRAIN = 5e-3
CFG = dict(vocab_size=50, d_model=32, n_heads=4, n_layers=4, max_len=32)
MOE = dict(CFG, n_layers=2, n_experts=4, capacity_factor=8.0)
V64 = dict(CFG, vocab_size=64)
ULY = dict(CFG, seq_impl="ulysses")
XR = dict(CFG, xent_chunk=25, remat=True)
ONE_F = {"pipeline_schedule": "1f1b"}

# name, config, mesh axes, params / data key, options
CASES = [
    ("tp", CFG, dict(model=2), "cfg", {}),
    ("sp", CFG, dict(seq=2), "cfg", {}),
    ("pp", CFG, dict(pipe=2), "cfg", {}),
    ("pp-dp-tp", CFG, dict(pipe=2, data=2, model=2), "cfg", {}),
    ("pp-sp-tp", CFG, dict(pipe=2, seq=2, model=2), "cfg", {}),
    ("1f1b-pp2", CFG, dict(pipe=2), "cfg", ONE_F),
    ("1f1b-pp4", CFG, dict(pipe=4), "cfg", ONE_F),
    ("1f1b-pp2-m4", CFG, dict(pipe=2), "cfg",
     dict(ONE_F, n_microbatches=4)),
    ("gpipe-pp2-m4", CFG, dict(pipe=2), "cfg", {"n_microbatches": 4}),
    ("1f1b-pp-dp-tp", CFG, dict(pipe=2, data=2, model=2), "cfg", ONE_F),
    ("1f1b-xent-remat", XR, dict(pipe=2, model=2), "cfg",
     dict(ONE_F, n_microbatches=4)),
    ("ulysses-sp", ULY, dict(seq=2), "cfg", {}),
    ("ulysses-sp-tp", ULY, dict(seq=2, model=2), "cfg", {}),
    ("ep", MOE, dict(data=4), "moe", {}),
    ("xent-dp-tp-sp", dict(V64, xent_chunk=16), dict(data=2, model=2, seq=2),
     "v64", {}),
    ("dense-dp-tp-sp", V64, dict(data=2, model=2, seq=2), "v64", {}),
    ("decreases", CFG, dict(pipe=2, data=2, model=2), "cfg", {"steps": 8}),
]
BASES = {"cfg": CFG, "moe": MOE, "v64": V64}

# (config, mesh axes, options) that make_parallel_train_step refuses
CHECKS = [
    (CFG, dict(pipe=2), {"pipeline_schedule": "interleaved"}),
    (dict(CFG, n_layers=3), dict(pipe=2), {}),
    (CFG, dict(model=3), {}),
    (dict(CFG, n_experts=3), dict(data=2), {}),
    (dict(CFG, seq_impl="allgather"), dict(seq=2), {}),
    (ULY, dict(seq=4, model=2), {}),
    (CFG, dict(expert=2), {}),
]


def _data(seed=0, b=8, t=32, vocab=50):
    rng = np.random.RandomState(seed)
    toks = rng.randint(0, vocab, (b, t)).astype(np.int32)
    return toks, np.roll(toks, -1, 1).astype(np.int32)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + k + "/"))
        else:
            out[prefix + k] = v
    return out


class _At:
    """A rank's place in a mesh, for `shard_of`."""

    def __init__(self, axes, coords):
        self.shape, self.coords = MeshSpec(**axes).axis_sizes(), coords


@pytest.fixture(scope="module")
def setup():
    """JAX's params (numpy), tokens and single-device training."""
    params, data, base = {}, {}, {}
    for key, fields in BASES.items():
        cfg = jtf.TransformerConfig(**fields)
        p = jtf.init_params(cfg, jax.random.PRNGKey(0))
        params[key] = jax.tree_util.tree_map(np.asarray, p)
        toks, tgts = _data(vocab=fields["vocab_size"])
        data[key] = (toks, tgts)
        step = jmeg.make_parallel_train_step(cfg, jmake(JSpec()),
                                             learning_rate=1e-2)
        ps = jmeg.shard_params(p, cfg, jmake(JSpec()))
        st = jmeg.init_adam_state(ps)
        for _ in range(2):
            ps, st, loss = step(ps, st, toks, tgts)
        base[key] = (_flat(jax.tree_util.tree_map(np.asarray, ps)),
                     float(loss))
    return params, data, base


@pytest.fixture(scope="module")
def ranks(setup):
    params, data, _ = setup
    cases = [(n, "megatron", f, a, k, k, o) for n, f, a, k, o in CASES]
    checks = [(f, a, o) for f, a, o in CHECKS]
    return MultiHostLauncher(8, device="cpu").run(
        H.megatron_module_job, timeout=400,
        args=(cases, params, data, checks))


def _case(ranks, name):
    return [r["train"][name] for r in ranks if name in r["train"]]


@pytest.mark.parametrize("name,fields,axes,key,opts",
                         [c for c in CASES if c[0] != "decreases"],
                         ids=[c[0] for c in CASES if c[0] != "decreases"])
def test_parallel_training_matches_jax(setup, ranks, name, fields, axes,
                                       key, opts):
    """Loss within 1e-4 of JAX's single-device training, every rank's
    shards within ATOL_TRAIN of the same slices of JAX's params, the
    loss the same on every rank, data replicas bit-equal."""
    _, _, base = setup
    want, want_loss = base[key]
    recs = _case(ranks, name)
    assert len(recs) == MeshSpec(**axes).n_devices
    assert len({r["losses"][-1] for r in recs}) == 1
    assert abs(recs[0]["losses"][-1] - want_loss) < 1e-4
    specs = _flat(tmeg.param_specs(ttf.TransformerConfig(**fields)))
    for r in recs:
        at = _At(axes, r["coords"])
        for k, v in r["params"].items():
            np.testing.assert_allclose(v, shard_of(want[k], specs[k], at),
                                       atol=ATOL_TRAIN, rtol=0,
                                       err_msg=f"{name} {k} {r['coords']}")
    if axes.get("data", 1) > 1:
        for a in recs:
            for b in recs:
                if a["coords"]["data"] == 0 and b["coords"]["data"] > 0 \
                        and {k: v for k, v in a["coords"].items()
                             if k != "data"} == {
                            k: v for k, v in b["coords"].items()
                            if k != "data"}:
                    for k, v in a["params"].items():
                        if "data" not in spec_axes(specs[k]):
                            np.testing.assert_array_equal(v, b["params"][k])


def test_1f1b_matches_gpipe(ranks):
    """1F1B is a re-scheduling: the same loss and params as gpipe."""
    fb, gp = _case(ranks, "1f1b-pp2-m4"), _case(ranks, "gpipe-pp2-m4")
    assert abs(fb[0]["losses"][-1] - gp[0]["losses"][-1]) < 1e-5
    for a, b in zip(fb, gp):
        assert a["coords"] == b["coords"]
        for k in a["params"]:
            np.testing.assert_allclose(a["params"][k], b["params"][k],
                                       atol=ATOL_TRAIN, rtol=0)


def test_chunked_xent_matches_dense_on_the_mesh(ranks):
    """:294-305: the chunked loss on {data=2, model=2, seq=2} equals the
    dense loss on the same mesh (loss rtol 1e-5, params rtol 2e-2)."""
    c, d = _case(ranks, "xent-dp-tp-sp"), _case(ranks, "dense-dp-tp-sp")
    np.testing.assert_allclose(c[0]["losses"], d[0]["losses"], rtol=1e-5)
    for a, b in zip(c, d):
        for k in a["params"]:
            np.testing.assert_allclose(a["params"][k], b["params"][k],
                                       rtol=2e-2, atol=1e-4)


def test_parallel_loss_decreases(ranks):
    losses = _case(ranks, "decreases")[0]["losses"]
    assert len(losses) == 8 and losses[-1] < losses[0]


def test_param_specs_match_jax():
    for fields in (CFG, MOE):
        got = _flat(tmeg.param_specs(ttf.TransformerConfig(**fields)))
        want = _flat(jmeg.param_specs(jtf.TransformerConfig(**fields)))
        assert got.keys() == want.keys()
        for k in got:
            assert tuple(got[k]) == tuple(want[k]), k


def test_validation_messages_match_jax(devices8, ranks):
    got = ranks[0]["validation"]
    assert len(got) == len(CHECKS)
    for (fields, axes, opts), msg in zip(CHECKS, got):
        with pytest.raises(ValueError) as e:
            jmeg.make_parallel_train_step(jtf.TransformerConfig(**fields),
                                          jmake(JSpec(**axes)), **opts)
        assert msg == str(e.value)


def test_pipeline_bubble_fraction_matches_jax():
    for sched in ("gpipe", "1f1b"):
        for s in (1, 2, 4, 8):
            for m in (1, 4, 8, 32):
                assert tmeg.pipeline_bubble_fraction(sched, s, m) == \
                    jmeg.pipeline_bubble_fraction(sched, s, m)
    assert tmeg.pipeline_bubble_fraction("gpipe", 4, 8) == \
        pytest.approx(3 / 11)
    assert tmeg.pipeline_bubble_fraction("1f1b", 4, 8) == \
        pytest.approx(6 / 14)
    assert (tmeg.pipeline_bubble_fraction("1f1b", 4, 32)
            < tmeg.pipeline_bubble_fraction("gpipe", 4, 8))
    with pytest.raises(ValueError, match="unknown"):
        tmeg.pipeline_bubble_fraction("zb-h1", 4, 8)

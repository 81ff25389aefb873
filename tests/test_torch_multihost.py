"""The port's multi-process runtime (parallel/multihost.py, mesh.py,
collectives.py) on CPU ranks.

One `MultiHostLauncher` start of four gloo ranks (module scope) runs
`torch_parallel_helpers.multihost_module_job`: the all-reduce over every
rank and the data-parallel MLP of tests/test_multihost.py:40,82 (every
process ends with the same parameters, equal to one process training on
the whole batch), and each rank's coordinates in a set of meshes, which
must be the coordinates JAX's `make_mesh` gives the same device index on
conftest's virtual devices. Two more short starts hold the launcher to
its failure contract: a rank that raises fails the run with its error,
a rank that hangs is killed at the timeout.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402

from deeplearning4j_tpu.parallel import mesh as jmesh  # noqa: E402

from deeplearning4j_tpu_torch.parallel import collectives as C  # noqa
from deeplearning4j_tpu_torch.parallel import multihost as tmh  # noqa
from deeplearning4j_tpu_torch.parallel.mesh import (AXES,  # noqa: E402
                                                    MeshSpec, make_mesh)

import torch_parallel_helpers as H  # noqa: E402

RANKS = 4
MESHES = [dict(data=4), dict(data=2, model=2), dict(pipe=2, seq=2),
          dict(pipe=2, data=2), dict(seq=2, model=2), dict(model=4),
          dict(pipe=2, model=2), dict(data=2)]


@pytest.fixture(scope="module")
def ranks():
    return tmh.MultiHostLauncher(RANKS, device="cpu").run(
        H.multihost_module_job, timeout=240, args=(MESHES,))


def test_launcher_all_reduce_sees_every_rank(ranks):
    assert len(ranks) == RANKS
    for r in ranks:
        p = r["psum"]
        assert p["process_count"] == RANKS
        assert p["global_device_count"] == RANKS
        assert p["local_device_count"] == 1
        assert p["backend"] == "gloo" and p["device"] == "cpu"
        assert p["sum"] == sum(range(RANKS))
    assert sorted(r["psum"]["process_index"] for r in ranks) == \
        list(range(RANKS))


def test_data_parallel_training_identical_params(ranks):
    """Every process holds bit-equal replicated parameters after three
    data-parallel steps, and they equal one process's full-batch steps."""
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    p0 = ranks[0]["train"]["params"]
    for r in ranks[1:]:
        np.testing.assert_array_equal(r["train"]["params"], p0)
    net = MultiLayerNetwork(H.mlp_conf(), device="cpu").init()
    rng = np.random.default_rng(0)
    x = rng.normal(size=(16, 4)).astype(np.float32)
    y = np.eye(2, dtype=np.float32)[rng.integers(0, 2, 16)]
    for _ in range(3):
        net.fit(x, y)
    np.testing.assert_allclose(p0, net.params_flat().numpy(), atol=1e-6)
    assert abs(ranks[0]["train"]["score"] - float(net.score_value)) < 1e-6


@pytest.mark.parametrize("i", range(len(MESHES)),
                         ids=[",".join(f"{k}={v}" for k, v in m.items())
                              for m in MESHES])
def test_mesh_rank_order_matches_jax(ranks, devices8, i):
    """Rank r sits where JAX's mesh puts device r: the same shard of a
    parameter lands on the same rank index on both sides."""
    jm = jmesh.make_mesh(jmesh.MeshSpec(**MESHES[i]), devices=devices8)
    assert tuple(jm.axis_names) == AXES
    for r, rec in enumerate(ranks):
        got = rec["meshes"][i]
        n = MeshSpec(**MESHES[i]).n_devices
        assert got["member"] == (r < n)
        assert tuple(got["axis_names"]) == AXES
        assert got["shape"] == dict(jm.shape)
        if r < n:
            pos = np.argwhere(np.vectorize(lambda d: d.id)(jm.devices)
                              == devices8[r].id)[0]
            assert got["coords"] == {a: int(p) for a, p in zip(AXES, pos)}


def test_single_rank_mesh_needs_no_process_group():
    m = make_mesh(MeshSpec(), device="cpu")
    assert m.member and m.size == 1 and m.group("data") is None
    assert m.coords == {a: 0 for a in AXES}
    x = torch.arange(4.0)
    assert C.all_reduce(x, m.group("data")) is x
    with pytest.raises(ValueError, match="mesh needs 2 devices, have 1"):
        make_mesh(MeshSpec(data=2), device="cpu")
    with pytest.raises(ValueError, match="either a MeshSpec or axis"):
        make_mesh(MeshSpec(), data=1, device="cpu")


def test_initialize_multihost_env_defaults(monkeypatch):
    """Arguments default to MASTER_ADDR / MASTER_PORT, WORLD_SIZE and
    RANK, as the reference's default to JAX_*; the backend to the rule."""
    seen = {}

    def fake_init(backend, init_method, world_size, rank, timeout):
        seen.update(backend=backend, init_method=init_method,
                    world_size=world_size, rank=rank)
    monkeypatch.setattr(tmh.dist, "init_process_group", fake_init)
    monkeypatch.setattr(tmh, "_DEVICE", None)
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(ValueError, match="MASTER_ADDR"):
        tmh.initialize_multihost(device="cpu")
    monkeypatch.setenv("MASTER_ADDR", "10.0.0.7")
    monkeypatch.setenv("MASTER_PORT", "29512")
    with pytest.raises(ValueError, match="WORLD_SIZE"):
        tmh.initialize_multihost(device="cpu")
    monkeypatch.setenv("WORLD_SIZE", "8")
    monkeypatch.setenv("RANK", "3")
    tmh.initialize_multihost(device="cpu")
    assert seen == dict(backend="gloo", init_method="tcp://10.0.0.7:29512",
                        world_size=8, rank=3)
    assert tmh.rank_device() == torch.device("cpu")
    tmh.initialize_multihost("127.0.0.1:1234", 2, 1, device="cpu",
                             backend="gloo")
    assert seen["init_method"] == "tcp://127.0.0.1:1234"
    assert (seen["world_size"], seen["rank"]) == (2, 1)


def test_backend_rule():
    """NCCL only when every rank has a card of its own; gloo for CPU
    ranks and for ranks sharing a card (NCCL refuses a duplicate GPU)."""
    assert tmh.choose_backend("cpu", 4) == "gloo"
    assert tmh.choose_backend("cuda", 4, n_cards=1) == "gloo"
    assert tmh.choose_backend("cuda", 4, n_cards=4) == "nccl"
    assert tmh.choose_backend("cuda:0", 2, n_cards=8) == "nccl"
    assert "share 1 card" in tmh.backend_rule("cuda", 4, n_cards=1)
    assert tmh.backend_rule("cuda", 4, n_cards=4).startswith(
        "backend=nccl")
    assert tmh.backend_rule("cpu", 2) == "backend=gloo: 2 CPU ranks"
    with pytest.raises(ValueError, match="devices_per_process"):
        tmh.MultiHostLauncher(2, devices_per_process=2)


def test_routing_table_is_fixed():
    """One (backend, op) table: gloo stages only its point-to-point
    sends of CUDA tensors through host buffers; NCCL stages nothing; CPU
    tensors are never staged."""
    assert set(C.HOST_STAGED) == {(b, o) for b in ("gloo", "nccl")
                                  for o in C.OPS}
    staged = sorted(k for k, v in C.HOST_STAGED.items() if v)
    assert staged == [("gloo", "send_recv")]
    assert not C._staged("send_recv", None, [torch.zeros(2)])
    rows = C.table()
    assert len(rows) == 10 and {r["route"] for r in rows} == {"host",
                                                              "direct"}


def test_launcher_reports_a_failed_rank_and_kills_a_hung_one():
    with pytest.raises(RuntimeError) as e:
        tmh.MultiHostLauncher(2, device="cpu", verbose=False).run(
            H.fails_on_rank_one, timeout=120)
    assert "rank 1: rc=1" in str(e.value)
    assert "rank one gives up" in str(e.value)
    with pytest.raises(RuntimeError, match="rank 0: timeout"):
        tmh.MultiHostLauncher(2, device="cpu", verbose=False).run(
            H.hangs_on_rank_zero, timeout=12)

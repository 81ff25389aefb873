"""The port's elastic training math (deeplearning4j_tpu_torch/train/
elastic.py) held against JAX's (deeplearning4j_tpu/train/elastic.py) on
the CPU, in one process, no worker processes.

- the data cursor and the wire text are byte-equal to JAX's over a grid
  of (step, microbatch, seed) and of float32 vectors; the port's pipe
  lines are json's bytes;
- `reduce_grads` / `reduce_losses` are bit-equal, `zero1_partition`
  equal, flatten / unflatten round trips exact;
- `param_template`'s leaves, in `parallel.fsdp._sorted_leaves` order,
  have the keys and shapes of JAX's `jax.eval_shape` template, so a JAX
  flat vector IS the port's (the weight carry-over of this slice);
- loss and gradient of JAX's narrow CFG (tests/test_elastic_training.py)
  from JAX's `init_flat_params` vector agree within 1e-5;
- `apply_adam_slice` is within 1e-6 of JAX's, and slice-wise is
  bit-equal to the full vector in the port, on any partition;
- `reference_run` over 4 steps from JAX's vector (the port's
  `init_flat_params` replaced by JAX's, in this process) matches JAX's
  `reference_run` within 1e-5 in losses and params;
- `ElasticFaultInjector` fires one-shot as JAX's does;
- with the subsystem imported and its config built, non-elastic
  training is bit-identical and its scrape has no `training_elastic_*`
  series (registration is lazy).
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402

from deeplearning4j_tpu.models.transformer import \
    TransformerConfig as JCfg  # noqa: E402
from deeplearning4j_tpu.parallel import failure as jfail  # noqa: E402
from deeplearning4j_tpu.parallel import fsdp as jfsdp  # noqa: E402
from deeplearning4j_tpu.train import elastic as je  # noqa: E402

from deeplearning4j_tpu_torch.models.transformer import \
    TransformerConfig  # noqa: E402
from deeplearning4j_tpu_torch.parallel import failure as tfail  # noqa
from deeplearning4j_tpu_torch.parallel import fsdp as tfsdp  # noqa: E402
from deeplearning4j_tpu_torch.train import elastic as te  # noqa: E402

#: JAX's narrow config (tests/test_elastic_training.py:46)
KW = dict(vocab_size=32, d_model=16, n_heads=2, n_layers=1, max_len=16)
CFG = TransformerConfig(**KW)
JCFG = JCfg(**KW)


def _ecfgs(tmp_path, **kw):
    base = dict(checkpoint_dir=str(tmp_path / "ckpt"), num_workers=3,
                microbatches_per_step=6, microbatch_size=2, seq_len=8,
                checkpoint_every=1)
    base.update(kw)
    return te.ElasticConfig(**base), je.ElasticConfig(**base)


@pytest.fixture(scope="module")
def jax_flat():
    return je.init_flat_params(JCFG, params_seed=3)


# ---------------------------------------------------------------------------
# the data cursor and the wire
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("vocab,seq,rows", [(32, 8, 2), (256, 33, 4),
                                            (50, 32, 4)])
def test_data_batch_byte_equal(vocab, seq, rows):
    for step in (0, 1, 5, 1000):
        for mb in (0, 3, 7):
            for seed in (0, 1, 17):
                got = te.data_batch(vocab, seq, rows, step, mb, seed)
                want = je.data_batch(vocab, seq, rows, step, mb, seed)
                for g, w in zip(got, want):
                    assert g.dtype == w.dtype and g.shape == w.shape
                    assert g.tobytes() == w.tobytes()


@pytest.mark.parametrize("n", [0, 1, 7, 4099])
def test_wire_text_byte_equal(n):
    rng = np.random.default_rng(n)
    a = rng.standard_normal(n).astype(np.float32)
    if n > 4:
        a[:4] = [np.nan, np.inf, -0.0, 1e-40]
    assert te.enc_array(a) == je.enc_array(a)
    # float64 input is cast the same way on both sides
    assert te.enc_array(a.astype(np.float64)) == je.enc_array(
        a.astype(np.float64))
    back = te.dec_array(te.enc_array(a))
    assert back.tobytes() == a.tobytes() and back.flags.writeable


@pytest.mark.parametrize("n", [3, 70000])
def test_pipe_lines_are_the_reference_json(n):
    """`_WorkerProc.send` queues json.dumps' bytes for the writer thread
    and counts them on the wire; every float32 field read back from the
    line is the vector's bits."""
    import threading
    from queue import Queue
    rng = np.random.default_rng(n)
    vecs = [rng.standard_normal(n).astype(np.float32) for _ in range(3)]
    texts = [te.enc_array(v) for v in vecs]
    objs = [{"op": "grads", "epoch": 2, "step": 7, "mbs": [0, 3],
             "params": texts[0]},
            {"ev": "grads", "epoch": None, "step": 1, "mbs": [1, 2],
             "g": texts[1:], "loss": [1.5, 0.25]},
            {"ev": "shard", "lo": 0, "hi": n, "p": texts[0], "m": texts[1],
             "v": texts[2]},
            {"ev": "error", "msg": 'a "quoted" \\ message', "x": 1.0}]
    w = object.__new__(te._WorkerProc)       # no process behind it
    w.wire, w.dead, w._outbox = te._new_wire(), threading.Event(), Queue()
    sent = 0
    for obj in objs:
        want = (json.dumps(obj) + "\n").encode()
        assert w.send(obj)
        assert w._outbox.get_nowait() == want
        sent += len(want)
        assert w.wire["sent_bytes"] == sent
        back = json.loads(want)
        assert back == obj
        for k, v in back.items():
            for x in (v if isinstance(v, list) else [v]):
                if isinstance(x, str) and x in texts:
                    assert te.dec_array(x).tobytes() == \
                        vecs[texts.index(x)].tobytes()
    w.dead.set()
    assert not w.send(objs[0]) and w._outbox.empty()


def test_reduce_grads_and_losses_bit_equal():
    rng = np.random.default_rng(0)
    gs = [rng.standard_normal(1000).astype(np.float32) * 10 ** k
          for k in range(-3, 3)]
    got, want = te.reduce_grads(gs), je.reduce_grads(gs)
    assert got.dtype == np.float32 and got.tobytes() == want.tobytes()
    ls = [float(np.float32(x)) for x in rng.standard_normal(6)]
    assert te.reduce_losses(ls) == je.reduce_losses(ls)


def test_zero1_partition_and_flatten_match_jax():
    for n, k in ((10, 3), (4528, 3), (7, 7), (5, 8), (0, 2), (100, 1)):
        assert tfsdp.zero1_partition(n, k) == jfsdp.zero1_partition(n, k)
    flat = te.init_flat_params(CFG, params_seed=3)
    tree = tfsdp.unflatten_tree(flat, te.param_template(CFG))
    assert np.array_equal(tfsdp.flatten_tree(tree), flat)
    with pytest.raises(ValueError):
        tfsdp.unflatten_tree(flat[:-1], te.param_template(CFG))


# ---------------------------------------------------------------------------
# the template, the weight carry-over, the gradient
# ---------------------------------------------------------------------------

def _port_paths(tree, prefix=()):
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in _port_paths(tree[k], prefix + (k,))]
    return [("/".join(prefix), tuple(tree.shape))]


def _jax_paths(tree):
    return [("/".join(str(p.key) for p in path), tuple(leaf.shape))
            for path, leaf in jax.tree_util.tree_leaves_with_path(tree)]


@pytest.mark.parametrize("extra", [{}, {"n_experts": 4},
                                   {"n_layers": 3, "max_len": 64}],
                         ids=["dense", "moe", "deeper"])
def test_param_template_has_jax_keys_and_shapes(extra):
    kw = dict(KW, **extra)
    tmpl = te.param_template(TransformerConfig(**kw))
    assert _port_paths(tmpl) == _jax_paths(je.param_template(JCfg(**kw)))
    leaves = tfsdp._sorted_leaves(tmpl)
    assert all(x.dtype == torch.float32 and x.device.type == "meta"
               for x in leaves)
    n = sum(x.numel() for x in leaves)
    assert n == te.init_flat_params(TransformerConfig(**kw)).size


def test_loss_and_grad_from_jax_vector(jax_flat):
    """JAX's flat init IS the port's flat vector: unflattened by the
    port's template it gives the loss and gradient JAX's gives."""
    tok, tgt = je.data_batch(32, 8, 2, 3, 1, 0)
    jvg = je.make_grad_fn(JCFG)
    jloss, jg = jvg(jfsdp.unflatten_tree(jax_flat, je.param_template(JCFG)),
                    tok, tgt)
    vg = te.make_grad_fn(CFG, "cpu")
    loss, g = vg(tfsdp.unflatten_tree(jax_flat, te.param_template(CFG)),
                 tok, tgt)
    assert loss.dtype == torch.float32
    assert abs(float(loss) - float(jloss)) < 1e-5
    got, want = tfsdp.flatten_tree(g), jfsdp.flatten_tree(jg)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    # one device-side concatenation gives the leaf-by-leaf bytes
    assert np.array_equal(got, np.concatenate(
        [tfsdp._as_numpy(x).ravel() for x in tfsdp._sorted_leaves(g)]))
    # the same call twice: the same bits (deterministic algorithms on,
    # the process-wide flag restored after)
    again = tfsdp.flatten_tree(vg(tfsdp.unflatten_tree(
        jax_flat, te.param_template(CFG)), tok, tgt)[1])
    assert got.tobytes() == again.tobytes()
    assert not torch.are_deterministic_algorithms_enabled()


# ---------------------------------------------------------------------------
# Adam on shards
# ---------------------------------------------------------------------------

def _adam_inputs(n, seed=0):
    rng = np.random.default_rng(seed)
    p = rng.standard_normal(n).astype(np.float32)
    g = rng.standard_normal(n).astype(np.float32)
    m = (rng.standard_normal(n) * 0.1).astype(np.float32)
    v = np.abs(rng.standard_normal(n) * 0.01).astype(np.float32)
    return p, g, m, v


HYPER = dict(learning_rate=1e-3, b1=0.9, b2=0.999, eps=1e-8)


@pytest.mark.parametrize("t", [1, 2, 37])
def test_apply_adam_slice_matches_jax(t):
    p, g, m, v = _adam_inputs(5000, seed=t)
    got = te.apply_adam_slice(p, g, m, v, t, **HYPER)
    want = je.apply_adam_slice(p, g, m, v, t, **HYPER)
    for a, b in zip(got, want):
        assert isinstance(a, np.ndarray) and a.dtype == np.float32
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("k", [1, 2, 3, 7])
def test_apply_adam_slice_wise_is_bit_equal_to_full(k):
    """The ZeRO-1 resharding invariant, on numpy and on tensors."""
    p, g, m, v = _adam_inputs(4097, seed=k)
    full = te.apply_adam_slice(p, g, m, v, 3, **HYPER)
    parts = [te.apply_adam_slice(p[lo:hi], g[lo:hi], m[lo:hi], v[lo:hi],
                                 3, **HYPER)
             for lo, hi in tfsdp.zero1_partition(p.size, k)]
    for i in range(3):
        cat = np.concatenate([part[i] for part in parts])
        assert cat.tobytes() == full[i].tobytes()
    tp = [torch.from_numpy(x.copy()) for x in (p, g, m, v)]
    tfull = te.apply_adam_slice(*tp, 3, **HYPER)
    assert all(isinstance(x, torch.Tensor) for x in tfull)
    for i in range(3):
        assert tfull[i].numpy().tobytes() == full[i].tobytes()
    # the inputs are untouched
    assert np.array_equal(tp[0].numpy(), p)


# ---------------------------------------------------------------------------
# the oracle
# ---------------------------------------------------------------------------

def test_reference_run_matches_jax(tmp_path, monkeypatch, jax_flat):
    """Four steps from JAX's flat init (the port's init replaced by it
    in this process): losses and final params within 1e-5 of JAX's
    oracle."""
    tcfg, jcfg = _ecfgs(tmp_path, params_seed=3)
    want = je.reference_run(JCFG, jcfg, 4)
    monkeypatch.setattr(te, "init_flat_params",
                        lambda cfg, params_seed=0: je.init_flat_params(
                            JCFG, params_seed))
    got = te.reference_run(CFG, tcfg, 4, device="cpu")
    assert got["steps"] == 4 and got["n_params"] == want["n_params"]
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5,
                               atol=1e-5)
    assert got["final_loss"] == got["losses"][-1]
    assert got["params"].dtype == np.float32
    np.testing.assert_allclose(got["params"], want["params"], rtol=1e-5,
                               atol=1e-5)
    # training moved the params and the loss
    assert not np.array_equal(got["params"], jax_flat)
    assert got["losses"][-1] < got["losses"][0]


def test_reference_run_is_deterministic(tmp_path):
    tcfg, _ = _ecfgs(tmp_path, microbatches_per_step=3)
    a = te.reference_run(CFG, tcfg, 2, device="cpu")
    b = te.reference_run(CFG, tcfg, 2, device="cpu")
    assert a["losses"] == b["losses"]
    assert a["params"].tobytes() == b["params"].tobytes()


# ---------------------------------------------------------------------------
# fault injector, config, metrics
# ---------------------------------------------------------------------------

def _drive_injector(mod):
    inj = mod.ElasticFaultInjector(kill_at={3: 1, "5": 2},
                                   hang_at={4: 0},
                                   slow_at={2: (1, 0.5), 6: [1, 0]},
                                   join_at={5: 3})
    fired = []
    for step in (0, 1, 2, 3, 4, 5, 3, 4, 5, 6, 6):   # a rewind replays
        fired.append((inj.check_kill(step), inj.check_hang(step),
                      inj.check_slow(step), inj.check_join(step)))
    return fired, (inj.kills_injected, inj.hangs_injected,
                   inj.slows_injected, inj.joins_injected)


def test_fault_injector_fires_one_shot_as_jax():
    got = _drive_injector(tfail)
    assert got == _drive_injector(jfail)
    assert got[1] == (2, 1, 2, 1)


def test_elastic_config_defaults_match_jax(tmp_path):
    from dataclasses import asdict
    t, j = _ecfgs(tmp_path)
    assert asdict(t) == asdict(j)
    assert asdict(te.ElasticConfig("d")) == asdict(je.ElasticConfig("d"))


def test_register_elastic_metrics_names_match_jax():
    from deeplearning4j_tpu.observability.metrics import \
        MetricsRegistry as JReg
    from deeplearning4j_tpu_torch.observability.metrics import \
        MetricsRegistry
    treg, jreg = MetricsRegistry(), JReg()
    tm, jm = te.register_elastic_metrics(treg), je.register_elastic_metrics(
        jreg)
    assert sorted(tm) == sorted(jm)
    # get-or-create: a second registration returns the same families
    assert te.register_elastic_metrics(treg)["workers"] is tm["workers"]


def test_elastic_off_training_is_unchanged(tmp_path):
    """With the subsystem imported and its config built, a port
    FaultTolerantTrainer run is bit-identical to one without, and its
    scrape carries no training_elastic_* series."""
    from deeplearning4j_tpu_torch.datasets.iterators import \
        BaseDatasetIterator
    from deeplearning4j_tpu_torch.nn.conf.configuration import \
        NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.layers.feedforward import DenseLayer
    from deeplearning4j_tpu_torch.nn.layers.output import OutputLayer
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.observability.export import \
        prometheus_text
    from deeplearning4j_tpu_torch.observability.metrics import \
        MetricsRegistry
    from deeplearning4j_tpu_torch.parallel.failure import \
        FaultTolerantTrainer

    rng = np.random.default_rng(0)
    x = rng.normal(size=(64, 6)).astype(np.float32)
    y = np.eye(2, dtype=np.float32)[rng.integers(0, 2, 64)]

    def _run(subdir, registry):
        conf = NeuralNetConfiguration(seed=7, updater="adam",
                                      learning_rate=0.01).list(
            DenseLayer(n_in=6, n_out=8, activation="tanh"),
            OutputLayer(n_out=2, activation="softmax",
                        loss_function="mcxent"))
        net = MultiLayerNetwork(conf, device="cpu").init()
        t = FaultTolerantTrainer(net, str(tmp_path / subdir),
                                 checkpoint_frequency=2,
                                 use_orbax=False, registry=registry)
        assert t.fit(BaseDatasetIterator(x, y, 16), epochs=1) is True
        return net.params_flat().numpy().copy()

    a = _run("a", MetricsRegistry())
    _ecfgs(tmp_path)
    reg = MetricsRegistry()
    b = _run("b", reg)
    assert np.array_equal(a, b)
    assert "training_elastic" not in prometheus_text(reg)
    te.register_elastic_metrics(reg)
    assert "training_elastic_workers" in prometheus_text(reg)

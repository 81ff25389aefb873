"""Rank bodies of the port's parallel tests (tests/test_torch_multihost.py,
test_torch_seq_parallel.py, test_torch_megatron.py,
test_torch_parallel_fsdp.py, test_torch_parallel_wrapper.py).

`parallel.multihost.MultiHostLauncher` starts each test module's ranks
once and runs one of these functions on every rank; the function runs
all of the module's cases in that one start and returns plain numpy /
Python results. This module imports torch and the port only, so a
spawned rank never imports jax through a test module.
"""
import numpy as np
import torch


def _one_thread():
    """One intra-op thread a rank: a module's ranks share the host's
    cores with each other and with the other test workers."""
    torch.set_num_threads(1)


def _np(t):
    return t.detach().to("cpu", torch.float32).numpy()


def _tree_np(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_tree_np(v, prefix + k + "/"))
        else:
            out[prefix + k] = _np(v)
    return out


# ---------------------------------------------------------------------------
# multihost
# ---------------------------------------------------------------------------

def psum_job():
    """Each rank contributes its index; the all-reduce must see all."""
    import torch.distributed as dist
    from deeplearning4j_tpu_torch.parallel import collectives as C
    from deeplearning4j_tpu_torch.parallel.multihost import process_info
    info = process_info()
    x = torch.tensor([float(dist.get_rank())])
    info["sum"] = float(C.all_reduce(x, dist.group.WORLD)[0])
    return info


def mlp_conf(seed=5):
    from deeplearning4j_tpu_torch.nn.conf.configuration import \
        NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.layers.feedforward import DenseLayer
    from deeplearning4j_tpu_torch.nn.layers.output import OutputLayer
    return NeuralNetConfiguration(seed=seed, learning_rate=0.1).list(
        DenseLayer(n_in=4, n_out=8, activation="tanh"),
        OutputLayer(n_out=2, activation="softmax", loss_function="mcxent"))


def train_job():
    """tests/test_multihost.py:_train_job: the same data-parallel step on
    every process; returns the flat parameters."""
    import torch.distributed as dist
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.parallel.wrapper import ParallelWrapper
    net = MultiLayerNetwork(mlp_conf(), device="cpu").init()
    pw = ParallelWrapper(net)
    rng = np.random.default_rng(0)       # same data on every process
    x = rng.normal(size=(16, 4)).astype(np.float32)
    y = np.eye(2, dtype=np.float32)[rng.integers(0, 2, 16)]
    for _ in range(3):
        pw.fit(x, y)
    return {"process": dist.get_rank(), "params": _np(net.params_flat()),
            "score": float(net.score_value)}


def mesh_job(specs):
    """Each rank's coordinates in each mesh of ``specs`` (axis dicts)."""
    from deeplearning4j_tpu_torch.parallel.mesh import MeshSpec, make_mesh
    out = []
    for axes in specs:
        m = make_mesh(MeshSpec(**axes))
        out.append({"member": m.member, "coords": dict(m.coords),
                    "axis_names": list(m.axis_names),
                    "shape": dict(m.shape)})
    return out


def fails_on_rank_one():
    import torch.distributed as dist
    if dist.get_rank() == 1:
        raise RuntimeError("rank one gives up")
    return "ok"


def hangs_on_rank_zero():
    import time
    import torch.distributed as dist
    if dist.get_rank() == 0:
        time.sleep(120)
    return "late"


def multihost_module_job(specs):
    """Everything tests/test_torch_multihost.py asks of one start."""
    _one_thread()
    return {"psum": psum_job(), "train": train_job(),
            "meshes": mesh_job(specs)}


# ---------------------------------------------------------------------------
# sequence parallelism
# ---------------------------------------------------------------------------

def seq_attention_job(cases):
    """Each case (name, impl, seq size, q, k, v, cotangent of the output,
    all [B, T, H, Dh] full arrays): this rank's output block and the
    q / k / v gradient blocks of sum(out * ct) over the ranks of a
    'seq' mesh of that size; members only."""
    _one_thread()
    from deeplearning4j_tpu_torch.parallel.mesh import MeshSpec, make_mesh
    from deeplearning4j_tpu_torch.parallel.ring import ring_attention
    from deeplearning4j_tpu_torch.parallel.ulysses import ulysses_attention
    out = {}
    for name, impl, s, q, k, v, ct in cases:
        mesh = make_mesh(MeshSpec(seq=s), devices=list(range(s)),
                         device="cpu")
        if not mesh.member:
            continue
        i = mesh.coords["seq"]
        tl = q.shape[1] // s

        def blk(a):
            return torch.from_numpy(a[:, i * tl:(i + 1) * tl].copy())
        ql, kl, vl = (blk(a).requires_grad_() for a in (q, k, v))
        fn = ring_attention if impl == "ring" else ulysses_attention
        try:
            o = fn(ql, kl, vl, mesh.group("seq"), causal=True)
        except ValueError as e:
            out[name] = {"index": i, "error": str(e)}
            continue
        (o * blk(ct)).sum().backward()
        out[name] = {"index": i, "out": _np(o), "dq": _np(ql.grad),
                     "dk": _np(kl.grad), "dv": _np(vl.grad)}
    return out


# ---------------------------------------------------------------------------
# composite-parallel and FSDP training
# ---------------------------------------------------------------------------

def _params(params_np):
    from deeplearning4j_tpu_torch.models.convert import params_from_numpy
    return params_from_numpy(params_np, device="cpu")


def train_cases_job(cases, params_by_key, data_by_key, steps=2, lr=1e-2):
    """Each case (name, kind, cfg fields, mesh axes, params key, data key,
    options): ``steps`` Adam steps on the mesh's ranks (the first
    prod(axes) ranks), kind "megatron" (`make_parallel_train_step`,
    options its keyword arguments) or "fsdp" (`make_fsdp_train_step`).
    Returns, per case, this rank's losses, coordinates and local shards
    of the params (and of m / v for fsdp) after the steps."""
    _one_thread()
    from deeplearning4j_tpu_torch.models.transformer import \
        TransformerConfig
    from deeplearning4j_tpu_torch.parallel import fsdp, megatron
    from deeplearning4j_tpu_torch.parallel.mesh import MeshSpec, make_mesh
    out = {}
    for name, kind, fields, axes, pkey, dkey, opts in cases:
        cfg = TransformerConfig(**fields)
        spec = MeshSpec(**axes)
        mesh = make_mesh(spec, devices=list(range(spec.n_devices)),
                         device="cpu")
        if not mesh.member:
            continue
        full = _params(params_by_key[pkey])
        toks, tgts = data_by_key[dkey]
        if kind == "megatron":
            ps = megatron.shard_params(full, cfg, mesh)
            opt = megatron.init_adam_state(ps)
            step = megatron.make_parallel_train_step(
                cfg, mesh, learning_rate=opts.get("lr", lr),
                **{k: v for k, v in opts.items()
                   if k not in ("lr", "steps")})
        else:
            ps = fsdp.shard_params_fsdp(full, mesh)
            opt = fsdp.init_fsdp_adam_state(ps)
            step = fsdp.make_fsdp_train_step(
                cfg, mesh, learning_rate=opts.get("lr", lr))
        losses = []
        for _ in range(opts.get("steps", steps)):
            ps, opt, loss = step(ps, opt, toks, tgts)
            losses.append(float(loss))
        out[name] = {"losses": losses, "coords": dict(mesh.coords),
                     "params": _tree_np(ps)}
        if kind == "fsdp":
            out[name]["m"] = _tree_np(opt.m)
            out[name]["full_sizes"] = {k: int(np.prod(v.shape))
                                       for k, v in _tree_np(full).items()}
    return out


def validation_job(checks):
    """The ValueErrors of `make_parallel_train_step` for each (cfg
    fields, mesh axes, options), as strings (None where it builds)."""
    from deeplearning4j_tpu_torch.models.transformer import \
        TransformerConfig
    from deeplearning4j_tpu_torch.parallel import megatron
    from deeplearning4j_tpu_torch.parallel.mesh import MeshSpec, make_mesh
    out = []
    for fields, axes, opts in checks:
        spec = MeshSpec(**axes)
        mesh = make_mesh(spec, devices=list(range(spec.n_devices)),
                         device="cpu")
        try:
            megatron.make_parallel_train_step(TransformerConfig(**fields),
                                              mesh, **opts)
            out.append(None)
        except ValueError as e:
            out.append(str(e))
    return out


def megatron_module_job(cases, params_by_key, data_by_key, checks):
    return {"train": train_cases_job(cases, params_by_key, data_by_key),
            "validation": validation_job(checks)}


# ---------------------------------------------------------------------------
# ParallelWrapper
# ---------------------------------------------------------------------------

def wrapper_conf(seed=42, updater="adam", n_in=6, n_out=3):
    from deeplearning4j_tpu_torch.nn.conf.configuration import \
        NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.layers.feedforward import DenseLayer
    from deeplearning4j_tpu_torch.nn.layers.output import OutputLayer
    return (NeuralNetConfiguration(seed=seed, updater=updater,
                                   learning_rate=0.05, activation="tanh")
            .list(DenseLayer(n_in=n_in, n_out=10),
                  OutputLayer(n_in=10, n_out=n_out, activation="softmax",
                              loss_function="mcxent")))


def graph_conf():
    from deeplearning4j_tpu_torch.nn.conf.configuration import \
        NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.layers.feedforward import DenseLayer
    from deeplearning4j_tpu_torch.nn.layers.output import OutputLayer
    return (NeuralNetConfiguration(seed=9, updater="adam",
                                   learning_rate=0.05)
            .graph_builder()
            .add_inputs("in")
            .add_layer("h", DenseLayer(n_in=6, n_out=10, activation="tanh"),
                       "in")
            .add_layer("out", OutputLayer(n_in=10, n_out=2,
                                          activation="softmax",
                                          loss_function="mcxent"), "h")
            .set_outputs("out")
            .build())


def cli_iterator_provider():
    """Module-level factory for the ParallelWrapperMain CLI test."""
    from deeplearning4j_tpu_torch.datasets.iterators import \
        BaseDatasetIterator
    rng = np.random.default_rng(0)
    x = rng.standard_normal((64, 4)).astype(np.float32)
    y = np.eye(2, dtype=np.float32)[(x.sum(1) > 0).astype(int)]
    return BaseDatasetIterator(x, y, batch_size=16)


def wrapper_job(data, workers, init, cli=None):
    """Everything tests/test_torch_parallel_wrapper.py asks of the
    ranks: fit on arrays (even and uneven), fit_batched on a network and
    a graph, output_batched, the iterator, and the CLI (rank 0 saves).
    Every network starts from the JAX weights in ``init``."""
    _one_thread()
    import torch.distributed as dist
    from deeplearning4j_tpu_torch.datasets.iterators import \
        BaseDatasetIterator
    from deeplearning4j_tpu_torch.nn.graph.computation_graph import \
        ComputationGraph
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.parallel.wrapper import ParallelWrapper
    out = {"rank": dist.get_rank()}

    def pw_of(net):
        return ParallelWrapper(net, workers=workers)

    def mlp():
        net = MultiLayerNetwork(wrapper_conf(), device="cpu").init()
        net.set_params_from_numpy(init["mlp"])
        return net

    net = mlp()
    pw = pw_of(net)
    for _ in range(10):
        pw.fit(data["x"], data["y"])
    out["fit"] = {"params": _np(net.params_flat()),
                  "score": float(net.score_value)}

    net = mlp()
    seen = []

    class Rec:
        def record_batch(self, n):
            seen.append(n)

        def iteration_done(self, model, it, score):
            pass

        def on_epoch_start(self, model):
            pass

        def on_epoch_end(self, model):
            pass
    net.set_listeners(Rec())
    pw_of(net).fit(data["x_odd"], data["y_odd"])
    out["uneven"] = {"iterations": net.iteration_count, "batches": seen,
                     "params": _np(net.params_flat())}

    net = mlp()
    pw = pw_of(net)
    scores = pw.fit_batched(data["xs"], data["ys"], epochs=2)
    errs = []
    for bad in ((data["xs"][:, :15], data["ys"][:, :15]),
                (data["xs"], data["ys"][:, :15])):
        try:
            pw.fit_batched(*bad)
        except ValueError as e:
            errs.append(str(e))
    out["fit_batched"] = {"scores": _np(scores),
                          "params": _np(net.params_flat()),
                          "iterations": net.iteration_count,
                          "errors": errs}

    g = ComputationGraph(graph_conf(), device="cpu").init()
    g.set_params_from_numpy(init["graph"])
    scores = pw_of(g).fit_batched(data["gxs"], data["gys"], epochs=2)
    out["graph"] = {"scores": _np(scores), "params": _np(g.params_flat())}

    net = mlp()
    pw = pw_of(net)
    res = pw.output_batched(data["oxs"])
    try:
        pw.output_batched(data["oxs"][:, :15])
        err = None
    except ValueError as e:
        err = str(e)
    out["output_batched"] = {"out": _np(res), "error": err}

    net = mlp()
    pw = ParallelWrapper(net, workers=min(workers, 4))
    it = BaseDatasetIterator(data["x"], data["y"], batch_size=32)
    for _ in range(5):
        pw.fit(it)
    out["iterator"] = {"iterations": net.iteration_count,
                       "score": float(net.score_value),
                       "params": _np(net.params_flat())}

    if cli is not None:
        from deeplearning4j_tpu_torch.parallel.main import main
        main(["--model-path", cli["src"], "--iterator-provider",
              "torch_parallel_helpers:cli_iterator_provider",
              "--epochs", "8", "--model-output", cli["out"],
              "--device", "cpu"])
        dist.barrier()
    return out

"""Import hygiene of the PyTorch/CUDA port, and its no-silent-CPU rule.

Every .py file of deeplearning4j_tpu_torch/ and chip_smoke.py is parsed
with `ast`; none may import jax, jaxlib or deeplearning4j_tpu (matched by
dotted prefix, so deeplearning4j_tpu_torch itself is allowed), nor h5py,
tf_keras or tensorflow, which the card's machine does not have (the Keras
import reads HDF5 itself). The entry points must raise when no CUDA
device is present and the caller did not ask for the CPU.
"""
import ast
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "deeplearning4j_tpu")


def _port_files():
    files = sorted((ROOT / "deeplearning4j_tpu_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py"]


def _forbidden(module: str) -> bool:
    return any(module == f or module.startswith(f + ".") for f in FORBIDDEN)


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module or ""


NOT_ON_THE_CARD = ("h5py", "tf_keras", "tensorflow")


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_h5py_or_keras(path):
    bad = [(line, mod) for line, mod in _imports(path)
           if any(mod == f or mod.startswith(f + ".")
                  for f in NOT_ON_THE_CARD)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


@pytest.mark.parametrize("module", [
    "deeplearning4j_tpu_torch.modelimport",
    "deeplearning4j_tpu_torch.keras_server",
    "deeplearning4j_tpu_torch.util.model_guesser"])
def test_keras_import_loads_no_h5py(module):
    """Importing the Keras import, the gateway server and ModelGuesser in
    a fresh interpreter loads neither h5py, tf_keras, tensorflow nor jax
    or the JAX package."""
    import subprocess
    import sys
    code = (f"import sys\nimport {module}\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'deeplearning4j_tpu', 'h5py', 'tf_keras', "
            "'tensorflow'))\n"
            "print(bad)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_keras_entry_points_raise_without_cuda(monkeypatch):
    import os
    from deeplearning4j_tpu_torch.keras_server import \
        DeepLearning4jEntryPoint
    from deeplearning4j_tpu_torch.modelimport import (
        import_keras_model_auto, load_vgg16)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mlp = os.path.join(ROOT, "tests", "fixtures", "real_mlp.h5")
    with pytest.raises(RuntimeError, match="CUDA"):
        import_keras_model_auto(mlp)
    with pytest.raises(RuntimeError, match="CUDA"):
        load_vgg16(mlp)
    with pytest.raises(RuntimeError, match="CUDA"):
        DeepLearning4jEntryPoint()
    assert import_keras_model_auto(mlp, device="cpu").device.type == "cpu"


def test_forbidden_prefix_rule():
    assert _forbidden("jax.numpy") and _forbidden("jaxlib")
    assert _forbidden("deeplearning4j_tpu.models.transformer")
    assert not _forbidden("deeplearning4j_tpu_torch.models")
    assert not _forbidden("jaxtyping")


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax(path):
    assert path.exists(), path
    bad = [(line, mod) for line, mod in _imports(path) if _forbidden(mod)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_entry_points_raise_without_cuda(monkeypatch):
    from deeplearning4j_tpu_torch.models.transformer import (
        TransformerConfig, TransformerLM, init_params)
    from deeplearning4j_tpu_torch.serving.engine import InferenceEngine
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = TransformerConfig(vocab_size=16, d_model=32, n_heads=2,
                            n_layers=1, max_len=16)
    with pytest.raises(RuntimeError, match="CUDA"):
        TransformerLM(cfg)
    params = init_params(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        InferenceEngine(cfg, params)
    with pytest.raises(RuntimeError, match="CUDA"):
        init_params(cfg)
    # an explicit CPU request is honoured
    assert TransformerLM(cfg, device="cpu").device.type == "cpu"
    assert InferenceEngine(cfg, params, device="cpu").device.type == "cpu"


def test_multilayer_network_raises_without_cuda(monkeypatch):
    from deeplearning4j_tpu_torch.models.convert import \
        network_params_from_numpy
    from deeplearning4j_tpu_torch.models.zoo import char_rnn_lstm
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        MultiLayerNetwork(char_rnn_lstm(8, hidden=4))
    with pytest.raises(RuntimeError, match="CUDA"):
        network_params_from_numpy({"layer_0": {}})
    net = MultiLayerNetwork(char_rnn_lstm(8, hidden=4), device="cpu")
    assert net.device.type == "cpu"


def test_port_reads_no_kernel_switches():
    """No environment variable selects or bypasses a kernel: the JAX
    package's DL4JTPU_FUSED_LSTM and DL4JTPU_WAVEFRONT have no
    counterpart in the port."""
    for path in _port_files():
        for line in path.read_text().splitlines():
            if "DL4JTPU_" in line:
                assert "environ" not in line and "getenv" not in line, \
                    f"{path.relative_to(ROOT)}: {line.strip()}"
    pkg = ROOT / "deeplearning4j_tpu_torch"
    for rel in ("ops/lstm.py", "nn/layers/recurrent.py",
                "nn/multilayer.py"):
        text = (pkg / rel).read_text()
        assert "environ" not in text and "getenv" not in text, rel


EXPERIMENTS = ("deeplearning4j_tpu_torch.benchmarks.headpack_experiment",
               "deeplearning4j_tpu_torch.benchmarks.decode_kernel_sweep")


def test_kernel_experiment_modules_are_checked():
    """The experiments and the ops modules that carry their kernels are
    among the files the import rule parses."""
    names = {str(p.relative_to(ROOT)) for p in _port_files()}
    for rel in ("benchmarks/__init__.py", "benchmarks/_timing.py",
                "benchmarks/headpack_experiment.py",
                "benchmarks/decode_kernel_sweep.py",
                "ops/flash_attention.py", "ops/flash_decode.py"):
        assert f"deeplearning4j_tpu_torch/{rel}" in names, rel


def test_kernel_experiments_load_no_jax():
    """Importing the experiments in a fresh interpreter loads no jax and
    nothing of the JAX package."""
    import subprocess
    import sys
    code = ("import sys\n"
            + "".join(f"import {m}\n" for m in EXPERIMENTS)
            + "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
              "('jax', 'jaxlib', 'deeplearning4j_tpu'))\n"
              "print(bad)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


@pytest.mark.parametrize("module", EXPERIMENTS)
def test_kernel_experiments_raise_without_cuda(monkeypatch, module):
    import importlib
    mod = importlib.import_module(module)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        mod.main(["--small"])


OBSERVABILITY = ("deeplearning4j_tpu_torch.observability",
                 "deeplearning4j_tpu_torch.util",
                 "deeplearning4j_tpu_torch.util.flops",
                 "deeplearning4j_tpu_torch.serving",
                 "deeplearning4j_tpu_torch.parallel.failure")


@pytest.mark.parametrize("module", OBSERVABILITY)
def test_observability_loads_no_jax(module):
    """Importing the observability package, the chip-peak table, the
    serving package (which wires them) and the fault injector in a fresh
    interpreter loads no jax and nothing of the JAX package."""
    import subprocess
    import sys
    code = (f"import sys\nimport {module}\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'deeplearning4j_tpu'))\n"
            "print(bad)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_observability_modules_are_checked():
    """The ten counterparts of the JAX package's observability modules
    and the chip-peak table are among the files the import rule parses."""
    names = {str(p.relative_to(ROOT)) for p in _port_files()}
    jax_mods = sorted(p.name for p in
                      (ROOT / "deeplearning4j_tpu" / "observability")
                      .glob("*.py"))
    assert len(jax_mods) == 10
    for name in jax_mods:
        assert f"deeplearning4j_tpu_torch/observability/{name}" in names
    assert "deeplearning4j_tpu_torch/util/flops.py" in names


PARALLEL = tuple(f"deeplearning4j_tpu_torch.parallel.{m}" for m in (
    "multihost", "mesh", "collectives", "ring", "ulysses", "megatron",
    "fsdp", "wrapper", "magicqueue", "main"))


def test_parallel_modules_are_checked():
    """Every module of the parallel runtime is among the files the
    import rule parses."""
    names = {str(p.relative_to(ROOT)) for p in _port_files()}
    for m in PARALLEL + ("deeplearning4j_tpu_torch.benchmarks.gloo_probe",):
        assert m.replace(".", "/") + ".py" in names, m


def test_parallel_modules_load_no_jax():
    """Importing the parallel runtime (and the package's lazy exports)
    in a fresh interpreter loads no jax and nothing of the JAX
    package."""
    import subprocess
    import sys
    code = ("import sys\n"
            + "".join(f"import {m}\n" for m in PARALLEL)
            + "from deeplearning4j_tpu_torch.parallel import (MeshSpec, "
              "ParallelWrapper, MultiHostLauncher, ring_attention)\n"
              "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
              "('jax', 'jaxlib', 'deeplearning4j_tpu'))\n"
              "print(bad)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_parallel_entry_points_raise_without_cuda(monkeypatch):
    """The launcher, the mesh and the single-device step run on CUDA
    unless the caller asks for the CPU."""
    from deeplearning4j_tpu_torch.models.transformer import \
        TransformerConfig
    from deeplearning4j_tpu_torch.parallel import fsdp, mesh, multihost
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(multihost, "_DEVICE", None)
    with pytest.raises(RuntimeError, match="CUDA"):
        multihost.MultiHostLauncher(2)
    with pytest.raises(RuntimeError, match="CUDA"):
        mesh.make_mesh(mesh.MeshSpec())
    with pytest.raises(RuntimeError, match="CUDA"):
        fsdp.make_fsdp_train_step(TransformerConfig())
    assert mesh.make_mesh(mesh.MeshSpec(), device="cpu").device.type == \
        "cpu"


ELASTIC = ("deeplearning4j_tpu_torch.train.elastic",
           "deeplearning4j_tpu_torch.train.elastic_worker",
           "deeplearning4j_tpu_torch.ui",
           "deeplearning4j_tpu_torch.ui.storage",
           "deeplearning4j_tpu_torch.scaleout",
           "deeplearning4j_tpu_torch.scaleout.util")


def test_elastic_and_scaleout_modules_are_checked():
    """The elastic coordinator, its worker, the stats storage and every
    scaleout module are among the files the import rule parses."""
    names = {str(p.relative_to(ROOT)) for p in _port_files()}
    for rel in ("train/elastic.py", "train/elastic_worker.py",
                "ui/storage.py", "scaleout/stats.py", "scaleout/util.py",
                "scaleout/training_master.py", "scaleout/listeners.py",
                "scaleout/parallel_trainer.py", "scaleout/__init__.py"):
        assert f"deeplearning4j_tpu_torch/{rel}" in names, rel


def test_elastic_and_scaleout_load_no_jax():
    """Importing the elastic coordinator, the worker module, the stats
    storage and the scaleout facades (and train's lazy exports) in a
    fresh interpreter loads no jax and nothing of the JAX package."""
    import subprocess
    import sys
    code = ("import sys\n"
            + "".join(f"import {m}\n" for m in ELASTIC)
            + "from deeplearning4j_tpu_torch.train import (ElasticConfig, "
              "ElasticCoordinator, reference_run)\n"
              "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
              "('jax', 'jaxlib', 'deeplearning4j_tpu'))\n"
              "print(bad)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_elastic_entry_points_raise_without_cuda(monkeypatch, tmp_path):
    """The coordinator, the oracle, the grad function and the elastic
    TrainingMaster run on CUDA unless the caller asks for the CPU; no
    worker is started when the device cannot be had."""
    from deeplearning4j_tpu_torch.models.transformer import \
        TransformerConfig
    from deeplearning4j_tpu_torch.scaleout.training_master import \
        ElasticTrainingMaster
    from deeplearning4j_tpu_torch.train import elastic
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = TransformerConfig(vocab_size=16, d_model=16, n_heads=2,
                            n_layers=1, max_len=16)
    ecfg = elastic.ElasticConfig(checkpoint_dir=str(tmp_path / "ck"))
    with pytest.raises(RuntimeError, match="CUDA"):
        elastic.ElasticCoordinator(cfg, ecfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        elastic.reference_run(cfg, ecfg, 1)
    with pytest.raises(RuntimeError, match="CUDA"):
        elastic.make_grad_fn(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        ElasticTrainingMaster(checkpoint_dir=str(tmp_path / "tm")).fit(
            cfg, 1)
    co = elastic.ElasticCoordinator(cfg, ecfg, device="cpu")
    assert co.device.type == "cpu" and not co.workers

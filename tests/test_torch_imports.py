"""Import hygiene of the PyTorch/CUDA port, and its no-silent-CPU rule.

Every .py file of deeplearning4j_tpu_torch/ and chip_smoke.py is parsed
with `ast`; none may import jax, jaxlib or deeplearning4j_tpu (matched by
dotted prefix, so deeplearning4j_tpu_torch itself is allowed). The entry
points must raise when no CUDA device is present and the caller did not
ask for the CPU.
"""
import ast
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

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

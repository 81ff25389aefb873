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

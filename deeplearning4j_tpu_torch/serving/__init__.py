"""serving subpackage of the PyTorch/CUDA port (see the package docstring).

Exports as the reference's `deeplearning4j_tpu/serving/__init__.py` does,
for what is ported: the engine, its config and errors, and the grammar
constraints. The compile cache, the fleet router, the disaggregated tiers
and the KV wire wait for their ROADMAP queue A items.
"""
from deeplearning4j_tpu_torch.serving.constrain import (  # noqa: F401
    CompiledGrammar, ConstraintError, ConstraintTable, compile_grammar,
    grammar_cache_clear, grammar_cache_info, normalize_constraint,
    schema_to_regex)
from deeplearning4j_tpu_torch.serving.engine import (  # noqa: F401
    MAX_PRIORITY, EngineConfig, InferenceEngine, OverloadError,
    QoSValidationError, RequestHandle, RequestStatus, validate_tenant,
    validate_tenant_priority)

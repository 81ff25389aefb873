"""serving subpackage of the PyTorch/CUDA port (see the package docstring).

Exports as the reference's `deeplearning4j_tpu/serving/__init__.py` does:
the engine, its config and errors, KV handoff and the KV wire format, the
compile cache, the grammar constraints, the replicated fleet
(`serving.fleet`: `Router`, in-process and subprocess replicas) and the
disaggregated prefill/decode tiers (`serving.disagg`: `TieredRouter`
and its per-tier `Autoscaler`).
"""
from deeplearning4j_tpu_torch.serving import kvwire  # noqa: F401
from deeplearning4j_tpu_torch.serving.compile_cache import (  # noqa: F401
    CompileCache, sweep_stray_caches)
from deeplearning4j_tpu_torch.serving.constrain import (  # noqa: F401
    CompiledGrammar, ConstraintError, ConstraintTable, compile_grammar,
    grammar_cache_clear, grammar_cache_info, normalize_constraint,
    schema_to_regex)
from deeplearning4j_tpu_torch.serving.disagg import (  # noqa: F401
    Autoscaler, AutoscalePolicy, TieredRouter)
from deeplearning4j_tpu_torch.serving.engine import (  # noqa: F401
    DEFAULT_PROGRAM_CACHE_SIZE, MAX_PRIORITY, DeadlineExceeded,
    EngineConfig, EngineDraining, EngineStopped, HandoffError,
    InferenceEngine, KVHandoff, OverloadError, QoSValidationError,
    RequestCancelled, RequestHandle, RequestQuarantined, RequestStatus,
    set_program_cache_size, validate_tenant, validate_tenant_priority)
from deeplearning4j_tpu_torch.serving.fleet import (  # noqa: F401
    FleetConfig, FleetHandle, InProcessReplica, ReplicaState, Router,
    SubprocessReplica, TenantCapExceeded)
from deeplearning4j_tpu_torch.serving.kvwire import (  # noqa: F401
    WIRE_VERSION, WireError, WireServer, decode_control, decode_handoff,
    encode_control, encode_handoff, frame_from_text, frame_to_text,
    recv_frame, requantize_handoff, send_frame, wire_call)

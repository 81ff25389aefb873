"""Distributed training on `torch.distributed` (port of
deeplearning4j_tpu/parallel).

The reference writes every parallelism strategy as a sharding of one
traced step over a TPU mesh. The port runs one process a rank on a
process group (`multihost`), lays the ranks out on the reference's mesh
axes (`mesh`), and writes the collectives out (`collectives`, the one
place that routes them): data parallelism (`wrapper.ParallelWrapper`,
`fsdp`), tensor, pipeline, sequence (`ring`, `ulysses`) and expert
parallelism (`megatron`).

The names below are the reference's exports, imported on first use, so
importing a submodule (the serving programs, the fault injectors) loads
none of the rest. Elastic training over worker processes is
`train.elastic` (its fault injector `failure.ElasticFaultInjector`); the
Spark-style facades over these are `scaleout`.
"""
import importlib

_EXPORTS = {
    "MeshSpec": "mesh", "make_mesh": "mesh",
    "ParallelWrapper": "wrapper",
    "init_fsdp_adam_state": "fsdp", "make_fsdp_train_step": "fsdp",
    "shard_params_fsdp": "fsdp",
    "ring_attention": "ring",
    "ulysses_attention": "ulysses",
    "initialize_multihost": "multihost", "process_info": "multihost",
    "MultiHostLauncher": "multihost",
    "FaultTolerantTrainer": "failure", "FaultInjector": "failure",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    if name in _EXPORTS:
        mod = importlib.import_module(
            f"deeplearning4j_tpu_torch.parallel.{_EXPORTS[name]}")
        return getattr(mod, name)
    raise AttributeError(name)

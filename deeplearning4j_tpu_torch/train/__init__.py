"""train subpackage of the PyTorch/CUDA port: updaters, the Solver and
its optimizers, listeners, the divergence guard, and elastic ZeRO-1
training over worker processes. The submodules are imported by their
own paths (`train.updaters`, `train.solvers`, `train.listeners`,
`train.guard`, `train.elastic`, `train.elastic_worker`); the elastic
names below are also importable from here, loaded on first use, so
importing this package loads none of them."""
import importlib

_EXPORTS = {
    "ElasticConfig": "elastic", "ElasticCoordinator": "elastic",
    "reference_run": "elastic", "register_elastic_metrics": "elastic",
    "data_batch": "elastic",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    if name in _EXPORTS:
        mod = importlib.import_module(
            f"deeplearning4j_tpu_torch.train.{_EXPORTS[name]}")
        return getattr(mod, name)
    raise AttributeError(name)

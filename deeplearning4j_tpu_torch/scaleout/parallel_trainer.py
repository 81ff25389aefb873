"""Early stopping over data-parallel training (port of
deeplearning4j_tpu/scaleout/parallel_trainer.py).

Parity with the reference's EarlyStoppingParallelTrainer (reference:
deeplearning4j-scaleout-parallelwrapper/.../EarlyStoppingParallelTrainer.java
(372 LoC): early-stopping loop where each epoch's fitting runs through
ParallelWrapper). Here `parallel.wrapper.ParallelWrapper`'s
data-parallel step does the multi-rank work (one rank with no process
group: the plain network); the early-stopping control loop is
unchanged.
"""
from __future__ import annotations

from typing import Optional

from deeplearning4j_tpu_torch.earlystopping.config import \
    EarlyStoppingConfiguration
from deeplearning4j_tpu_torch.earlystopping.trainer import \
    BaseEarlyStoppingTrainer
from deeplearning4j_tpu_torch.nn.multilayer import _unpack_batch
from deeplearning4j_tpu_torch.observability.tracing import span
from deeplearning4j_tpu_torch.parallel.wrapper import ParallelWrapper


class EarlyStoppingParallelTrainer(BaseEarlyStoppingTrainer):

    def __init__(self, config: EarlyStoppingConfiguration, net, train_iter,
                 workers: Optional[int] = None,
                 wrapper: Optional[ParallelWrapper] = None):
        super().__init__(config, net, train_iter)
        self.wrapper = wrapper or ParallelWrapper(net, workers=workers)

    def _fit_batch(self, batch) -> None:
        feats, labs, fmask, lmask = _unpack_batch(batch)
        # span: per-batch fit wall time lands in the
        # trace_span_seconds{span="scaleout/parallel_fit"} histogram
        # AND in profiler traces (record_function) when one is recording
        with span("scaleout/parallel_fit"):
            self.wrapper.fit(feats, labs,
                             lmask if lmask is not None else fmask)


class SparkEarlyStoppingTrainer(BaseEarlyStoppingTrainer):
    """Early stopping driven through the cluster-style distributed
    wrappers (reference: dl4j-spark/.../earlystopping/
    BaseSparkEarlyStoppingTrainer.java + SparkEarlyStoppingTrainer —
    each epoch fits via SparkDl4jMultiLayer/TrainingMaster instead of
    local fit). Here each epoch's batches run through a
    DistributedDl4jMultiLayer/DistributedComputationGraph, whose
    TrainingMaster splits the global batch over the ranks; the
    early-stopping control loop (score calculators, termination
    conditions, model savers) is the shared base."""

    def __init__(self, config: EarlyStoppingConfiguration,
                 distributed_model, train_iter):
        # the underlying net is what score calculators / savers see
        super().__init__(config, distributed_model.get_network(),
                         train_iter)
        self.distributed = distributed_model

    def _fit_batch(self, batch) -> None:
        feats, labs, fmask, lmask = _unpack_batch(batch)
        mask = lmask if lmask is not None else fmask
        with span("scaleout/spark_fit"):
            if mask is not None:
                # the TrainingMaster facade fits plain arrays; masked
                # (padded-sequence) batches go through the underlying
                # sharded wrapper, which honors them
                self.distributed.pw.fit(feats, labs, mask)
            else:
                self.distributed.fit(feats, labs)

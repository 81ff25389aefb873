"""Cluster-scale training facade: TrainingMaster SPI + distributed fit
(port of deeplearning4j_tpu/scaleout/training_master.py).

Parity with the reference's Spark layer (reference:
deeplearning4j-scaleout/spark/dl4j-spark/.../api/TrainingMaster.java:29-139
SPI; impl/paramavg/ParameterAveragingTrainingMaster.java — split RDD,
broadcast params, run workers, aggregate averages;
impl/multilayer/SparkDl4jMultiLayer.java:218 fit(JavaRDD);
impl/graph/SparkComputationGraph.java). The reference moves parameters
driver↔executor as byte arrays every averaging round; here the gradient
sync and the parameter residency are `parallel.wrapper.ParallelWrapper`'s
data-parallel step (one process a rank on `torch.distributed`, every
rank calling `fit` with the same global batches; one rank with no
process group is the plain network) — so the TrainingMaster CONFIGURES
the ranks and batching, and `fit` drives the ParallelWrapper path.
Averaging-frequency/RDD-export knobs are accepted for API parity and
documented as no-ops. `ElasticTrainingMaster` drives the elastic
worker-process fleet (`train.elastic`).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Iterable, Optional

import numpy as np

from deeplearning4j_tpu_torch.datasets.iterators import DataSet
from deeplearning4j_tpu_torch.parallel.wrapper import ParallelWrapper
from deeplearning4j_tpu_torch.scaleout.stats import (SparkTrainingStats,
                                                     timed_phase)


class TrainingMaster:
    """SPI (reference: api/TrainingMaster.java). Implementations decide
    how a dataset is partitioned into worker batches and how results
    combine."""

    def configure(self, model) -> ParallelWrapper:
        raise NotImplementedError

    def batches(self, data: Iterable[DataSet]) -> Iterable[DataSet]:
        raise NotImplementedError


@dataclass
class ParameterAveragingTrainingMaster(TrainingMaster):
    """Reference: ParameterAveragingTrainingMaster.Builder —
    batchSizePerWorker, averagingFrequency, workerPrefetchNumBatches,
    rddTrainingApproach/exportDirectory (no-op here: there is no RDD),
    repartition strategy (no-op: batches are already dense arrays)."""

    workers: Optional[int] = None
    batch_size_per_worker: int = 16
    averaging_frequency: int = 1          # parity; sync is per-step
    worker_prefetch_num_batches: int = 2  # parity
    collect_training_stats: bool = False
    stats: Optional[SparkTrainingStats] = None

    class Builder:
        def __init__(self, batch_size_per_worker: int = 16):
            self._kw = {"batch_size_per_worker": batch_size_per_worker}

        def workers(self, n: int):
            self._kw["workers"] = n
            return self

        def averaging_frequency(self, n: int):
            self._kw["averaging_frequency"] = n
            return self

        def worker_prefetch_num_batches(self, n: int):
            self._kw["worker_prefetch_num_batches"] = n
            return self

        def collect_training_stats(self, b: bool):
            self._kw["collect_training_stats"] = b
            return self

        def build(self) -> "ParameterAveragingTrainingMaster":
            return ParameterAveragingTrainingMaster(**self._kw)

    def configure(self, model) -> ParallelWrapper:
        pw = ParallelWrapper(model, workers=self.workers)
        if self.collect_training_stats:
            self.stats = SparkTrainingStats()
        return pw

    def global_batch(self, workers: int) -> int:
        return self.batch_size_per_worker * workers

    def batches(self, data):
        return data


@dataclass
class ElasticTrainingMaster(TrainingMaster):
    """TrainingMaster over the elastic process fleet: where
    ParameterAveragingTrainingMaster configures the ranks of a
    data-parallel step, this one drives `train/elastic.ElasticCoordinator`
    — N worker PROCESSES each owning a contiguous ZeRO-1 shard of the
    Adam state, with membership allowed to change mid-fit. Deterministic
    contract: the result of `fit` is bit-identical to
    `elastic.reference_run` for ANY membership trajectory that stays in
    strict sync. ``device`` is the workers' and the coordinator's (the
    card unless "cpu").

    `configure`/`batches` are not part of this master's path — the
    elastic fleet derives batches from the deterministic data cursor
    (`elastic.data_batch`), so there is no driver-side dataset to
    split (the reference's rddTrainingApproach has no analog here)."""

    checkpoint_dir: str = ""
    workers: int = 3
    microbatches_per_step: int = 6
    microbatch_size: int = 4
    seq_len: int = 8
    learning_rate: float = 1e-3
    checkpoint_every: int = 2
    sync_every: int = 2
    stale_bound: int = 4
    step_timeout_s: float = 30.0
    fault_injector: Any = None
    registry: Any = None
    recorder: Any = None
    device: Any = None

    class Builder:
        def __init__(self, checkpoint_dir: str):
            self._kw: dict = {"checkpoint_dir": checkpoint_dir}

        def workers(self, n: int):
            self._kw["workers"] = n
            return self

        def microbatches_per_step(self, n: int):
            self._kw["microbatches_per_step"] = n
            return self

        def microbatch_size(self, n: int):
            self._kw["microbatch_size"] = n
            return self

        def sync_every(self, n: int):
            self._kw["sync_every"] = n
            return self

        def stale_bound(self, n: int):
            self._kw["stale_bound"] = n
            return self

        def build(self) -> "ElasticTrainingMaster":
            return ElasticTrainingMaster(**self._kw)

    def elastic_config(self):
        from deeplearning4j_tpu_torch.train.elastic import ElasticConfig
        if not self.checkpoint_dir:
            raise ValueError("ElasticTrainingMaster needs a "
                             "checkpoint_dir (resizes reshard from the "
                             "last published checkpoint)")
        return ElasticConfig(
            checkpoint_dir=self.checkpoint_dir,
            num_workers=self.workers,
            microbatches_per_step=self.microbatches_per_step,
            microbatch_size=self.microbatch_size,
            seq_len=self.seq_len,
            learning_rate=self.learning_rate,
            checkpoint_every=self.checkpoint_every,
            sync_every=self.sync_every,
            stale_bound=self.stale_bound,
            step_timeout_s=self.step_timeout_s)

    def configure(self, model):
        raise NotImplementedError(
            "ElasticTrainingMaster trains through worker processes, "
            "not ParallelWrapper — call fit(cfg, num_steps)")

    def batches(self, data):
        return data

    def fit(self, model_cfg, num_steps: int) -> dict:
        """Run ``num_steps`` elastic steps of the transformer described
        by ``model_cfg`` (a TransformerConfig); returns the
        coordinator's result dict (final params/loss, membership and
        replay counters)."""
        from deeplearning4j_tpu_torch.train.elastic import ElasticCoordinator
        with ElasticCoordinator(model_cfg, self.elastic_config(),
                                fault_injector=self.fault_injector,
                                registry=self.registry,
                                recorder=self.recorder,
                                device=self.device) as co:
            return co.run(num_steps)


class _DistributedModelBase:
    """Shared driver for the Spark-wrapper analogs."""

    def __init__(self, model, training_master: TrainingMaster):
        self.model = model
        self.tm = training_master
        self.pw = training_master.configure(model)

    @property
    def stats(self) -> Optional[SparkTrainingStats]:
        return getattr(self.tm, "stats", None)

    def _fit_arrays(self, feats: np.ndarray, labels: np.ndarray) -> None:
        workers = self.pw.workers
        gb = self.tm.global_batch(workers) if isinstance(
            self.tm, ParameterAveragingTrainingMaster) else 32 * workers
        stats = self.stats
        n = feats.shape[0]
        for s in range(0, n, gb):
            xb, yb = feats[s:s + gb], labels[s:s + gb]
            if stats is not None:
                with timed_phase(stats, "fit"):
                    self.pw.fit(xb, yb)
            else:
                self.pw.fit(xb, yb)

    def fit(self, data, labels=None):
        """fit(iterator), fit(features, labels), or fit(path) over
        exported minibatch files (reference:
        SparkDl4jMultiLayer.fit(JavaRDD<DataSet>):218 / fit(String path)
        :234 with the Export approach's batch files)."""
        import os
        if isinstance(data, (str, os.PathLike)):
            from deeplearning4j_tpu_torch.scaleout.util import \
                PathDataSetIterator
            data = PathDataSetIterator(os.fspath(data))
        if labels is not None:
            self._fit_arrays(np.asarray(data), np.asarray(labels))
            return self.model
        stats = self.stats
        if stats is not None:
            # time only the split setup; keep batches LAZY — the Export
            # approach exists because the dataset may not fit in RAM
            with timed_phase(stats, "split"):
                batches = self.tm.batches(data)
        else:
            batches = self.tm.batches(data)
        for ds in batches:
            f = np.asarray(ds.features)
            l = np.asarray(ds.labels)
            self._fit_arrays(f, l)
        if hasattr(data, "reset"):
            data.reset()
        return self.model

    def evaluate(self, iterator):
        """Reference: SparkDl4jMultiLayer evaluation on RDDs
        (impl/multilayer/evaluation) — here the model's own evaluator."""
        return self.model.evaluate(iterator)

    def score(self, feats, labels) -> float:
        return self.model.score(feats, labels)

    def get_network(self):
        return self.model


class DistributedDl4jMultiLayer(_DistributedModelBase):
    """Reference: SparkDl4jMultiLayer (spark/impl/multilayer/
    SparkDl4jMultiLayer.java). The SparkContext argument has no analog —
    the ranks of the process group play the cluster's role."""


class DistributedComputationGraph(_DistributedModelBase):
    """Reference: SparkComputationGraph (spark/impl/graph/)."""

    def _fit_arrays(self, feats, labels) -> None:
        # ComputationGraph fit takes lists of inputs/labels
        workers = self.pw.workers
        gb = self.tm.global_batch(workers) if isinstance(
            self.tm, ParameterAveragingTrainingMaster) else 32 * workers
        n = feats.shape[0]
        for s in range(0, n, gb):
            self.model.fit([feats[s:s + gb]], [labels[s:s + gb]])


# Reference-name aliases, for users arriving from the Spark API
SparkDl4jMultiLayer = DistributedDl4jMultiLayer
SparkComputationGraph = DistributedComputationGraph

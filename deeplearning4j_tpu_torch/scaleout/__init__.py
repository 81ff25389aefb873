"""Distributed-training facades of the PyTorch/CUDA port (port of
deeplearning4j_tpu/scaleout): the TrainingMasters (parameter averaging
over `parallel.wrapper.ParallelWrapper`, elastic over
`train.elastic`), the Spark-named network wrappers, the phase stats and
their HTML export, the early-stopping parallel trainers, the stats
router and the data-export utilities (`scaleout.util`).
`DistributedSequenceVectors` / `SparkWord2Vec`
(scaleout/sequencevectors.py) wait for the NLP stack (ROADMAP item 15).
"""
from deeplearning4j_tpu_torch.scaleout.listeners import \
    VanillaStatsStorageRouter
from deeplearning4j_tpu_torch.scaleout.parallel_trainer import (
    EarlyStoppingParallelTrainer, SparkEarlyStoppingTrainer)
from deeplearning4j_tpu_torch.scaleout.stats import (SparkTrainingStats,
                                                     timed_phase)
from deeplearning4j_tpu_torch.scaleout.training_master import (
    DistributedComputationGraph, DistributedDl4jMultiLayer,
    ElasticTrainingMaster, ParameterAveragingTrainingMaster,
    SparkComputationGraph, SparkDl4jMultiLayer, TrainingMaster)

__all__ = [
    "TrainingMaster", "ParameterAveragingTrainingMaster",
    "ElasticTrainingMaster",
    "DistributedDl4jMultiLayer", "DistributedComputationGraph",
    "SparkDl4jMultiLayer", "SparkComputationGraph", "SparkTrainingStats",
    "timed_phase", "EarlyStoppingParallelTrainer",
    "SparkEarlyStoppingTrainer", "VanillaStatsStorageRouter",
]

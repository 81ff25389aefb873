"""Early-stopping training loop (port of
deeplearning4j_tpu/earlystopping/trainer.py).

Parity with the reference (reference:
deeplearning4j-nn/.../earlystopping/trainer/BaseEarlyStoppingTrainer.java,
EarlyStoppingTrainer.java, EarlyStoppingGraphTrainer.java): per-epoch fit
over the training iterator with iteration-condition checks per minibatch,
score calculation every N epochs, best-model tracking via the saver, and a
structured result.
"""
from __future__ import annotations

import logging
import math
from typing import Dict

from deeplearning4j_tpu_torch.earlystopping.config import (
    EarlyStoppingConfiguration, EarlyStoppingResult)
from deeplearning4j_tpu_torch.earlystopping.termination import \
    MaxEpochsTerminationCondition
from deeplearning4j_tpu_torch.nn.multilayer import _unpack_batch

log = logging.getLogger("deeplearning4j_tpu_torch")


class EarlyStoppingListener:
    """Callbacks around the early-stopping loop (reference:
    earlystopping/listener/EarlyStoppingListener.java: onStart,
    onEpoch, onCompletion)."""

    def on_start(self, config, net) -> None:
        pass

    def on_epoch(self, epoch: int, score: float, config, net) -> None:
        pass

    def on_completion(self, result) -> None:
        pass


class BaseEarlyStoppingTrainer:

    def __init__(self, config: EarlyStoppingConfiguration, net, train_iter,
                 listener: "EarlyStoppingListener" = None):
        self.config = config
        self.net = net
        self.train_iter = train_iter
        self.listener = listener

    def set_listener(self, listener: "EarlyStoppingListener") -> None:
        self.listener = listener

    def fit(self) -> EarlyStoppingResult:
        cfg = self.config
        if self.listener is not None:
            self.listener.on_start(cfg, self.net)
        for c in cfg.epoch_termination_conditions:
            c.initialize()
        for c in cfg.iteration_termination_conditions:
            c.initialize()
        score_vs_epoch: Dict[int, float] = {}
        best_score = math.inf
        best_epoch = -1
        epoch = 0
        reason, details = "Error", "loop never ran"
        while True:
            stop_iter = None
            for batch in self.train_iter:
                self._fit_batch(batch)
                last = float(self.net.score_value)
                for c in cfg.iteration_termination_conditions:
                    if c.terminate(last):
                        stop_iter = c
                        break
                if stop_iter is not None:
                    break
            if hasattr(self.train_iter, "reset"):
                self.train_iter.reset()
            if stop_iter is not None:
                reason = "IterationTerminationCondition"
                details = repr(stop_iter)
                break

            # On epochs where the calculator is skipped, do NOT fall back to
            # the last train-minibatch loss: mixing train-batch and
            # validation scores would corrupt best-model selection and feed
            # the epoch conditions an inconsistent metric.
            evaluated = (cfg.score_calculator is None
                         or epoch % cfg.evaluate_every_n_epochs == 0)
            if evaluated:
                if cfg.score_calculator is not None:
                    score = float(
                        cfg.score_calculator.calculate_score(self.net))
                else:
                    score = float(self.net.score_value)
                score_vs_epoch[epoch] = score
                if self.listener is not None:
                    self.listener.on_epoch(epoch, score, cfg, self.net)
                if score < best_score:
                    best_score = score
                    best_epoch = epoch
                    cfg.model_saver.save_best_model(self.net, score)
                    log.info("early stopping: new best score %.6f at "
                             "epoch %d", score, epoch)
            if cfg.save_last_model:
                cfg.model_saver.save_latest_model(
                    self.net, float(self.net.score_value))

            stop_epoch = None
            for c in cfg.epoch_termination_conditions:
                # score-based conditions only see real (evaluated) scores;
                # score-free ones (requires_score=False) fire on any epoch
                if not evaluated and getattr(c, "requires_score", True):
                    continue
                if c.terminate(epoch, score if evaluated else math.inf):
                    stop_epoch = c
                    break
            if stop_epoch is not None:
                reason = "EpochTerminationCondition"
                details = repr(stop_epoch)
                break
            epoch += 1

        best_model = cfg.model_saver.get_best_model()
        if best_model is None:
            best_model = self.net
        result = EarlyStoppingResult(
            termination_reason=reason, termination_details=details,
            score_vs_epoch=score_vs_epoch, best_model_epoch=best_epoch,
            best_model_score=best_score, total_epochs=epoch + 1,
            best_model=best_model)
        if self.listener is not None:
            self.listener.on_completion(result)
        return result

    def _fit_batch(self, batch) -> None:
        feats, labels, fmask, lmask = _unpack_batch(batch)
        self.net.fit(feats, labels,
                     lmask if lmask is not None else fmask)


class EarlyStoppingTrainer(BaseEarlyStoppingTrainer):
    """For MultiLayerNetwork (reference: EarlyStoppingTrainer.java)."""


class EarlyStoppingGraphTrainer(BaseEarlyStoppingTrainer):
    """For ComputationGraph (reference: EarlyStoppingGraphTrainer.java)."""

"""Model savers for early stopping (port of
deeplearning4j_tpu/earlystopping/saver.py).

Parity with the reference (reference:
deeplearning4j-nn/.../earlystopping/saver/{InMemoryModelSaver,
LocalFileModelSaver,LocalFileGraphSaver}.java).
"""
from __future__ import annotations

import os
from typing import Any, Optional

from deeplearning4j_tpu_torch.util.model_serializer import (
    model_type_of, restore_computation_graph, restore_multi_layer_network,
    write_model)


class EarlyStoppingModelSaver:
    def save_best_model(self, net, score: float) -> None:
        raise NotImplementedError

    def save_latest_model(self, net, score: float) -> None:
        raise NotImplementedError

    def get_best_model(self):
        raise NotImplementedError

    def get_latest_model(self):
        raise NotImplementedError


class InMemoryModelSaver(EarlyStoppingModelSaver):
    def __init__(self):
        self._best: Optional[Any] = None
        self._latest: Optional[Any] = None

    def save_best_model(self, net, score: float) -> None:
        self._best = net.clone()

    def save_latest_model(self, net, score: float) -> None:
        self._latest = net.clone()

    def get_best_model(self):
        return self._best

    def get_latest_model(self):
        return self._latest


class LocalFileModelSaver(EarlyStoppingModelSaver):
    """Persist best/latest model zips under a directory (reference:
    LocalFileModelSaver: bestModel.bin / latestModel.bin), in the model
    serializer's format; a model is restored onto the device of the
    network last saved."""

    BEST = "bestModel.zip"
    LATEST = "latestModel.zip"

    def __init__(self, directory: str):
        self.directory = directory
        self.device = None
        os.makedirs(directory, exist_ok=True)

    def _restore(self, path: str):
        if not os.path.exists(path):
            return None
        if model_type_of(path) == "ComputationGraph":
            return restore_computation_graph(path, device=self.device)
        return restore_multi_layer_network(path, device=self.device)

    def save_best_model(self, net, score: float) -> None:
        self.device = net.device
        write_model(net, os.path.join(self.directory, self.BEST))

    def save_latest_model(self, net, score: float) -> None:
        self.device = net.device
        write_model(net, os.path.join(self.directory, self.LATEST))

    def get_best_model(self):
        return self._restore(os.path.join(self.directory, self.BEST))

    def get_latest_model(self):
        return self._restore(os.path.join(self.directory, self.LATEST))

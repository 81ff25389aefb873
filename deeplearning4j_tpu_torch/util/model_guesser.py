"""ModelGuesser: load a saved artifact by what it holds (port of
deeplearning4j_tpu/util/model_guesser.py).

The reference's deeplearning4j-core `util/ModelGuesser.java`: given a
path that may hold a saved MultiLayerNetwork, a saved ComputationGraph or
a bare configuration JSON (raw or inside a zip), figure out which and
load it. Restored networks live on ``device`` (the card unless
``"cpu"``).
"""
from __future__ import annotations

import json
import zipfile
from typing import Any

from deeplearning4j_tpu_torch.util.model_serializer import (
    model_type_of, restore_computation_graph, restore_multi_layer_network)


class ModelGuesser:

    @staticmethod
    def load_model_guess(path: str, device=None) -> Any:
        """Saved model zip -> restored network; raw JSON -> configuration."""
        kind = model_type_of(path)
        if kind == "MultiLayerNetwork":
            return restore_multi_layer_network(path, device=device)
        if kind == "ComputationGraph":
            return restore_computation_graph(path, device=device)
        return ModelGuesser.load_config_guess(path)

    @staticmethod
    def load_config_guess(path: str) -> Any:
        from deeplearning4j_tpu_torch.nn.conf.configuration import (
            ComputationGraphConfiguration, MultiLayerConfiguration)
        if zipfile.is_zipfile(path):
            with zipfile.ZipFile(path) as zf:
                text = zf.read("configuration.json").decode()
        else:
            with open(path) as f:
                text = f.read()
        obj = json.loads(text)
        t = obj.get("@class", "")
        if "ComputationGraph" in t:
            return ComputationGraphConfiguration.from_json(text)
        return MultiLayerConfiguration.from_json(text)

"""ImageNet label table + prediction decoding (port of
deeplearning4j_tpu/modelimport/labels.py).

The reference's `Utils/ImageNetLabels.java` and
`TrainedModels.decodePredictions` (TrainedModels.java:128-160). The
reference fetches Keras's `imagenet_class_index.json` at first use and
keeps ``label = entry[1]`` per class index. The port resolves the same
JSON from local sources only:

1. an explicit ``path=`` argument,
2. ``$DL4JTPU_IMAGENET_INDEX``,
3. Keras's own cache (``~/.keras/models/imagenet_class_index.json``),
4. this framework's cache dir (``~/.dl4j_tpu/imagenet_class_index.json``).

When none exists, `load` raises `FileNotFoundError` listing every path it
tried and naming the reference's URL as text: the port opens no socket,
as its dataset loaders read only cached files.
"""
from __future__ import annotations

import json
import os
from typing import List, Optional, Sequence, Tuple

import numpy as np

# the URL the reference reads the table from (ImageNetLabels.java:17);
# named in the error message only, never fetched
JSON_URL = ("https://s3.amazonaws.com/deep-learning-models/"
            "image-models/imagenet_class_index.json")
_CACHE_DIR = os.path.join(os.path.expanduser("~"), ".dl4j_tpu")
# the environment variable naming the class-index file (a data source;
# no environment variable selects a kernel)
INDEX_ENV = "DL4JTPU_IMAGENET_INDEX"


class ImageNetLabels:
    """Lazy ImageNet class-index table (1000 entries): the reference's
    static getLabels() / getLabel(n) surface plus the wnid (synset id) the
    Keras JSON also carries."""

    _labels: Optional[List[str]] = None
    _wnids: Optional[List[str]] = None
    # resolved file that populated _labels: the in-memory table is valid
    # only while the effective source (path argument / env var / the
    # fallback chain) still resolves to the same file, so a load(path=...)
    # does not hijack later default loads and a changed env var does not
    # keep serving a stale table
    _source: Optional[str] = None

    @classmethod
    def _candidate_paths(cls, path: Optional[str]) -> List[str]:
        cands = []
        if path:
            cands.append(path)
        env = os.environ.get(INDEX_ENV)
        if env:
            cands.append(env)
        home = os.path.expanduser("~")
        cands.append(os.path.join(home, ".keras", "models",
                                  "imagenet_class_index.json"))
        cands.append(os.path.join(_CACHE_DIR,
                                  "imagenet_class_index.json"))
        return cands

    @classmethod
    def load(cls, path: Optional[str] = None) -> List[str]:
        """Resolve and parse the class-index JSON (see the module doc for
        the chain). Idempotent while the effective source is stable: the
        in-memory table is keyed on the resolved file, so a
        load(path=...) or a changed $DL4JTPU_IMAGENET_INDEX re-parses from
        the newly resolved source. An explicitly named source (path= or
        the env var) that does not exist raises instead of falling through
        to a cache that may hold a different table, checked before the
        in-memory table is served."""
        for name, explicit in (("path argument", path),
                               ("$" + INDEX_ENV,
                                os.environ.get(INDEX_ENV))):
            if explicit and not os.path.exists(explicit):
                raise FileNotFoundError(
                    f"{name} names {explicit!r}, which does not exist "
                    "(refusing to fall back to a cached table that "
                    "may differ)")
        # the in-memory table serves when nothing explicit is requested,
        # or when the explicit source is the file that populated it
        explicit = path or os.environ.get(INDEX_ENV)
        if cls._labels is not None and (
                explicit is None
                or os.path.abspath(explicit) == cls._source):
            return cls._labels
        tried = []
        for cand in cls._candidate_paths(path):
            if os.path.exists(cand):
                with open(cand) as f:
                    out = cls._parse(json.load(f))
                cls._source = os.path.abspath(cand)
                return out
            tried.append(cand)
        raise FileNotFoundError(
            "imagenet_class_index.json not found locally. Looked in: "
            f"{tried}. Provide the standard Keras class-index JSON via "
            "path=, $DL4JTPU_IMAGENET_INDEX, or place it in "
            f"{_CACHE_DIR}/ (the reference downloads it from {JSON_URL}; "
            "this package does not download).")

    @classmethod
    def _parse(cls, data: dict) -> List[str]:
        n = len(data)
        labels = [""] * n
        wnids = [""] * n
        for k, (wnid, label) in data.items():
            labels[int(k)] = label       # reference: jsonMap.get(i)[1]
            wnids[int(k)] = wnid
        cls._labels, cls._wnids = labels, wnids
        return labels

    @classmethod
    def get_labels(cls) -> List[str]:
        return cls.load()

    @classmethod
    def get_label(cls, n: int) -> str:
        return cls.load()[n]

    @classmethod
    def get_wnid(cls, n: int) -> str:
        cls.load()
        return cls._wnids[n]


def _numpy(predictions) -> np.ndarray:
    """Host numpy view of predictions (a tensor on any device, or an
    array)."""
    if hasattr(predictions, "detach"):
        predictions = predictions.detach().cpu().numpy()
    return np.asarray(predictions)


def get_predicted_classes(predictions) -> np.ndarray:
    """Argmax class index per row (the reference's `getPredictedClasses`
    on zoo predictions). predictions: [batch, n_classes]."""
    return np.argmax(_numpy(predictions), axis=-1)


def top_k(predictions, k: int = 5,
          labels: Optional[Sequence[str]] = None
          ) -> List[List[Tuple[int, str, float]]]:
    """Per batch row, the top-k (class_index, label, probability)
    tuples, descending. ``labels`` defaults to the ImageNet table."""
    # a single unbatched [n_classes] vector is a batch of one
    p = np.atleast_2d(_numpy(predictions).astype(np.float64))
    if labels is None:
        labels = ImageNetLabels.get_labels()
    out = []
    for row in p:
        idx = np.argsort(-row)[:k]
        out.append([(int(i), labels[int(i)], float(row[i]))
                    for i in idx])
    return out


def decode_predictions(predictions, top: int = 5,
                       labels: Optional[Sequence[str]] = None) -> str:
    """The reference's TrainedModels.decodePredictions string format:
    per batch row, the top-k matches as '<percent>%, <label>' lines
    (TrainedModels.java:128 — "%3f%%, " + label)."""
    p = np.atleast_2d(_numpy(predictions))
    desc = ""
    multi = p.shape[0] > 1
    for batch, picks in enumerate(top_k(p, k=top, labels=labels)):
        desc += "Predictions for batch "
        if multi:
            desc += str(batch)
        desc += " :"
        for i, label, prob in picks:
            desc += "\n\t" + "%3f" % (prob * 100) + "%, " + label
    return desc

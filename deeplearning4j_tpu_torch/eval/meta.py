"""Prediction metadata tracking (copied from deeplearning4j_tpu/eval/meta.py;
reference: eval/meta/Prediction.java +
RecordMetaData — Evaluation.eval(labels, out, metadata) records which
source records were predicted as what, so errors can be traced back to
their origin, e.g. Evaluation.getPredictionErrors())."""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional


@dataclass
class RecordMetaData:
    """Where a record came from (reference: RecordMetaData interface —
    getLocation/getURI; RecordMetaDataLine/RecordMetaDataIndex impls)."""
    location: Any = None
    index: Optional[int] = None
    uri: Optional[str] = None
    extra: dict = field(default_factory=dict)

    def get_location(self) -> str:
        if self.location is not None:
            return str(self.location)
        if self.uri is not None:
            loc = self.uri
            if self.index is not None:
                loc += f":{self.index}"
            return loc
        return f"index {self.index}" if self.index is not None else "?"


@dataclass
class Prediction:
    """One record's (actual, predicted) pair + provenance (reference:
    eval/meta/Prediction.java)."""
    actual_class: int
    predicted_class: int
    record_meta_data: Any = None

    def get_record_meta_data(self):
        return self.record_meta_data

    def __repr__(self):
        return (f"Prediction(actual={self.actual_class}, "
                f"predicted={self.predicted_class}, "
                f"meta={self.record_meta_data})")

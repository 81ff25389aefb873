"""Graph vertices, the non-layer nodes of a ComputationGraph (port of
deeplearning4j_tpu/nn/graph/vertices.py).

A vertex is one dataclass, registered under the JAX package's name with
the same fields (so a graph's JSON is the same document), with an
``apply(inputs, masks=None)`` on tensors (autograd supplies the
backward) and an ``output_type(input_types)`` for shape inference.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Sequence

import torch

from deeplearning4j_tpu_torch.nn.conf import inputs as it
from deeplearning4j_tpu_torch.nn.conf.serde import register

Tensor = torch.Tensor


class GraphVertex:
    """Base vertex: pure function of its input activations."""

    def apply(self, inputs: List[Tensor], masks=None) -> Tensor:
        raise NotImplementedError

    def output_type(self, input_types: List):
        return input_types[0]


@register
@dataclass
class MergeVertex(GraphVertex):
    """Concatenate along the feature (trailing) axis."""

    def apply(self, inputs, masks=None):
        return torch.cat(list(inputs), dim=-1)

    def output_type(self, input_types):
        first = input_types[0]
        if isinstance(first, it.InputTypeFeedForward):
            return it.InputType.feed_forward(
                sum(t.size for t in input_types))
        if isinstance(first, it.InputTypeRecurrent):
            return it.InputType.recurrent(
                sum(t.size for t in input_types), first.time_series_length)
        if isinstance(first, it.InputTypeConvolutional):
            return it.InputType.convolutional(
                first.height, first.width,
                sum(t.channels for t in input_types))
        raise ValueError(f"MergeVertex cannot merge {first}")


@register
@dataclass
class ElementWiseVertex(GraphVertex):
    """Elementwise add / subtract / product / average / max of
    same-shaped inputs."""
    op: str = "add"

    def apply(self, inputs, masks=None):
        op = self.op.lower()
        if op == "add":
            out = inputs[0]
            for x in inputs[1:]:
                out = out + x
            return out
        if op == "subtract":
            if len(inputs) != 2:
                raise ValueError("subtract needs exactly 2 inputs")
            return inputs[0] - inputs[1]
        if op in ("product", "multiply"):
            out = inputs[0]
            for x in inputs[1:]:
                out = out * x
            return out
        if op in ("average", "avg"):
            return sum(inputs) / float(len(inputs))
        if op == "max":
            out = inputs[0]
            for x in inputs[1:]:
                out = torch.maximum(out, x)
            return out
        raise ValueError(f"Unknown ElementWiseVertex op '{self.op}'")


@register
@dataclass
class SubsetVertex(GraphVertex):
    """Feature-axis slice [from_idx, to_idx] inclusive."""
    from_idx: int = 0
    to_idx: int = 0

    def apply(self, inputs, masks=None):
        return inputs[0][..., self.from_idx:self.to_idx + 1]

    def output_type(self, input_types):
        size = self.to_idx - self.from_idx + 1
        t = input_types[0]
        if isinstance(t, it.InputTypeRecurrent):
            return it.InputType.recurrent(size, t.time_series_length)
        return it.InputType.feed_forward(size)


@register
@dataclass
class StackVertex(GraphVertex):
    """Stack along the batch axis."""

    def apply(self, inputs, masks=None):
        return torch.cat(list(inputs), dim=0)


@register
@dataclass
class UnstackVertex(GraphVertex):
    """Take slice ``from_idx`` of ``stack_size`` equal batch-axis
    chunks."""
    from_idx: int = 0
    stack_size: int = 1

    def apply(self, inputs, masks=None):
        x = inputs[0]
        step = x.shape[0] // self.stack_size
        return x[self.from_idx * step:(self.from_idx + 1) * step]


@register
@dataclass
class ScaleVertex(GraphVertex):
    """Multiply by a fixed scalar."""
    scale_factor: float = 1.0

    def apply(self, inputs, masks=None):
        return inputs[0] * self.scale_factor


@register
@dataclass
class L2Vertex(GraphVertex):
    """Pairwise L2 distance between two inputs -> [B, 1]."""
    eps: float = 1e-8

    def apply(self, inputs, masks=None):
        a, b = inputs
        d = a.reshape(a.shape[0], -1) - b.reshape(b.shape[0], -1)
        return torch.sqrt(torch.sum(d * d, dim=-1, keepdim=True) + self.eps)

    def output_type(self, input_types):
        return it.InputType.feed_forward(1)


@register
@dataclass
class L2NormalizeVertex(GraphVertex):
    """Normalize to unit L2 norm over the feature axes."""
    eps: float = 1e-8

    def apply(self, inputs, masks=None):
        x = inputs[0]
        flat = x.reshape(x.shape[0], -1)
        norm = torch.sqrt(torch.sum(flat * flat, dim=-1) + self.eps)
        shape = (x.shape[0],) + (1,) * (x.ndim - 1)
        return x / norm.reshape(shape)


@register
@dataclass
class PreprocessorVertex(GraphVertex):
    """Wrap an InputPreProcessor as a vertex."""
    preprocessor: Optional[object] = None

    def apply(self, inputs, masks=None):
        return self.preprocessor.pre_process(inputs[0])

    def output_type(self, input_types):
        return self.preprocessor.output_type(input_types[0])


@register
@dataclass
class LastTimeStepVertex(GraphVertex):
    """[B, T, F] -> [B, F] taking the last unmasked step."""
    mask_input: Optional[str] = None

    def apply(self, inputs, masks=None):
        x = inputs[0]
        mask = masks[0] if masks else None
        if mask is None:
            return x[:, -1]
        idx = torch.clamp(mask.to(torch.int64).sum(dim=1) - 1, min=0)
        return x[torch.arange(x.shape[0], device=x.device), idx]

    def output_type(self, input_types):
        t = input_types[0]
        return it.InputType.feed_forward(t.size)


@register
@dataclass
class DuplicateToTimeSeriesVertex(GraphVertex):
    """[B, F] -> [B, T, F] broadcast over a reference sequence's length
    (the second input supplies T)."""
    reference_input: Optional[str] = None

    def apply(self, inputs, masks=None):
        x, ref = inputs[0], inputs[1]
        t = ref.shape[1]
        return x[:, None, :].expand(x.shape[0], t, x.shape[-1])

    def output_type(self, input_types):
        f = input_types[0]
        r = input_types[1]
        return it.InputType.recurrent(
            f.size, getattr(r, "time_series_length", -1))


@register
@dataclass
class ReshapeVertex(GraphVertex):
    """Static reshape (keeps the batch axis)."""
    shape: Sequence[int] = field(default_factory=tuple)

    def apply(self, inputs, masks=None):
        x = inputs[0]
        return x.reshape((x.shape[0],) + tuple(self.shape))

"""nn.graph subpackage of the PyTorch/CUDA port: ComputationGraph and its
vertices (port of deeplearning4j_tpu/nn/graph)."""
from deeplearning4j_tpu_torch.nn.graph.computation_graph import (  # noqa: F401
    ComputationGraph,
)
from deeplearning4j_tpu_torch.nn.graph.vertices import (  # noqa: F401
    GraphVertex,
    MergeVertex,
    ElementWiseVertex,
    SubsetVertex,
    StackVertex,
    UnstackVertex,
    ScaleVertex,
    L2Vertex,
    L2NormalizeVertex,
    PreprocessorVertex,
    LastTimeStepVertex,
    DuplicateToTimeSeriesVertex,
    ReshapeVertex,
)

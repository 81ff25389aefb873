"""nn.layers subpackage of the PyTorch/CUDA port.

Light on purpose: it exports the layer families ported so far (dense,
output, recurrent) and imports no convolution, normalization or
attention code, so building an LSTM network pulls in only what it runs.
`nn.layers.attention` (the TransformerLM's attention) is imported by
its own path.
"""
from deeplearning4j_tpu_torch.nn.layers.base import (  # noqa: F401
    BaseLayer,
    Layer,
)
from deeplearning4j_tpu_torch.nn.layers.feedforward import (  # noqa: F401
    DenseLayer,
)
from deeplearning4j_tpu_torch.nn.layers.output import (  # noqa: F401
    CenterLossOutputLayer,
    LossLayer,
    OutputLayer,
    RnnOutputLayer,
)
from deeplearning4j_tpu_torch.nn.layers.recurrent import (  # noqa: F401
    LSTM,
    GravesBidirectionalLSTM,
    GravesLSTM,
)

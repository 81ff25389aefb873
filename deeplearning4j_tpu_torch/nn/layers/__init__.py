"""nn.layers subpackage of the PyTorch/CUDA port.

Exports the layer families of the JAX package's `nn.layers` that are
ported: dense, embedding, output and loss, convolution and pooling,
normalization, the utility layers, the DSL's attention layers and the
recurrent ones, and the pretraining layers `AutoEncoder`, `RBM` and
`VariationalAutoencoder`.
"""
from deeplearning4j_tpu_torch.nn.layers.base import (  # noqa: F401
    BaseLayer,
    Layer,
)
from deeplearning4j_tpu_torch.nn.layers.feedforward import (  # noqa: F401
    RBM,
    AutoEncoder,
    DenseLayer,
    EmbeddingLayer,
)
from deeplearning4j_tpu_torch.nn.layers.output import (  # noqa: F401
    CenterLossOutputLayer,
    LossLayer,
    OutputLayer,
    RnnOutputLayer,
)
from deeplearning4j_tpu_torch.nn.layers.convolution import (  # noqa: F401
    Convolution1DLayer,
    ConvolutionLayer,
    Subsampling1DLayer,
    SubsamplingLayer,
    ZeroPaddingLayer,
)
from deeplearning4j_tpu_torch.nn.layers.normalization import (  # noqa: F401
    BatchNormalization,
    LocalResponseNormalization,
)
from deeplearning4j_tpu_torch.nn.layers.misc import (  # noqa: F401
    ActivationLayer,
    DropoutLayer,
    FrozenLayer,
    GlobalPoolingLayer,
)
from deeplearning4j_tpu_torch.nn.layers.attention import (  # noqa: F401
    LayerNormalization,
    MultiHeadAttention,
    TransformerBlock,
)
from deeplearning4j_tpu_torch.nn.layers.recurrent import (  # noqa: F401
    LSTM,
    GravesBidirectionalLSTM,
    GravesLSTM,
)
from deeplearning4j_tpu_torch.nn.layers.variational import (  # noqa: F401
    VariationalAutoencoder,
)

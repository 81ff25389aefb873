"""datasets subpackage of the PyTorch/CUDA port (port of
deeplearning4j_tpu/datasets)."""
from deeplearning4j_tpu_torch.datasets.iterators import (  # noqa: F401
    DataSet,
    ListDataSetIterator,
    ExistingDataSetIterator,
    AsyncDataSetIterator,
    AsyncMultiDataSetIterator,
    MultipleEpochsIterator,
    AbstractDataSetIterator,
    FloatsDataSetIterator,
    DoublesDataSetIterator,
    INDArrayDataSetIterator,
    CombinedPreProcessor,
    DummyPreProcessor,
    IteratorMultiDataSetIterator,
    SingletonMultiDataSetIterator,
    MultiDataSetIteratorAdapter,
)
from deeplearning4j_tpu_torch.datasets.impl import (  # noqa: F401
    MnistDataSetIterator,
    IrisDataSetIterator,
    DigitsDataSetIterator,
    CifarDataSetIterator,
    LFWDataSetIterator,
    CurvesDataSetIterator,
)

"""eval subpackage of the PyTorch/CUDA port (port of
deeplearning4j_tpu/eval): classification, regression and ROC
evaluation, prediction metadata and the HTML export."""
from deeplearning4j_tpu_torch.eval.evaluation import (  # noqa: F401
    ConfusionMatrix,
    Evaluation,
)
from deeplearning4j_tpu_torch.eval.meta import (  # noqa: F401
    Prediction,
    RecordMetaData,
)
from deeplearning4j_tpu_torch.eval.regression import (  # noqa: F401
    RegressionEvaluation,
)
from deeplearning4j_tpu_torch.eval.roc import ROC, ROCMultiClass  # noqa: F401

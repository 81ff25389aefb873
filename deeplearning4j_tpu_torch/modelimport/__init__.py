"""modelimport subpackage of the PyTorch/CUDA port: Keras model import
(`keras`) on the port's own HDF5 reader (`hdf5`), the VGG16 and ResNet-50
configurations with ImageNet preprocessing (`trained_models`) and the
ImageNet label table (`labels`)."""
from deeplearning4j_tpu_torch.modelimport.keras import (
    InvalidKerasConfigurationException,
    KerasModel,
    KerasSequentialModel,
    UnsupportedKerasConfigurationException,
    import_keras_model_and_weights,
    import_keras_model_and_weights_separate,
    import_keras_model_auto,
    import_keras_model_configuration,
    import_keras_sequential_model_and_weights,
)
from deeplearning4j_tpu_torch.modelimport.hdf5 import Hdf5Archive
from deeplearning4j_tpu_torch.modelimport.labels import (
    ImageNetLabels,
    decode_predictions,
    get_predicted_classes,
    top_k,
)
from deeplearning4j_tpu_torch.modelimport.trained_models import (
    load_vgg16,
    resnet50,
    vgg16,
    vgg16_preprocess,
)

__all__ = [
    "import_keras_model_and_weights",
    "import_keras_sequential_model_and_weights",
    "import_keras_model_configuration",
    "import_keras_model_and_weights_separate",
    "import_keras_model_auto",
    "KerasModel", "KerasSequentialModel", "Hdf5Archive",
    "InvalidKerasConfigurationException",
    "UnsupportedKerasConfigurationException",
    "vgg16", "vgg16_preprocess", "load_vgg16", "resnet50",
    "ImageNetLabels", "decode_predictions", "get_predicted_classes",
    "top_k",
]

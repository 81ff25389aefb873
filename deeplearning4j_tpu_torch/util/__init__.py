"""util subpackage of the PyTorch/CUDA port: the chip-peak table
(`util.flops`), checkpoints (`util.checkpointing`), the model serializer
(`util.model_serializer`) and ModelGuesser (`util.model_guesser`)."""
from deeplearning4j_tpu_torch.util.model_serializer import (  # noqa: F401
    ModelSerializer,
    restore_computation_graph,
    restore_multi_layer_network,
    write_model,
)
from deeplearning4j_tpu_torch.util.model_guesser import (  # noqa: F401
    ModelGuesser,
)

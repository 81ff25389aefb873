"""util subpackage of the PyTorch/CUDA port: the chip-peak table
(`util.flops`), checkpoints (`util.checkpointing`) and the model
serializer (`util.model_serializer`)."""

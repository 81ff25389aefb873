"""util subpackage of the PyTorch/CUDA port: the chip-peak table
(`util.flops`)."""

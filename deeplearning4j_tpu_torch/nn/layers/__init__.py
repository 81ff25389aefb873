"""nn.layers subpackage of the PyTorch/CUDA port."""

"""quant subpackage of the PyTorch/CUDA port (see the package docstring)."""

"""train subpackage of the PyTorch/CUDA port (updaters so far)."""

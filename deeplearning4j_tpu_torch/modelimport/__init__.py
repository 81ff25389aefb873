"""modelimport subpackage of the PyTorch/CUDA port: the VGG16
configuration and its preprocessing (`trained_models`)."""

"""modelimport subpackage of the PyTorch/CUDA port: the VGG16 and
ResNet-50 configurations and ImageNet preprocessing (`trained_models`)."""

"""train subpackage of the PyTorch/CUDA port: updaters, the Solver and
its optimizers, listeners and the divergence guard. The submodules are
imported by their own paths (`train.updaters`, `train.solvers`,
`train.listeners`, `train.guard`)."""

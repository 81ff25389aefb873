"""The port's kernel experiments: `headpack_experiment` (two heads per
CTA in one backward pass against the production two-launch backward) and
`decode_kernel_sweep` (the decode kernel at swept launch geometries, and
a copy-bandwidth probe). Counterparts of the JAX package's
benchmarks/headpack_experiment.py and benchmarks/decode_kernel_sweep.py;
each runs as ``python -m deeplearning4j_tpu_torch.benchmarks.<name>``.
"""

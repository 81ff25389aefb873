"""deeplearning4j_tpu_torch — the PyTorch/CUDA port of `deeplearning4j_tpu`.

The JAX package (`deeplearning4j_tpu`) stays the reference; this package
mirrors its tree where that helps a reader find a module's counterpart
(`ops/flash_decode.py` <-> `deeplearning4j_tpu_torch/ops/flash_decode.py`)
and runs on one NVIDIA H100. Every Pallas kernel on a ported path is a
hand-written Hopper kernel under `csrc/`, built at first use by
`ops/_build.py`; its plain PyTorch twin serves CPU tensors only.

Ported so far: the continuous-batching TransformerLM server
(`serving.InferenceEngine`) with speculative decoding (drafters "self" and
"layers:N", `quant.model.draft_tree`), `models.transformer.TransformerLM`
with its loss, the single-device Adam train step
(`parallel.fsdp.make_fsdp_train_step`), the config DSL's
`nn.multilayer.MultiLayerNetwork` with the GravesLSTM char-RNN, and the
two kernel experiments (`benchmarks.headpack_experiment`,
`benchmarks.decode_kernel_sweep`).

Imports stay light: no subpackage is imported here, and nothing of JAX
or of `deeplearning4j_tpu` is imported anywhere in this package.
"""
import torch

# float32 matmuls and convolutions run in full float32, never TF32: the
# port's f32 parity tests against the JAX reference (1e-5 attention,
# 1e-4 logits, token-exact greedy decode) rely on it.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"

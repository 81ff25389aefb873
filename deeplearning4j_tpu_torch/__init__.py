"""deeplearning4j_tpu_torch — the PyTorch/CUDA port of `deeplearning4j_tpu`.

The JAX package (`deeplearning4j_tpu`) stays the reference; this package
mirrors its tree where that helps a reader find a module's counterpart
(`ops/flash_decode.py` <-> `deeplearning4j_tpu_torch/ops/flash_decode.py`)
and runs on one NVIDIA H100. Every Pallas kernel on a ported path is a
hand-written Hopper kernel under `csrc/`, built at first use by
`ops/_build.py`; its plain PyTorch twin serves CPU tensors only.

Ported so far: the continuous-batching TransformerLM server
(`serving.InferenceEngine`) with speculative decoding (drafters "int8",
"fp8", "self" and "layers:N", `quant.model.draft_tree`), paged KV, chunked
prefill and quantized weights and KV pools (`quant`), and its
observability (`observability`: metrics, flight recorder, SLOs, the
profiler; `util.flops`' card peaks), `models.transformer.TransformerLM`
with its loss, the Adam train step on one device and its training
parallelism on `torch.distributed` (`parallel`: the launcher and mesh,
data, tensor, pipeline, sequence and expert parallelism, FSDP,
ParallelWrapper), the config DSL's sequential
`nn.multilayer.MultiLayerNetwork` with its layer families (dense,
embedding, convolution and pooling, normalization, utility, output and
loss, the DSL's attention layers, the LSTMs), the LeNet, VGG16, text-CNN
and GravesLSTM char-RNN configurations, listeners, the training guard,
the Solver (`train`), evaluation (`eval`), early stopping
(`earlystopping`), the model serializer, ModelGuesser and checkpoints
(`util`), the dataset iterators (`datasets`), the gradient check, Keras
model import on the port's own HDF5 reader (`modelimport`) with the
Keras gateway server (`keras_server`), and the two kernel
experiments (`benchmarks.headpack_experiment`,
`benchmarks.decode_kernel_sweep`).

Imports stay light: no subpackage is imported here, and nothing of JAX
or of the JAX package is imported anywhere in this package.
"""
import torch

# float32 matmuls and convolutions run in full float32, never TF32: the
# port's f32 parity tests against the JAX reference (1e-5 attention,
# 1e-4 logits, token-exact greedy decode) rely on it.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"

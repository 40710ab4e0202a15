"""pilosa_tpu_torch — the bitmap index on PyTorch and CUDA.

A port of ``pilosa_tpu`` (JAX on a TPU) to PyTorch on an NVIDIA H100. It
keeps the JAX package's module layout and names, so each module has a
counterpart there, and it imports nothing of that package. Device state
is ``torch.int32`` tensors (a bit-identical view of the host's ``uint32``
mirrors) on the holder's device, ``cuda`` unless the caller asks for the
CPU. The batched kernels of the serving path are hand-written CUDA
(``ops/csrc``); each has a plain PyTorch version beside it that serves
CPU tensors and is the contract the kernel is held to.
"""

__version__ = "0.1.0"

from pilosa_tpu_torch.shardwidth import SHARD_WIDTH, SHARD_WIDTH_EXP

__all__ = [
    "SHARD_WIDTH",
    "SHARD_WIDTH_EXP",
    "__version__",
]

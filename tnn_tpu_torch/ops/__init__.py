"""The hand-written CUDA kernels' wrappers (``tnn_tpu.ops.pallas``): each
module pairs with a Pallas module of the JAX package, builds its
``csrc/`` source through ``runtime`` at first use and computes its plain
PyTorch version on CPU tensors."""
from . import flash_attention, paged_attention, runtime

__all__ = ["flash_attention", "paged_attention", "runtime"]

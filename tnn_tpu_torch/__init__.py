"""tnn_tpu_torch: the PyTorch / CUDA port of tnn_tpu for NVIDIA Hopper.

The package mirrors ``tnn_tpu``'s paths and names, so each module's
counterpart is found at the same place (``tnn_tpu/nn/attention.py`` pairs
with ``tnn_tpu_torch/nn/attention.py``). It imports ``torch`` and
``numpy`` only: never ``jax`` and nothing of ``tnn_tpu``.

Every TPU kernel that the serving path launches is a hand-written CUDA
kernel here (``csrc/``), built at first use by ``ops/runtime.py``. Entry
points run on ``device="cuda"`` unless the caller passes ``device="cpu"``;
without a card they raise. On a CPU tensor a kernel wrapper computes its
plain PyTorch version; on a CUDA tensor it launches the kernel or raises.
"""

"""tnn_tpu_torch: the PyTorch / CUDA port of tnn_tpu for NVIDIA Hopper.

The package mirrors ``tnn_tpu``'s paths and names, so each module's
counterpart is found at the same place (``tnn_tpu/nn/attention.py`` pairs
with ``tnn_tpu_torch/nn/attention.py``). It imports ``torch`` and
``numpy`` only: never ``jax`` and nothing of ``tnn_tpu``.

Every TPU kernel that the serving and training paths launch is a
hand-written CUDA kernel here (``csrc/``), built at first use by
``ops/runtime.py``. Entry
points run on ``device="cuda"`` unless the caller passes ``device="cpu"``;
without a card they raise. On a CPU tensor a kernel wrapper computes its
plain PyTorch version; on a CUDA tensor it launches the kernel or raises.

The top level exports what ``tnn_tpu``'s does (``Module``,
``module_from_config``, ``param_count``, ...); the names load at first
use, since the layer modules and ``core.module`` import each other.
"""
import importlib

__version__ = "0.1.0"

_EXPORTS = {"nn": None, "dtypes": "core", "DTypePolicy": "core.dtypes",
            "Module": "core.module", "module_from_config": "core.module",
            "param_count": "core.module", "param_bytes": "core.module",
            "register_module": "core.module"}

__all__ = ["nn", "dtypes", "DTypePolicy", "Module", "module_from_config",
           "param_count", "param_bytes", "register_module", "__version__"]


def __getattr__(name):
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute "
                             f"{name!r}")
    home = _EXPORTS[name]
    value = importlib.import_module(f".{name}", __name__) if home is None \
        else getattr(importlib.import_module(f".{home}", __name__), name)
    globals()[name] = value
    return value

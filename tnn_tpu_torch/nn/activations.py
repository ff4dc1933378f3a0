"""Activations on the serving path (``tnn_tpu.nn.activations``)."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def gelu(x: torch.Tensor) -> torch.Tensor:
    """tanh-approximate GELU, JAX's ``jax.nn.gelu(approximate=True)``."""
    return F.gelu(x, approximate="tanh")


_ACTIVATIONS = {"gelu": gelu}


def get(name: str):
    if name not in _ACTIVATIONS:
        raise KeyError(f"unknown activation {name!r}; known: "
                       f"{sorted(_ACTIVATIONS)}")
    return _ACTIVATIONS[name]

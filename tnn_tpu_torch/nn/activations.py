"""Activation functions and the ``Activation`` layer
(``tnn_tpu.nn.activations``): the JAX package's names, each applied to
its input's dtype as the JAX function is."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..core.module import Module, register_module


def gelu(x: torch.Tensor) -> torch.Tensor:
    """tanh-approximate GELU, JAX's ``jax.nn.gelu(approximate=True)``."""
    return F.gelu(x, approximate="tanh")


_ACTIVATIONS = {
    "linear": lambda x: x,
    "relu": F.relu,
    "leaky_relu": lambda x: F.leaky_relu(x, negative_slope=0.01),
    "elu": F.elu,
    "gelu": gelu,
    "gelu_exact": lambda x: F.gelu(x, approximate="none"),
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "silu": F.silu,
    "softmax": lambda x: torch.softmax(x, dim=-1),
}


def get(name: str):
    if name not in _ACTIVATIONS:
        raise KeyError(f"unknown activation {name!r}; known: "
                       f"{sorted(_ACTIVATIONS)}")
    return _ACTIVATIONS[name]


def names():
    return sorted(_ACTIVATIONS)


@register_module("activation")
class Activation(Module):
    """A stateless activation layer (``get(fn)`` over its input)."""

    def __init__(self, fn: str = "relu", name=None, policy=None):
        super().__init__(name=name, policy=policy)
        self.fn = fn
        self._impl = get(fn)

    def forward(self, x, *, train=False, generator=None):
        return self._impl(x)

    def _config(self):
        return {"fn": self.fn}

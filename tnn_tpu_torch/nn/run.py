"""How a model's forward applies its layers.

``GPT2``, ``Llama`` and their blocks write their forward once, against a
run: ``run.layer(mod, x)`` applies a child, ``run.add(x, y)`` is a
residual sum and ``run.mlp(inner, cols, row, x)`` is ``row(inner(x))``,
where ``inner`` computes the column layers ``cols``. ``LocalRun`` is the
single-device run: one tensor on one device. The parallel train step's
lockstep forward (``parallel.data_parallel``) is the other: one tensor a
stream, with the sharded products and the collectives in its ``layer``
and ``mlp``. So a model has one forward, whatever runs it.
"""
from __future__ import annotations

from typing import Optional

import torch


class LocalRun:
    """The single-device run: each layer called with the forward's
    ``train`` flag and dropout generator."""

    def __init__(self, train: bool = False,
                 generator: Optional[torch.Generator] = None):
        self.train = train
        self.generator = generator

    def layer(self, mod, x):
        return mod(x, train=self.train, generator=self.generator)

    @staticmethod
    def add(x, y):
        return x + y

    @staticmethod
    def mlp(inner, cols, row, x):
        del cols
        return row(inner(x))

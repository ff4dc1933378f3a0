"""Container blocks (``tnn_tpu.nn.blocks``): Sequential, Residual and
Parallel.

A container's parameter and state trees nest each child's under
``_child_key`` (the child's name, else ``f"{index:02d}_{type_name}"``,
e.g. "00_conv2d"), and leave out children whose tree is empty, as the JAX
package's do. ``build`` sizes each child from its input: a Sequential
child from the one before it, a Residual or Parallel branch from the
block's input.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import torch
from torch import nn

from ..core.module import Module, config_module, register_module
from . import activations


def _child_key(idx: int, child: Module) -> str:
    return child.name or f"{idx:02d}_{child.type_name}"


class _Container(Module):
    """Shared child bookkeeping."""

    def __init__(self, children: Sequence[Module], name=None, policy=None):
        super().__init__(name=name, policy=policy)
        self.layers = nn.ModuleList(children)

    def child_keys(self) -> List[str]:
        return [_child_key(i, c) for i, c in enumerate(self.layers)]

    def _param_slots(self):
        for key, child in zip(self.child_keys(), self.layers):
            for path, owner, attr in child._param_slots():
                yield (key,) + path, owner, attr

    def _state_slots(self):
        for key, child in zip(self.child_keys(), self.layers):
            for path, owner, attr in child._state_slots():
                yield (key,) + path, owner, attr

    def _build(self, input_shape, device):
        for child in self.layers:
            child.build(input_shape, device)

    def _config(self):
        return {"children": [c.get_config() for c in self.layers]}

    @classmethod
    def from_config(cls, cfg):
        cfg = dict(cfg)
        children = [config_module(c) for c in cfg.pop("children")]
        return super().from_config({"children": children, **cfg})


@register_module("sequential")
class Sequential(_Container):
    """A chain of modules."""

    def _build(self, input_shape, device):
        shape = input_shape
        for child in self.layers:
            shape = child.build(shape, device)

    def forward(self, x, *, train=False, generator=None):
        for child in self.layers:
            x = child(x, train=train, generator=generator)
        return x

    def output_shape(self, input_shape):
        shape = tuple(input_shape)
        for child in self.layers:
            shape = child.output_shape(shape)
        return shape


@register_module("residual")
class Residual(_Container):
    """y = act(main(x) + shortcut(x)); ``children`` is [main] or [main,
    shortcut], a missing shortcut the identity."""

    def __init__(self, children: Sequence[Module],
                 activation: Optional[str] = None, name=None, policy=None):
        super().__init__(children, name=name, policy=policy)
        if not 1 <= len(self.layers) <= 2:
            raise ValueError("Residual takes [main] or [main, shortcut]")
        self.activation = activation

    def forward(self, x, *, train=False, generator=None):
        y = self.layers[0](x, train=train, generator=generator)
        short = self.layers[1](x, train=train, generator=generator) \
            if len(self.layers) == 2 else x
        return self.merge(y, short)

    def merge(self, y, short):
        """The block's output from its main and shortcut outputs."""
        y = y + short
        if self.activation:
            y = activations.get(self.activation)(y)
        return y

    def output_shape(self, input_shape):
        return self.layers[0].output_shape(tuple(input_shape))

    def _config(self):
        return {**super()._config(), "activation": self.activation}


@register_module("parallel")
class Parallel(_Container):
    """x fanned out to every branch, the results joined: "add", "mul" or
    "concat" (over the last axis)."""

    def __init__(self, children: Sequence[Module], join: str = "add",
                 name=None, policy=None):
        super().__init__(children, name=name, policy=policy)
        if join not in ("add", "concat", "mul"):
            raise ValueError(f"unknown join {join!r}")
        self.join = join

    def forward(self, x, *, train=False, generator=None):
        return self.merge([c(x, train=train, generator=generator)
                           for c in self.layers])

    def merge(self, outs):
        """The branches' outputs joined."""
        if self.join == "concat":
            return torch.cat(outs, dim=-1)
        y = outs[0]
        for o in outs[1:]:
            y = y + o if self.join == "add" else y * o
        return y

    def output_shape(self, input_shape):
        shapes = [c.output_shape(tuple(input_shape)) for c in self.layers]
        if self.join in ("add", "mul"):
            return shapes[0]
        return tuple(shapes[0][:-1]) + (sum(s[-1] for s in shapes),)

    def _config(self):
        return {**super()._config(), "join": self.join}

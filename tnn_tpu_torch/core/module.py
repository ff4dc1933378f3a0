"""The model registry and the layer base of ``tnn_tpu.core.module``.

A model's config dict (``get_config()``, stored in every ``.tnn`` file)
names its registered type and its constructor arguments, and
``module_from_config`` builds the model again from it. The port registers
its ``GPT2`` ("gpt2") and ``Llama`` ("llama"), whose ``get_config()``
returns exactly the JAX model's dict, and every layer and container of
the image stack under its JAX type name ("conv2d", "batchnorm",
"sequential", "residual", "vit", ...), so that a file written by either
package is read by the other.

``Module`` is the base of the image stack. As in the JAX package a layer
is configured first and sized from its input afterwards: ``build(shape,
device)`` creates its parameters for an input of ``shape`` (batch first)
and returns its output shape, so a ``Sequential`` sizes each child from
the one before it. ``init(input_shape, device=, seed=)`` builds a whole
model for per-sample inputs of ``input_shape`` and draws its weights. A
module's weights are listed in the JAX parameter tree's layout
(``_param_slots``, inherited machinery of ``models.params``), its mutable
state, BatchNorm's running statistics, in the layout of the JAX package's
``net_state`` (``_state_slots``).

A training forward leaves a stateful layer's new state pending
(``pending_state``) and its buffers as they were; ``commit_state()``
writes it. A step commits after each microbatch's backward, so a forward
recomputed in the backward (``remat``) finds the same buffers and leaves
the same pending state: each microbatch updates the statistics once.
"""
from __future__ import annotations

from typing import Any, Dict, Iterator, Optional, Tuple

import torch

from ..models.params import JaxParamModule
from . import dtypes as dt
from . import rng as rnglib

_REGISTRY: Dict[str, type] = {}


def register_module(name: str):
    """Class decorator: register a model class under its JAX type name."""

    def wrap(cls):
        if name in _REGISTRY and _REGISTRY[name] is not cls:
            raise ValueError(f"module type {name!r} already registered")
        _REGISTRY[name] = cls
        cls.type_name = name
        return cls

    return wrap


def _registered(type_name: str) -> type:
    # the decorators of these modules register their classes
    from ..models import gpt2, llama, resnet, vit  # noqa: F401
    from ..nn import (activations, attention, blocks, embedding,  # noqa: F401
                      graph, layers, moe, norms, transformer)

    if type_name not in _REGISTRY:
        raise KeyError(f"unknown module type {type_name!r}; the port "
                       f"knows {sorted(_REGISTRY)}")
    return _REGISTRY[type_name]


def config_module(cfg: Dict[str, Any]) -> "Module":
    """The unbuilt ``Module`` a layer or container config describes (its
    children configured too): ``build`` sizes it."""
    cfg = dict(cfg)
    cls = _registered(cfg.pop("type"))
    if not issubclass(cls, Module):
        raise TypeError(f"{cls.__name__} is a whole model, not a layer")
    return cls.from_config(cfg)


def module_from_config(cfg: Dict[str, Any], *, device="cuda",
                       seed: Optional[int] = None, input_shape=None):
    """Build a registered model from its config dict on ``device``. Its
    weights are left as built (zero; for a file's weights to fill) or
    drawn from ``seed``. A model of the image stack is sized for
    per-sample inputs of ``input_shape`` ((H, W, C)), which its config
    does not hold, as the JAX package's ``init`` needs it."""
    cfg = dict(cfg)
    cls = _registered(cfg["type"])
    if issubclass(cls, Module):
        if input_shape is None:
            raise ValueError(f"a {cfg['type']!r} model needs input_shape "
                             "(its widths come from its input)")
        return config_module(cfg).init(input_shape, device=device,
                                       seed=seed)
    cfg.pop("type")
    policy = dt.DTypePolicy.from_config(cfg.pop("policy", None))
    name = cfg.pop("name", None)
    model = cls(**cfg, policy=policy, device=device, seed=seed)
    model.name = name
    return model


def model_config(model, fields: Dict[str, Any]) -> Dict[str, Any]:
    """The JAX ``Module.get_config`` layout: type, name when set, policy,
    then the model's own fields."""
    cfg: Dict[str, Any] = {"type": model.type_name}
    if getattr(model, "name", None) is not None:
        cfg["name"] = model.name
    cfg["policy"] = model.policy.to_config()
    cfg.update(fields)
    return cfg


class Module(JaxParamModule):
    """A layer or container of the image stack (see the module docstring).

    Subclasses set ``_params`` (their own weights' names, in the JAX
    tree's key order), and define ``_build`` (create weights for an input
    shape), ``output_shape``, ``forward(x, *, train, generator)`` and
    ``_config`` (their JAX config fields). ``param_initializers`` names
    each weight's initializer (``nn.initializers``); a weight it does not
    name starts at zero.
    """

    type_name = "module"
    _params: Tuple[str, ...] = ()
    _state: Tuple[str, ...] = ()

    def __init__(self, name: Optional[str] = None, policy=None):
        super().__init__()
        self.name = name
        self.policy = policy or dt.default_policy()
        self.device: Optional[torch.device] = None
        self.pending_state: Optional[Dict[str, torch.Tensor]] = None

    # -- sizing ---------------------------------------------------------------

    def build(self, input_shape, device) -> Tuple[int, ...]:
        """Create the weights for inputs of ``input_shape`` (batch first)
        on ``device``; returns the output shape."""
        self.device = torch.device(device)
        shape = tuple(int(d) for d in input_shape)
        self._build(shape, self.device)
        return self.output_shape(shape)

    def _build(self, input_shape, device) -> None:
        pass

    def output_shape(self, input_shape) -> Tuple[int, ...]:
        return tuple(input_shape)

    def init(self, input_shape, *, device="cuda", seed: Optional[int] = 0):
        """Build the model for per-sample inputs of ``input_shape`` on
        ``device`` ("cuda" by default; raises without a card) and draw its
        weights from ``seed`` (None leaves them as built). Returns the
        model."""
        from ..utils.device import resolve_device

        self.build((1,) + tuple(input_shape), resolve_device(device))
        if seed is not None:
            self.init_params(seed)
        return self

    def _new_param(self, shape, device) -> torch.nn.Parameter:
        return torch.nn.Parameter(torch.zeros(
            tuple(shape), dtype=self.policy.param_dtype, device=device))

    # -- weights and state ----------------------------------------------------

    def _param_slots(self) -> Iterator[Tuple[Tuple[str, ...], torch.nn.Module,
                                             str]]:
        for name in self._params:
            if getattr(self, name, None) is not None:
                yield (name,), self, name

    def _state_slots(self):
        for name in self._state:
            yield (name,), self, name

    def param_initializers(self) -> Dict[str, str]:
        return {}

    @torch.no_grad()
    def init_params(self, seed: int) -> "Module":
        """Seeded weights, drawn in the order of the parameter tree from one
        generator on the model's device, each by its owner's initializer
        (other bits than the JAX package's, the same families)."""
        from ..nn import initializers

        gen = rnglib.make_generator(seed, self.device)
        for _, owner, attr in self._param_slots():
            param = getattr(owner, attr)
            name = owner.param_initializers().get(attr, "zeros")
            param.copy_(initializers.get(name)(gen, tuple(param.shape),
                                               param.dtype))
        self._drop_derived()
        return self

    @torch.no_grad()
    def commit_state(self) -> None:
        """Write every pending state of the last training forward into its
        layer's buffers (the JAX step's ``new_net_state``)."""
        for m in self.modules():
            pending = getattr(m, "pending_state", None)
            if pending:
                for name, value in pending.items():
                    getattr(m, name).copy_(value)
                m.pending_state = None

    # -- config ---------------------------------------------------------------

    def get_config(self) -> Dict[str, Any]:
        return model_config(self, self._config())

    def _config(self) -> Dict[str, Any]:
        return {}

    @classmethod
    def from_config(cls, cfg: Dict[str, Any]) -> "Module":
        cfg = dict(cfg)
        cfg.pop("type", None)
        policy = dt.DTypePolicy.from_config(cfg.pop("policy", None))
        return cls(**cfg, policy=policy)


# -- parameter census (``tnn_tpu.core.module.param_count`` / ``param_bytes``) --

def _leaves(tree):
    """The tensors and arrays of ``tree``: a module's parameters, or the
    leaves of nested dicts, lists and tuples."""
    if isinstance(tree, torch.nn.Module):
        return list(tree.parameters())
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [] if tree is None else [tree]


def param_count(tree) -> int:
    """Elements over the leaves of ``tree`` (a module: its parameters)."""
    return int(sum(x.numel() if isinstance(x, torch.Tensor) else x.size
                   for x in _leaves(tree)))


def param_bytes(tree) -> int:
    """Bytes over the leaves of ``tree`` at their dtypes."""
    return int(sum(x.numel() * x.element_size() if isinstance(x, torch.Tensor)
                   else x.nbytes for x in _leaves(tree)))

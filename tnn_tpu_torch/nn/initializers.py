"""Weight initializers (``tnn_tpu.nn.initializers``): ``(generator,
shape, dtype, device) -> tensor`` callables with a name registry, so a
layer's config names its initializer.

Values are drawn in float32 from the explicit ``torch.Generator`` (on its
device) and cast to ``dtype``: the JAX package's families and scales,
other bits than its. ``_fans`` reads a conv kernel in HWIO, where fan-in
is kh * kw * cin.
"""
from __future__ import annotations

import math
from typing import Callable, Dict

import torch

Initializer = Callable[..., torch.Tensor]

_REGISTRY: Dict[str, Initializer] = {}


def register(name: str):
    def wrap(fn):
        _REGISTRY[name] = fn
        fn.init_name = name
        return fn

    return wrap


def get(name_or_fn) -> Initializer:
    if callable(name_or_fn):
        return name_or_fn
    if name_or_fn not in _REGISTRY:
        raise KeyError(f"unknown initializer {name_or_fn!r}; known: "
                       f"{sorted(_REGISTRY)}")
    return _REGISTRY[name_or_fn]


def config_name(fn) -> str:
    """The ``kernel_init`` a layer's config carries, the JAX package's
    value: a registered function's ``init_name``, else "he_normal". Its
    ``name_of`` reads no name given as a string, so a layer configured
    with "normal" writes "he_normal", and a layer rebuilt from that config
    draws by he_normal, in either package."""
    return getattr(fn, "init_name", "he_normal")


def name_of(fn) -> str:
    """The registered name of ``fn`` (a name passes through);
    "he_normal" for an unnamed callable, as in the JAX package."""
    if isinstance(fn, str):
        return fn
    return getattr(fn, "init_name", "he_normal")


def _fans(shape):
    """(fan_in, fan_out). Dense: (in, out). Conv HWIO: (h, w, cin, cout)."""
    if len(shape) < 1:
        return 1, 1
    if len(shape) == 1:
        return shape[0], shape[0]
    receptive = math.prod(shape[:-2]) if len(shape) > 2 else 1
    return shape[-2] * receptive, shape[-1] * receptive


def _device(generator):
    return generator.device if generator is not None else "cpu"


def _normal(generator, shape, std, dtype):
    x = torch.randn(tuple(shape), generator=generator, dtype=torch.float32,
                    device=_device(generator))
    return (x * std).to(dtype)


def _uniform(generator, shape, limit, dtype):
    x = torch.rand(tuple(shape), generator=generator, dtype=torch.float32,
                   device=_device(generator))
    return (x * (2 * limit) - limit).to(dtype)


@register("zeros")
def zeros(generator, shape, dtype=torch.float32):
    return torch.zeros(tuple(shape), dtype=dtype, device=_device(generator))


@register("ones")
def ones(generator, shape, dtype=torch.float32):
    return torch.ones(tuple(shape), dtype=dtype, device=_device(generator))


@register("he_normal")
def he_normal(generator, shape, dtype=torch.float32):
    fan_in, _ = _fans(shape)
    return _normal(generator, shape, math.sqrt(2.0 / max(1, fan_in)), dtype)


@register("he_uniform")
def he_uniform(generator, shape, dtype=torch.float32):
    fan_in, _ = _fans(shape)
    return _uniform(generator, shape, math.sqrt(6.0 / max(1, fan_in)), dtype)


@register("xavier_normal")
def xavier_normal(generator, shape, dtype=torch.float32):
    fan_in, fan_out = _fans(shape)
    return _normal(generator, shape,
                   math.sqrt(2.0 / max(1, fan_in + fan_out)), dtype)


@register("xavier_uniform")
def xavier_uniform(generator, shape, dtype=torch.float32):
    fan_in, fan_out = _fans(shape)
    return _uniform(generator, shape,
                    math.sqrt(6.0 / max(1, fan_in + fan_out)), dtype)


@register("normal")
def normal(generator, shape, dtype=torch.float32):
    return _normal(generator, shape, 0.02, dtype)


def scaled_normal(std: float) -> Initializer:
    """normal(0, ``std``); its config name is "normal", as in the JAX
    package."""

    def fn(generator, shape, dtype=torch.float32):
        return _normal(generator, shape, std, dtype)

    fn.init_name = "normal"
    return fn

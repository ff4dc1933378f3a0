"""The model registry of ``tnn_tpu.core.module``: a model's config dict
(``get_config()``, stored in every ``.tnn`` file) names its registered type
and its constructor arguments, and ``module_from_config`` builds the
model again from it.

The port registers its ``GPT2`` ("gpt2") and ``Llama`` ("llama"), whose
``get_config()`` returns exactly the JAX model's dict, so that a file
written by either package is read by the other. Options the port has not
ported are refused here, with the ROADMAP item that ports them, rather than
loaded into a model that computes something else.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

from . import dtypes as dt

_REGISTRY: Dict[str, type] = {}

# config keys the port cannot honour yet, and where ROADMAP.md queues them
_UNPORTED = {
    "moe_experts": "mixture-of-experts blocks (nn/moe.py) are ROADMAP "
                   "section 1 item 11",
}


def register_module(name: str):
    """Class decorator: register a model class under its JAX type name."""

    def wrap(cls):
        if name in _REGISTRY and _REGISTRY[name] is not cls:
            raise ValueError(f"module type {name!r} already registered")
        _REGISTRY[name] = cls
        cls.type_name = name
        return cls

    return wrap


def module_from_config(cfg: Dict[str, Any], *, device="cuda",
                       seed: Optional[int] = None):
    """Build a registered model from its config dict on ``device``. Its
    weights are left zero (``seed=None``, for a file's weights to fill) or
    drawn from ``seed``."""
    from ..models import gpt2, llama  # noqa: F401  (their decorators register)

    cfg = dict(cfg)
    type_name = cfg.pop("type")
    if type_name not in _REGISTRY:
        raise KeyError(f"unknown module type {type_name!r}; the port "
                       f"knows {sorted(_REGISTRY)}")
    for key, why in _UNPORTED.items():
        if cfg.get(key):
            raise ValueError(f"{type_name} config has {key}="
                             f"{cfg[key]!r}, which the port does not "
                             f"serve: {why}")
        cfg.pop(key, None)
    policy = dt.DTypePolicy.from_config(cfg.pop("policy", None))
    name = cfg.pop("name", None)
    model = _REGISTRY[type_name](**cfg, policy=policy, device=device,
                                 seed=seed)
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

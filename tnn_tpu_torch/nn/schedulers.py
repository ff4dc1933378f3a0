"""LR schedulers (``tnn_tpu.nn.schedulers``): a scheduler maps the step
counter to a multiplicative scale on the optimizer's base lr, as a float32
0-d tensor, computed in float32 as the JAX package computes it.

``register`` / ``from_config`` / ``get_config`` round-trip a scheduler
through ``{"type": name, ...}`` under the JAX package's names;
``state_dict`` / ``load_state_dict`` carry the host-side state a
checkpoint keeps (only ``ReduceLROnPlateau`` has any).
``ReduceLROnPlateau`` is host-driven: ``observe(metric)`` after each
validation, and ``make_train_step`` reads ``current_scale()`` once per
call of the step.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Sequence

import torch

_REGISTRY: Dict[str, type] = {}


def register(name: str):
    def wrap(cls):
        _REGISTRY[name] = cls
        cls.sched_name = name
        return cls

    return wrap


def from_config(cfg: Dict[str, Any]) -> "Scheduler":
    """The scheduler a config dict names: ``{"type": name, **kwargs}``."""
    cfg = dict(cfg)
    name = cfg.pop("type")
    if name not in _REGISTRY:
        raise KeyError(f"unknown scheduler {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name](**cfg)


def _f32(t) -> torch.Tensor:
    return torch.as_tensor(t, dtype=torch.float32)


class Scheduler:
    sched_name = "base"
    #: True where the scale depends on host observations (validation
    #: metrics): the step reads ``current_scale()`` instead of ``scale(t)``
    host_driven = False

    def scale(self, t) -> torch.Tensor:
        raise NotImplementedError

    def get_config(self) -> Dict[str, Any]:
        cfg = {"type": self.sched_name}
        cfg.update(self._config())
        return cfg

    def _config(self) -> Dict[str, Any]:
        return {}

    def state_dict(self) -> Dict[str, Any]:
        return {}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        del state


@register("noop")
class NoOp(Scheduler):
    def scale(self, t) -> torch.Tensor:
        return torch.ones_like(_f32(t))


@register("step")
class StepLR(Scheduler):
    """lr *= gamma every ``step_size`` counters."""

    def __init__(self, step_size: int, gamma: float = 0.1):
        self.step_size = int(step_size)
        self.gamma = float(gamma)

    def scale(self, t) -> torch.Tensor:
        k = torch.div(_f32(t), self.step_size, rounding_mode="floor")
        return torch.pow(_f32(self.gamma), k)

    def _config(self):
        return {"step_size": self.step_size, "gamma": self.gamma}


@register("multistep")
class MultiStepLR(Scheduler):
    """lr *= gamma at each milestone."""

    def __init__(self, milestones: Sequence[int], gamma: float = 0.1):
        self.milestones = sorted(int(m) for m in milestones)
        self.gamma = float(gamma)

    def scale(self, t) -> torch.Tensor:
        tf = _f32(t)
        count = torch.zeros_like(tf)
        for m in self.milestones:
            count = count + (tf >= m).float()
        return torch.pow(_f32(self.gamma), count)

    def _config(self):
        return {"milestones": list(self.milestones), "gamma": self.gamma}


@register("exponential")
class ExponentialLR(Scheduler):
    """lr *= gamma ** t."""

    def __init__(self, gamma: float = 0.95):
        self.gamma = float(gamma)

    def scale(self, t) -> torch.Tensor:
        return torch.pow(_f32(self.gamma), _f32(t))

    def _config(self):
        return {"gamma": self.gamma}


@register("cosine")
class CosineAnnealingLR(Scheduler):
    """Cosine decay to ``eta_min_scale`` (relative to the base lr) over
    ``t_max``, held there after."""

    def __init__(self, t_max: int, eta_min_scale: float = 0.0):
        self.t_max = int(t_max)
        self.eta_min_scale = float(eta_min_scale)

    def scale(self, t) -> torch.Tensor:
        tf = torch.clamp(_f32(t), max=float(self.t_max))
        cos = 0.5 * (1 + torch.cos(math.pi * tf / self.t_max))
        return self.eta_min_scale + (1 - self.eta_min_scale) * cos

    def _config(self):
        return {"t_max": self.t_max, "eta_min_scale": self.eta_min_scale}


@register("cosine_restarts")
class CosineAnnealingWarmRestarts(Scheduler):
    """SGDR: cosine cycles of ``t_0`` counters, each ``t_mult`` (1 or 2)
    times longer than the last."""

    def __init__(self, t_0: int, t_mult: int = 1, eta_min_scale: float = 0.0):
        self.t_0 = int(t_0)
        self.t_mult = int(t_mult)
        if self.t_mult not in (1, 2):
            raise ValueError("t_mult must be 1 or 2")
        self.eta_min_scale = float(eta_min_scale)

    def scale(self, t) -> torch.Tensor:
        tf = _f32(t)
        if self.t_mult == 1:
            tcur = torch.remainder(tf, self.t_0)
            ti = _f32(float(self.t_0))
        else:
            # cycle i has length t_0 * 2^i and starts at t_0 * (2^i - 1)
            i = torch.floor(torch.log2(tf / self.t_0 + 1.0))
            start = self.t_0 * (torch.pow(_f32(2.0), i) - 1.0)
            ti = self.t_0 * torch.pow(_f32(2.0), i)
            tcur = tf - start
        cos = 0.5 * (1 + torch.cos(math.pi * tcur / ti))
        return self.eta_min_scale + (1 - self.eta_min_scale) * cos

    def _config(self):
        return {"t_0": self.t_0, "t_mult": self.t_mult,
                "eta_min_scale": self.eta_min_scale}


@register("linear_warmup")
class LinearWarmup(Scheduler):
    """Ramp from ``start_scale`` to 1 over ``warmup`` counters."""

    def __init__(self, warmup: int, start_scale: float = 0.0):
        self.warmup = int(warmup)
        self.start_scale = float(start_scale)

    def scale(self, t) -> torch.Tensor:
        frac = torch.clamp(_f32(t) / max(1, self.warmup), 0.0, 1.0)
        return self.start_scale + (1 - self.start_scale) * frac

    def _config(self):
        return {"warmup": self.warmup, "start_scale": self.start_scale}


@register("warmup_cosine")
class WarmupCosineAnnealing(Scheduler):
    """Linear warmup over ``warmup`` steps, then cosine decay to
    ``eta_min_scale`` at ``t_max``."""

    def __init__(self, warmup: int, t_max: int, eta_min_scale: float = 0.0):
        self.warmup = int(warmup)
        self.t_max = int(t_max)
        self.eta_min_scale = float(eta_min_scale)

    def scale(self, t) -> torch.Tensor:
        tf = _f32(t)
        warm = tf / max(1, self.warmup)
        span = max(1, self.t_max - self.warmup)
        tcos = torch.clamp((tf - self.warmup) / span, 0.0, 1.0)
        eta = self.eta_min_scale
        cos = eta + (1 - eta) * 0.5 * (1 + torch.cos(math.pi * tcos))
        return torch.where(tf < self.warmup, warm, cos)

    def _config(self):
        return {"warmup": self.warmup, "t_max": self.t_max,
                "eta_min_scale": self.eta_min_scale}


@register("reduce_on_plateau")
class ReduceLROnPlateau(Scheduler):
    """Host-driven plateau scheduler: ``observe(metric)`` after each
    validation multiplies the scale by ``factor`` (down to ``min_scale``)
    once ``patience`` observations in a row failed to improve on the best
    by ``threshold``."""

    host_driven = True

    def __init__(self, factor: float = 0.1, patience: int = 10,
                 mode: str = "min", min_scale: float = 1e-4,
                 threshold: float = 1e-4):
        self.factor = float(factor)
        self.patience = int(patience)
        self.mode = mode
        self.min_scale = float(min_scale)
        self.threshold = float(threshold)
        self._best = None
        self._bad = 0
        self._scale = 1.0

    def observe(self, metric: float) -> float:
        better = (
            self._best is None
            or (self.mode == "min" and metric < self._best - self.threshold)
            or (self.mode == "max" and metric > self._best + self.threshold))
        if better:
            self._best = metric
            self._bad = 0
        else:
            self._bad += 1
            if self._bad > self.patience:
                self._scale = max(self.min_scale, self._scale * self.factor)
                self._bad = 0
        return self._scale

    def current_scale(self) -> float:
        return self._scale

    def scale(self, t) -> torch.Tensor:
        del t
        return _f32(self._scale)

    def _config(self):
        return {"factor": self.factor, "patience": self.patience,
                "mode": self.mode, "min_scale": self.min_scale,
                "threshold": self.threshold}

    def state_dict(self):
        return {"best": self._best, "bad": self._bad, "scale": self._scale}

    def load_state_dict(self, state):
        self._best = state.get("best")
        self._bad = int(state.get("bad", 0))
        self._scale = float(state.get("scale", 1.0))

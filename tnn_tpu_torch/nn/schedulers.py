"""LR schedulers (``tnn_tpu.nn.schedulers``): a scheduler maps the step
counter to a multiplicative scale on the optimizer's base lr, as a float32
0-d tensor. The port has ``NoOp`` and ``WarmupCosineAnnealing``; the other
schedulers of the JAX package are queued in ROADMAP.md."""
from __future__ import annotations

import math

import torch


class Scheduler:
    def scale(self, t) -> torch.Tensor:
        raise NotImplementedError


class NoOp(Scheduler):
    def scale(self, t) -> torch.Tensor:
        return torch.ones_like(torch.as_tensor(t, dtype=torch.float32))


class WarmupCosineAnnealing(Scheduler):
    """Linear warmup over ``warmup`` steps, then cosine decay to
    ``eta_min_scale`` at ``t_max``."""

    def __init__(self, warmup: int, t_max: int, eta_min_scale: float = 0.0):
        self.warmup = int(warmup)
        self.t_max = int(t_max)
        self.eta_min_scale = float(eta_min_scale)

    def scale(self, t) -> torch.Tensor:
        tf = torch.as_tensor(t, dtype=torch.float32)
        warm = tf / max(1, self.warmup)
        span = max(1, self.t_max - self.warmup)
        tcos = torch.clamp((tf - self.warmup) / span, 0.0, 1.0)
        eta = self.eta_min_scale
        cos = eta + (1 - eta) * 0.5 * (1 + torch.cos(math.pi * tcos))
        return torch.where(tf < self.warmup, warm, cos)

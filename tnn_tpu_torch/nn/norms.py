"""LayerNorm and RMSNorm (``tnn_tpu.nn.norms``)."""
from __future__ import annotations

import torch
from torch import nn

from ..core import dtypes as dt


class LayerNorm(nn.Module):
    """Layer norm over the last dim with the JAX package's single-pass
    statistics: mean and E[x^2] in f32, var = max(E[x^2] - mean^2, 0).
    ``F.layer_norm`` computes the variance another way and rounds
    differently. Scale and bias are trainable, in the policy's param dtype,
    read in f32 as the JAX layer reads them."""

    def __init__(self, dim: int, eps: float = 1e-5, *, policy=None,
                 device="cuda"):
        super().__init__()
        self.eps = float(eps)
        self.policy = policy or dt.default_policy()
        pd = self.policy.param_dtype
        self.scale = nn.Parameter(torch.ones(dim, dtype=pd, device=device))
        self.bias = nn.Parameter(torch.zeros(dim, dtype=pd, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mean = xf.mean(dim=-1, keepdim=True)
        mean2 = (xf * xf).mean(dim=-1, keepdim=True)
        var = (mean2 - mean * mean).clamp_min(0.0)
        y = (xf - mean) * (1.0 / torch.sqrt(var + self.eps))
        y = y * self.scale.float() + self.bias.float()
        return y.to(x.dtype)


class RMSNorm(nn.Module):
    """RMS norm over the last dim (``tnn_tpu.nn.norms.RMSNorm``): in f32,
    x / sqrt(mean(x^2) + eps) times the scale read in f32, cast back to x's
    dtype. The scale is trainable, in the policy's param dtype."""

    def __init__(self, dim: int, eps: float = 1e-6, *, policy=None,
                 device="cuda"):
        super().__init__()
        self.eps = float(eps)
        self.policy = policy or dt.default_policy()
        self.scale = nn.Parameter(torch.ones(
            dim, dtype=self.policy.param_dtype, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        ms = (xf * xf).mean(dim=-1, keepdim=True)
        y = xf * torch.reciprocal(torch.sqrt(ms + self.eps)) \
            * self.scale.float()
        return y.to(x.dtype)

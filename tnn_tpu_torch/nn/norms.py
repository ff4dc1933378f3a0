"""LayerNorm (``tnn_tpu.nn.norms.LayerNorm``)."""
from __future__ import annotations

import torch
from torch import nn

from ..core import dtypes as dt


class LayerNorm(nn.Module):
    """Layer norm over the last dim with the JAX package's single-pass
    statistics: mean and E[x^2] in f32, var = max(E[x^2] - mean^2, 0).
    ``F.layer_norm`` computes the variance another way and rounds
    differently. Scale and bias stay in the policy's param dtype, as the
    JAX layer reads them."""

    def __init__(self, dim: int, eps: float = 1e-5, *, policy=None,
                 device="cuda"):
        super().__init__()
        self.eps = float(eps)
        self.policy = policy or dt.default_policy()
        pd = self.policy.param_dtype
        self.scale = nn.Parameter(torch.ones(dim, dtype=pd, device=device),
                                  requires_grad=False)
        self.bias = nn.Parameter(torch.zeros(dim, dtype=pd, device=device),
                                 requires_grad=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mean = xf.mean(dim=-1, keepdim=True)
        mean2 = (xf * xf).mean(dim=-1, keepdim=True)
        var = (mean2 - mean * mean).clamp_min(0.0)
        y = (xf - mean) * (1.0 / torch.sqrt(var + self.eps))
        y = y * self.scale.float() + self.bias.float()
        return y.to(x.dtype)

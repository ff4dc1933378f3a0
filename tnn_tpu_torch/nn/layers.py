"""Dense and Dropout (``tnn_tpu.nn.layers``)."""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..core import dtypes as dt
from ..ops.quant_matmul import qmatmul
from . import activations


class Dense(nn.Module):
    """y = act(x @ W + b) with f32 accumulation, the bias added and the
    activation applied in f32, then cast to the io dtype.

    ``kernel`` keeps JAX's (in, out) layout. Both parameters are trainable
    and kept in the policy's param dtype; the kernel is cast to the compute
    dtype at use, the bias read in f32, as the JAX layer does. A kernel
    replaced by an ``Int8Weight`` (``nn.quant``) goes through ``qmatmul``'s
    int8 branches, whose product comes back in x's dtype and so is rounded
    before the f32 bias is added, as in the JAX layer.
    """

    def __init__(self, in_features: int, units: int, *,
                 activation: Optional[str] = None, use_bias: bool = True,
                 policy=None, device="cuda"):
        super().__init__()
        self.policy = policy or dt.default_policy()
        self.activation = activation
        pd = self.policy.param_dtype
        self.kernel = nn.Parameter(
            torch.zeros(in_features, units, dtype=pd, device=device))
        self.bias = nn.Parameter(
            torch.zeros(units, dtype=pd, device=device)) if use_bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = qmatmul(self.policy.cast_in(x),
                    self.policy.cast_param(self.kernel))
        if self.bias is not None:
            y = y + self.bias.float()
        if self.activation:
            y = activations.get(self.activation)(y)
        return self.policy.cast_out(y)


class Dropout(nn.Module):
    """Inverted dropout (``tnn_tpu.nn.layers.Dropout``): identity unless
    ``train`` and ``rate`` > 0; then each element is kept with probability
    1 - rate, drawn from the explicit ``generator``, and scaled by
    1 / (1 - rate). The two frameworks draw different bits from one seed."""

    def __init__(self, rate: float = 0.5):
        super().__init__()
        self.rate = float(rate)

    def forward(self, x: torch.Tensor, *, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if not train or self.rate <= 0.0:
            return x
        if generator is None:
            raise ValueError("Dropout needs a generator when train=True")
        keep = 1.0 - self.rate
        draw = torch.rand(x.shape, generator=generator, device=x.device)
        return torch.where(draw < keep, x / keep, 0.0).to(x.dtype)

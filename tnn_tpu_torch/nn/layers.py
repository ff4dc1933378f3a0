"""Dense layer and the f32-accumulating matmul (``tnn_tpu.nn.layers``)."""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..core import dtypes as dt
from . import activations


def matmul_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` accumulated and returned in float32: JAX's ``dot_general``
    with ``preferred_element_type=float32`` (the float branch of
    ``qmatmul``). On the card a bf16 product runs on the tensor cores with
    an f32 output; on the CPU the inputs are widened first, which is exact
    for bf16 values."""
    if x.dtype == torch.float32 and w.dtype == torch.float32:
        return x @ w
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if x.is_cuda:
        y = torch.mm(x2, w, out_dtype=torch.float32)
    else:
        y = x2.float() @ w.float()
    return y.reshape(*lead, w.shape[-1])


class Dense(nn.Module):
    """y = act(x @ W + b) with f32 accumulation, the bias added and the
    activation applied in f32, then cast to the io dtype.

    ``kernel`` keeps JAX's (in, out) layout and is stored in the compute
    dtype; ``bias`` stays in the param dtype, as the JAX layer reads it.
    """

    def __init__(self, in_features: int, units: int, *,
                 activation: Optional[str] = None, use_bias: bool = True,
                 policy=None, device="cuda"):
        super().__init__()
        self.policy = policy or dt.default_policy()
        self.activation = activation
        self.kernel = nn.Parameter(
            torch.zeros(in_features, units, dtype=self.policy.compute_dtype,
                        device=device), requires_grad=False)
        self.bias = nn.Parameter(
            torch.zeros(units, dtype=self.policy.param_dtype, device=device),
            requires_grad=False) if use_bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = matmul_f32(self.policy.cast_in(x), self.kernel)
        if self.bias is not None:
            y = y + self.bias.float()
        if self.activation:
            y = activations.get(self.activation)(y)
        return self.policy.cast_out(y)

"""Dense, Dropout and the f32-accumulating matmul (``tnn_tpu.nn.layers``)."""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..core import dtypes as dt
from . import activations


def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """2-D ``a @ b`` with an f32 result: on the card a bf16 product runs on
    the tensor cores with f32 output; on the CPU the inputs are widened
    first, which is exact for bf16 values."""
    if a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


class _MatmulF32(torch.autograd.Function):
    """``x @ w`` of compute-dtype operands with an f32 result. The backward
    rounds the f32 output gradient to the operands' dtype and accumulates
    both products in f32 before rounding them to the operands' dtype. JAX
    transposes the f32-output dot the same way but for that first rounding:
    it multiplies the f32 gradient by the bf16 operand. Rounding keeps both
    products on the tensor cores; its effect on the gradients is measured
    against JAX's in ``tests/test_torch_training.py``."""

    @staticmethod
    def forward(ctx, x2, w):
        ctx.save_for_backward(x2, w)
        return _mm_f32(x2, w)

    @staticmethod
    def backward(ctx, g):
        x2, w = ctx.saved_tensors
        g = g.to(x2.dtype)
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = _mm_f32(g, w.t()).to(x2.dtype)
        if ctx.needs_input_grad[1]:
            dw = _mm_f32(x2.t(), g).to(w.dtype)
        return dx, dw


def matmul_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` accumulated and returned in float32: JAX's ``dot_general``
    with ``preferred_element_type=float32`` (the float branch of
    ``qmatmul``). Differentiable."""
    if x.dtype == torch.float32 and w.dtype == torch.float32:
        return x @ w
    lead = x.shape[:-1]
    y = _MatmulF32.apply(x.reshape(-1, x.shape[-1]), w)
    return y.reshape(*lead, w.shape[-1])


class Dense(nn.Module):
    """y = act(x @ W + b) with f32 accumulation, the bias added and the
    activation applied in f32, then cast to the io dtype.

    ``kernel`` keeps JAX's (in, out) layout. Both parameters are trainable
    and kept in the policy's param dtype; the kernel is cast to the compute
    dtype at use, the bias read in f32, as the JAX layer does.
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
        y = matmul_f32(self.policy.cast_in(x),
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

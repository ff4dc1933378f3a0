"""Normalization layers (``tnn_tpu.nn.norms``): LayerNorm, RMSNorm,
BatchNorm and GroupNorm, each with the JAX package's single-pass f32
statistics: mean and E[x^2], var = max(E[x^2] - mean^2, 0), then
(x - mean) * 1 / sqrt(var + eps). torch's own norms compute the variance
another way and round differently. Scales and biases are trainable, in the
policy's param dtype, read in f32; the result is cast back to x's dtype.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..core.module import Module, register_module


def _stats(xf: torch.Tensor, dims):
    mean = xf.mean(dim=dims, keepdim=True)
    mean2 = (xf * xf).mean(dim=dims, keepdim=True)
    return mean, (mean2 - mean * mean).clamp_min(0.0)


class _Affine(Module):
    """A norm with an optional per-channel scale and bias."""

    _params = ("scale", "bias")

    def __init__(self, affine: bool = True, name=None, policy=None):
        super().__init__(name=name, policy=policy)
        self.affine = bool(affine)
        self.scale = self.bias = None

    def _build(self, input_shape, device):
        if self.affine:
            self.scale = self._new_param((input_shape[-1],), device)
            self.bias = self._new_param((input_shape[-1],), device)
            self.scale.data.fill_(1.0)

    def param_initializers(self):
        return {"scale": "ones"}

    def _affine(self, y):
        if self.scale is None:
            return y
        return y * self.scale.float() + self.bias.float()


@register_module("layernorm")
class LayerNorm(_Affine):
    """Layer norm over the last dim. With ``dim`` the weights are made at
    once on ``device``; with None, by ``build``."""

    def __init__(self, dim: Optional[int] = None, eps: float = 1e-5,
                 affine: bool = True, *, name=None, policy=None,
                 device="cuda"):
        super().__init__(affine=affine, name=name, policy=policy)
        self.eps = float(eps)
        if dim is not None:
            self.build((1, int(dim)), device)

    def forward(self, x: torch.Tensor, *, train: bool = False,
                generator=None) -> torch.Tensor:
        xf = x.float()
        mean, var = _stats(xf, -1)
        y = (xf - mean) * (1.0 / torch.sqrt(var + self.eps))
        return self._affine(y).to(x.dtype)

    def _config(self):
        return {"eps": self.eps, "affine": self.affine}


@register_module("rmsnorm")
class RMSNorm(Module):
    """RMS norm over the last dim (``tnn_tpu.nn.norms.RMSNorm``): in f32,
    x / sqrt(mean(x^2) + eps) times the scale read in f32, cast back to x's
    dtype. The scale is trainable, in the policy's param dtype. With
    ``dim`` it is made at once on ``device``; with None, by ``build``."""

    _params = ("scale",)

    def __init__(self, dim: Optional[int] = None, eps: float = 1e-6, *,
                 name=None, policy=None, device="cuda"):
        super().__init__(name=name, policy=policy)
        self.eps = float(eps)
        self.scale = None
        if dim is not None:
            self.build((1, int(dim)), device)

    def _build(self, input_shape, device):
        self.scale = self._new_param((input_shape[-1],), device)
        self.scale.data.fill_(1.0)

    def param_initializers(self):
        return {"scale": "ones"}

    def forward(self, x: torch.Tensor, *, train: bool = False,
                generator=None) -> torch.Tensor:
        xf = x.float()
        ms = (xf * xf).mean(dim=-1, keepdim=True)
        y = xf * torch.reciprocal(torch.sqrt(ms + self.eps)) \
            * self.scale.float()
        return y.to(x.dtype)

    def _config(self):
        return {"eps": self.eps}


@register_module("batchnorm")
class BatchNorm(_Affine):
    """Batch norm over every axis but the last (channels-last), for
    (N, C) and (N, H, W, C) inputs (``tnn_tpu/nn/norms.py:16-69``).

    Training normalizes by the batch's statistics (biased variance) and
    leaves ``running = m * running + (1 - m) * batch`` for ``mean`` and
    ``var`` pending (``Module.commit_state``); eval normalizes by the
    running buffers. torch's ``batch_norm`` would update the running
    variance with the unbiased variance and weight the new value by its
    momentum. The buffers are f32, as the JAX package's ``net_state``.
    """

    _state = ("mean", "var")

    def __init__(self, momentum: float = 0.9, eps: float = 1e-5,
                 affine: bool = True, name=None, policy=None):
        super().__init__(affine=affine, name=name, policy=policy)
        self.momentum = float(momentum)
        self.eps = float(eps)

    def _build(self, input_shape, device):
        super()._build(input_shape, device)
        c = input_shape[-1]
        self.register_buffer("mean", torch.zeros(c, dtype=torch.float32,
                                                 device=device))
        self.register_buffer("var", torch.ones(c, dtype=torch.float32,
                                               device=device))

    def forward(self, x: torch.Tensor, *, train: bool = False,
                generator=None) -> torch.Tensor:
        if not train:
            return self.normalize(x, self.mean, self.var, train=False)
        mean, var = _stats(x.float(), tuple(range(x.ndim - 1)))
        return self.normalize(x, mean.reshape(-1), var.reshape(-1))

    def normalize(self, x, mean, var, train: bool = True) -> torch.Tensor:
        """x normalized by (C,) statistics ``mean`` and ``var``; in
        training they are the batch's, and the running buffers' update
        from them is left pending (data parallelism passes the global
        batch's, ``parallel.data_parallel``)."""
        if train:
            m = self.momentum
            self.pending_state = {
                "mean": (m * self.mean + (1 - m) * mean).detach(),
                "var": (m * self.var + (1 - m) * var).detach()}
        y = (x.float() - mean) * (1.0 / torch.sqrt(var + self.eps))
        return self._affine(y).to(x.dtype)

    def _config(self):
        return {"momentum": self.momentum, "eps": self.eps,
                "affine": self.affine}


@register_module("groupnorm")
class GroupNorm(_Affine):
    """Group norm over channel groups (channels-last): statistics over
    every non-batch axis within each group of C / groups channels."""

    def __init__(self, groups: int = 32, eps: float = 1e-5,
                 affine: bool = True, name=None, policy=None):
        super().__init__(affine=affine, name=name, policy=policy)
        self.groups = int(groups)
        self.eps = float(eps)

    def _build(self, input_shape, device):
        if input_shape[-1] % self.groups:
            raise ValueError(f"channels {input_shape[-1]} not divisible by "
                             f"groups {self.groups}")
        super()._build(input_shape, device)

    def forward(self, x: torch.Tensor, *, train: bool = False,
                generator=None) -> torch.Tensor:
        c, g = x.shape[-1], self.groups
        xf = x.float().reshape(x.shape[:-1] + (g, c // g))
        dims = tuple(range(1, xf.ndim - 2)) + (xf.ndim - 1,)
        mean, var = _stats(xf, dims)
        y = ((xf - mean) * (1.0 / torch.sqrt(var + self.eps))) \
            .reshape(x.shape)
        return self._affine(y).to(x.dtype)

    def _config(self):
        return {"groups": self.groups, "eps": self.eps,
                "affine": self.affine}

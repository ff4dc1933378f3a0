"""Core layers (``tnn_tpu.nn.layers``): Dense, Conv2D, the pools, the
shape layers and Dropout.

Activations are NHWC and conv kernels HWIO, as in the JAX package, so
the parameter tree, the optimizer state and ``.tnn`` files map one to one
with its. ``F.conv2d`` and the pools take NCHW: an NHWC tensor permuted
to NCHW is a channels-last tensor, so cuDNN runs its NHWC path on it
without a copy, and the HWIO kernel is permuted to OIHW at use, next to
its cast to the compute dtype. SAME padding is JAX's: ``total = max((
ceil(H / s) - 1) * s + k_eff - H, 0)``, ``total // 2`` before and the rest
after, which is asymmetric at a stride above 1 (a 3x3 / 2 conv at even H
pads (0, 1)); an asymmetric pad is applied explicitly (-inf for max
pooling) and the op then runs VALID.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F

from ..core.module import Module, register_module
from ..ops.quant_matmul import qmatmul
from . import activations, initializers

PaddingLike = Union[str, int, Tuple[int, int], Sequence[Tuple[int, int]]]


def _norm_pair(v) -> Tuple[int, int]:
    if isinstance(v, int):
        return (v, v)
    a, b = v
    return (int(a), int(b))


def _same_pads(size: int, window: int, stride: int) -> Tuple[int, int]:
    """JAX's SAME padding of one spatial dim (``lax.padtype_to_pads``)."""
    total = max((-(-size // stride) - 1) * stride + window - size, 0)
    return total // 2, total - total // 2


def _conv_pads(padding: PaddingLike, hw, windows, strides):
    """((top, bottom), (left, right)) of a conv or pool padding spec."""
    if isinstance(padding, str):
        if padding.upper() == "VALID":
            return (0, 0), (0, 0)
        if padding.upper() != "SAME":
            raise ValueError(f"unknown padding {padding!r}")
        return tuple(_same_pads(n, w, s)
                     for n, w, s in zip(hw, windows, strides))
    if isinstance(padding, int):
        return (padding, padding), (padding, padding)
    padding = list(padding)
    if len(padding) == 2 and all(isinstance(p, int) for p in padding):
        return (padding[0], padding[0]), (padding[1], padding[1])
    return tuple(_norm_pair(p) for p in padding)


def _padded(xc: torch.Tensor, pads):
    """An NCHW tensor zero-padded by ((top, bottom), (left, right)) where
    the padding is asymmetric, and the symmetric padding left for the
    conv to apply itself."""
    (pt, pb), (pl, pr) = pads
    if pt == pb and pl == pr and min(pt, pl) >= 0:
        return xc, (pt, pl)
    return F.pad(xc, (pl, pr, pt, pb)), (0, 0)


@register_module("dense")
class Dense(Module):
    """y = act(x @ W + b) with f32 accumulation, the bias added and the
    activation applied in f32, then cast to the io dtype.

    ``kernel`` keeps JAX's (in, out) layout. Both parameters are trainable
    and kept in the policy's param dtype; the kernel is cast to the compute
    dtype at use, the bias read in f32, as the JAX layer does. A kernel
    replaced by an ``Int8Weight`` (``nn.quant``) goes through ``qmatmul``'s
    int8 branches, whose product comes back in x's dtype and so is rounded
    before the f32 bias is added, as in the JAX layer.

    With ``in_features`` the weights are made at once on ``device``; with
    None (an image model's layer, or one rebuilt from its config) ``build``
    makes them for its input's last dim.
    """

    _params = ("kernel", "bias")

    def __init__(self, in_features: Optional[int], units: int, *,
                 activation: Optional[str] = None, use_bias: bool = True,
                 kernel_init="he_normal", name=None, policy=None,
                 device="cuda"):
        super().__init__(name=name, policy=policy)
        self.units = int(units)
        self.activation = activation
        self.use_bias = bool(use_bias)
        self.kernel_init = kernel_init
        self.kernel = self.bias = None
        if in_features is not None:
            self.build((1, int(in_features)), device)

    def _build(self, input_shape, device):
        self.kernel = self._new_param((input_shape[-1], self.units), device)
        if self.use_bias:
            self.bias = self._new_param((self.units,), device)

    def output_shape(self, input_shape):
        return tuple(input_shape[:-1]) + (self.units,)

    def param_initializers(self):
        return {"kernel": initializers.name_of(self.kernel_init)}

    def forward(self, x: torch.Tensor, *, train: bool = False,
                generator=None) -> torch.Tensor:
        y = qmatmul(self.policy.cast_in(x),
                    self.policy.cast_param(self.kernel))
        if self.bias is not None:
            y = y + self.bias.float()
        if self.activation:
            y = activations.get(self.activation)(y)
        return self.policy.cast_out(y)

    def _config(self):
        return {"units": self.units, "use_bias": self.use_bias,
                "activation": self.activation,
                "kernel_init": initializers.config_name(self.kernel_init)}

    @classmethod
    def from_config(cls, cfg):
        return super().from_config({"in_features": None, **cfg})


@register_module("conv2d")
class Conv2D(Module):
    """2-D convolution over NHWC activations with an HWIO kernel
    (``filters`` out channels), strides, dilation, groups, an optional
    bias and activation.

    Rounding points are the JAX layer's: the conv runs in the compute
    dtype and returns in it (bf16 on the card: cuDNN accumulates in f32
    and rounds once), is then cast to f32, has the f32 bias added and the
    activation applied, and is cast to the io dtype.
    """

    _params = ("kernel", "bias")

    def __init__(self, filters: int, kernel_size=3, strides=1,
                 padding: PaddingLike = "same", use_bias: bool = True,
                 dilation=1, groups: int = 1,
                 activation: Optional[str] = None,
                 kernel_init="he_normal", name=None, policy=None):
        super().__init__(name=name, policy=policy)
        self.filters = int(filters)
        self.kernel_size = _norm_pair(kernel_size)
        self.strides = _norm_pair(strides)
        self.padding = padding
        self.use_bias = bool(use_bias)
        self.dilation = _norm_pair(dilation)
        self.groups = int(groups)
        self.activation = activation
        self.kernel_init = kernel_init
        self.kernel = self.bias = None

    def _build(self, input_shape, device):
        cin = input_shape[-1]
        if cin % self.groups or self.filters % self.groups:
            raise ValueError(f"channels {cin} -> {self.filters} not "
                             f"divisible by groups {self.groups}")
        kh, kw = self.kernel_size
        self.kernel = self._new_param(
            (kh, kw, cin // self.groups, self.filters), device)
        if self.use_bias:
            self.bias = self._new_param((self.filters,), device)

    def param_initializers(self):
        return {"kernel": initializers.name_of(self.kernel_init)}

    def _windows(self):
        return tuple((k - 1) * d + 1
                     for k, d in zip(self.kernel_size, self.dilation))

    def pads(self, h: int, w: int):
        """((top, bottom), (left, right)) at an input of h x w."""
        return _conv_pads(self.padding, (h, w), self._windows(),
                          self.strides)

    def forward(self, x: torch.Tensor, *, train: bool = False,
                generator=None) -> torch.Tensor:
        x = self.policy.cast_in(x)
        w = self.policy.cast_param(self.kernel).permute(3, 2, 0, 1)
        if x.is_cuda:
            w = w.contiguous(memory_format=torch.channels_last)
        xc, pad = _padded(x.permute(0, 3, 1, 2),
                          self.pads(x.shape[1], x.shape[2]))
        y = F.conv2d(xc, w, None, self.strides, pad, self.dilation,
                     self.groups)
        y = y.permute(0, 2, 3, 1).float()
        if self.bias is not None:
            y = y + self.bias.float()
        if self.activation:
            y = activations.get(self.activation)(y)
        return self.policy.cast_out(y)

    def output_shape(self, input_shape):
        n, h, w, _ = input_shape
        (pt, pb), (pl, pr) = self.pads(h, w)
        ekh, ekw = self._windows()
        sh, sw = self.strides
        return (n, (h + pt + pb - ekh) // sh + 1,
                (w + pl + pr - ekw) // sw + 1, self.filters)

    def _config(self):
        if isinstance(self.padding, (str, int)):
            pad = self.padding
        else:
            pad = [list(p) if not isinstance(p, int) else p
                   for p in self.padding]
        return {"filters": self.filters,
                "kernel_size": list(self.kernel_size),
                "strides": list(self.strides), "padding": pad,
                "use_bias": self.use_bias, "dilation": list(self.dilation),
                "groups": self.groups, "activation": self.activation,
                "kernel_init": initializers.config_name(self.kernel_init)}


class _Pool2D(Module):
    def __init__(self, pool_size=2, strides=None, padding="valid",
                 name=None, policy=None):
        super().__init__(name=name, policy=policy)
        self.pool_size = _norm_pair(pool_size)
        self.strides = _norm_pair(strides) if strides is not None \
            else self.pool_size
        self.padding = padding

    def pads(self, h: int, w: int):
        padding = self.padding if isinstance(self.padding, str) \
            else _norm_pair(self.padding)
        return _conv_pads(padding, (h, w), self.pool_size, self.strides)

    def output_shape(self, input_shape):
        n, h, w, c = input_shape
        (pt, pb), (pl, pr) = self.pads(h, w)
        (kh, kw), (sh, sw) = self.pool_size, self.strides
        return (n, (h + pt + pb - kh) // sh + 1,
                (w + pl + pr - kw) // sw + 1, c)

    def _config(self):
        return {"pool_size": list(self.pool_size),
                "strides": list(self.strides),
                "padding": self.padding if isinstance(self.padding,
                                                      (str, int))
                else list(self.padding)}


@register_module("maxpool2d")
class MaxPool2D(_Pool2D):
    """Max over each window in the input's dtype; padding is -inf (the
    dtype's least value for integers), as JAX's ``reduce_window``."""

    def forward(self, x, *, train=False, generator=None):
        low = -math.inf if x.is_floating_point() \
            else torch.iinfo(x.dtype).min
        (pt, pb), (pl, pr) = self.pads(*x.shape[1:3])
        xc = x.permute(0, 3, 1, 2)
        if pt or pb or pl or pr:
            xc = F.pad(xc, (pl, pr, pt, pb), value=low)
        y = F.max_pool2d(xc, self.pool_size, self.strides)
        return y.permute(0, 2, 3, 1)


@register_module("avgpool2d")
class AvgPool2D(_Pool2D):
    """Window sums in f32 over the window's size (VALID) or, padded, over
    the count of real pixels in each window (padding does not count), cast
    back to the input's dtype."""

    def forward(self, x, *, train=False, generator=None):
        (pt, pb), (pl, pr) = self.pads(*x.shape[1:3])
        spec = (pl, pr, pt, pb)

        def window_sums(t):
            return F.avg_pool2d(F.pad(t, spec), self.pool_size,
                                self.strides, divisor_override=1)

        s = window_sums(x.float().permute(0, 3, 1, 2))
        if isinstance(self.padding, str) and self.padding.upper() == "VALID":
            y = s / (self.pool_size[0] * self.pool_size[1])
        else:
            ones = torch.ones((1, 1) + tuple(x.shape[1:3]),
                              dtype=torch.float32, device=x.device)
            y = s / window_sums(ones)
        return y.permute(0, 2, 3, 1).to(x.dtype)


@register_module("global_avgpool")
class GlobalAvgPool(Module):
    """The spatial mean over H, W in f32, (N, H, W, C) -> (N, C)."""

    def forward(self, x, *, train=False, generator=None):
        return x.float().mean(dim=(1, 2)).to(x.dtype)

    def output_shape(self, input_shape):
        return (input_shape[0], input_shape[-1])


@register_module("flatten")
class Flatten(Module):
    """All non-batch dims into one (NHWC order, as the JAX layer)."""

    def forward(self, x, *, train=False, generator=None):
        return x.reshape(x.shape[0], -1)

    def output_shape(self, input_shape):
        return (input_shape[0], math.prod(input_shape[1:]))


@register_module("reshape")
class Reshape(Module):
    def __init__(self, shape, name=None, policy=None):
        super().__init__(name=name, policy=policy)
        self.shape = tuple(int(d) for d in shape)

    def forward(self, x, *, train=False, generator=None):
        return x.reshape((x.shape[0],) + self.shape)

    def output_shape(self, input_shape):
        return (input_shape[0],) + self.shape

    def _config(self):
        return {"shape": list(self.shape)}


@register_module("transpose")
class Transpose(Module):
    """A permutation of the non-batch dims."""

    def __init__(self, perm, name=None, policy=None):
        super().__init__(name=name, policy=policy)
        self.perm = tuple(int(p) for p in perm)

    def forward(self, x, *, train=False, generator=None):
        return x.permute((0,) + tuple(p + 1 for p in self.perm))

    def output_shape(self, input_shape):
        rest = input_shape[1:]
        return (input_shape[0],) + tuple(rest[p] for p in self.perm)

    def _config(self):
        return {"perm": list(self.perm)}


@register_module("identity")
class Identity(Module):
    def forward(self, x, *, train=False, generator=None):
        return x


@register_module("slice")
class Slice(Module):
    """A static slice along one non-batch axis."""

    def __init__(self, axis: int, start: int, length: int, name=None,
                 policy=None):
        super().__init__(name=name, policy=policy)
        self.axis = int(axis)
        self.start = int(start)
        self.length = int(length)

    def forward(self, x, *, train=False, generator=None):
        return x.narrow(self.axis + 1, self.start, self.length)

    def output_shape(self, input_shape):
        shape = list(input_shape)
        shape[self.axis + 1] = self.length
        return tuple(shape)

    def _config(self):
        return {"axis": self.axis, "start": self.start,
                "length": self.length}


@register_module("dropout")
class Dropout(Module):
    """Inverted dropout (``tnn_tpu.nn.layers.Dropout``): identity unless
    ``train`` and ``rate`` > 0; then each element is kept with probability
    1 - rate, drawn from the explicit ``generator``, and scaled by
    1 / (1 - rate). The two frameworks draw different bits from one seed."""

    def __init__(self, rate: float = 0.5, name=None, policy=None):
        super().__init__(name=name, policy=policy)
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

    def _config(self):
        return {"rate": self.rate}

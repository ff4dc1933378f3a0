"""Post-training weight-only int8 quantization for decode
(``tnn_tpu.nn.quant``).

``quantize_for_decode(model)`` returns a copy of a model whose large 2-D
matmul weights are ``Int8Weight``s (per-output-channel symmetric int8 + f32
scales, ``ops.quant_matmul``). Layers are quantization-transparent: Dense,
MultiHeadAttention and Embedding route an ``Int8Weight`` through
``qmatmul``'s int8 branches and a float parameter through the f32 product.

What is quantized, by the path of the weight (module names, then the
attribute, which for GPT-2 ends as the JAX tree's keys do):

  * ``kernel`` / ``qkv_kernel`` / ``out_kernel`` of ndim 2 whose dims are
    both >= 128 (projections and MLPs);
  * the token table ``wte.table``, row-wise (per vocab entry), through its
    transpose: it is the tied head's (N, K) weight and the lookup's rows;
  * not the positional table, the norms or the biases.

The copy shares every weight it leaves float with the original and keeps no
f32 master of the quantized ones, so the caller's model is unchanged (the
JAX engine likewise replaces its params only inside the engine).
"""
from __future__ import annotations

import copy
from typing import Tuple

import torch
from torch import nn

from ..ops.quant_matmul import Int8Weight, quantize_int8

_MATMUL_KEYS = ("kernel", "qkv_kernel", "out_kernel")


def _quantized(path: Tuple[str, ...], leaf: torch.Tensor) -> bool:
    if leaf.ndim != 2 or not leaf.dtype.is_floating_point:
        return False
    if min(leaf.shape) < 128:
        return False   # the bandwidth saving is negligible; keep exact
    if path[-1] in _MATMUL_KEYS:
        return True
    return path[-1] == "table" and any("wte" in p for p in path[:-1])


def set_weight(module: nn.Module, name: str, value) -> None:
    """Put ``value`` (an ``Int8Weight``) where ``module`` had the parameter
    ``name``; layers read it by the same attribute."""
    module._parameters.pop(name, None)
    setattr(module, name, value)


def _clone(module: nn.Module) -> nn.Module:
    """A copy of the module tree that shares its parameters and buffers."""
    c = copy.copy(module)
    c._parameters = dict(module._parameters)
    c._buffers = dict(module._buffers)
    c._modules = {k: None if m is None else _clone(m)
                  for k, m in module._modules.items()}
    return c


@torch.no_grad()
def quantize_for_decode(model: nn.Module) -> nn.Module:
    """A copy of ``model`` with the weights the module docstring lists as
    ``Int8Weight``s."""
    out = _clone(model)
    for mod_name, mod in out.named_modules():
        prefix = tuple(mod_name.split(".")) if mod_name else ()
        for name, p in list(mod._parameters.items()):
            path = prefix + (name,)
            if p is None or not _quantized(path, p):
                continue
            # the table is (vocab, dim) with a per-row scale: quantize_int8
            # takes (K, N), so it gets the transpose and stores the rows
            w = p.t() if name == "table" else p
            set_weight(mod, name, quantize_int8(w))
    return out


def quantized_bytes(model: nn.Module) -> int:
    """Bytes of the model's weights as stored: float parameters and
    buffers, and each ``Int8Weight``'s padded int8 values and f32 scales."""
    total = 0
    for mod in model.modules():
        for t in list(mod._parameters.values()) + list(
                mod._buffers.values()):
            if t is not None:
                total += t.numel() * t.element_size()
        total += sum(v.nbytes for v in vars(mod).values()
                     if isinstance(v, Int8Weight))
    return total

"""Models whose weights map to the JAX package's parameter tree.

``JaxParamModule`` is the base of the port's ``GPT2`` and ``Llama``: a
subclass lists every weight as (JAX tree path, owning module, attribute)
in ``_param_slots``, and inherits from it the tree's round trip
(``load_jax_params``, ``jax_param_tree``) and the seeded initialisation.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Iterator, Tuple

import numpy as np
import torch
from torch import nn

from ..nn.quant import set_weight
from ..ops.quant_matmul import Int8Weight


class JaxParamModule(nn.Module):
    """A model with a ``device`` and the weight slots of ``_param_slots``."""

    def _param_slots(self) -> Iterator[Tuple[Tuple[str, ...], nn.Module,
                                             str]]:
        raise NotImplementedError

    def jax_param_paths(self) -> Iterator[Tuple[Tuple[str, ...], Any]]:
        """Every weight (a parameter, or an ``Int8Weight`` where the model
        was quantized) beside its path in the JAX parameter tree."""
        for path, module, name in self._param_slots():
            yield path, getattr(module, name)

    @torch.no_grad()
    def load_jax_params(self, tree: Dict) -> "JaxParamModule":
        """Copy the JAX parameter tree (nested dicts of numpy arrays, e.g.
        ``jax.tree.map(np.asarray, params)``) into this model.

        Kernels keep JAX's (in, out) layout, so nothing is transposed; the
        f32 values are copied unrounded into the f32 masters. A leaf with
        ``q``, ``scale``, ``n`` and ``k`` (an ``Int8Weight`` of a
        ``quantize_for_decode`` tree, its arrays as numpy) replaces the
        parameter by an ``Int8Weight`` of the same bytes.
        """
        for path, module, name in self._param_slots():
            node = tree
            for key in path:
                node = node[key]
            param = getattr(module, name)
            if all(hasattr(node, a) for a in ("q", "scale", "n", "k")):
                dev = param.device
                iw = Int8Weight(
                    torch.tensor(np.asarray(node.q, np.int8), device=dev),
                    torch.tensor(np.asarray(node.scale, np.float32),
                                 device=dev), n=node.n, k=node.k)
                # the table is quantized through its transpose (an int8
                # table being replaced already has the int8 layout)
                want = tuple(param.shape)
                if name == "table" and not isinstance(param, Int8Weight):
                    want = want[::-1]
                if iw.shape != want:
                    raise ValueError(f"{'.'.join(path)}: int8 shape "
                                     f"{iw.shape} != {want}")
                set_weight(module, name, iw)
                continue
            value = torch.tensor(np.asarray(node, dtype=np.float32))
            if tuple(value.shape) != tuple(param.shape):
                raise ValueError(f"{'.'.join(path)}: shape {tuple(value.shape)}"
                                 f" != {tuple(param.shape)}")
            param.copy_(value)
        self._drop_derived()
        return self

    def jax_param_tree(self) -> Dict:
        """The parameters as the JAX package's nested-dict tree of float32
        numpy arrays (the inverse of ``load_jax_params``)."""
        tree: Dict = {}
        for path, param in self.jax_param_paths():
            node = tree
            for key in path[:-1]:
                node = node.setdefault(key, {})
            node[path[-1]] = param.detach().float().cpu().numpy()
        return tree

    @torch.no_grad()
    def init_params(self, seed: int) -> "JaxParamModule":
        """Seeded random weights, drawn on the model's device from a
        ``torch.Generator``: normal(0.02) embeddings, xavier-uniform
        attention kernels, he-normal MLP kernels, zero biases, unit norms
        (the JAX package's initializer families; other bits than its)."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        for path, param in self.jax_param_paths():
            name = path[-1]
            shape = tuple(param.shape)
            if name in ("table", "pos"):
                param.normal_(0.0, 0.02, generator=gen)
            elif name in ("qkv_kernel", "out_kernel"):
                limit = math.sqrt(6.0 / (shape[0] + shape[1]))
                param.uniform_(-limit, limit, generator=gen)
            elif name == "kernel":
                param.normal_(0.0, math.sqrt(2.0 / shape[0]), generator=gen)
            elif name == "scale":
                param.fill_(1.0)
            else:
                param.zero_()
        self._drop_derived()
        return self

    def _drop_derived(self) -> None:
        """Forget what was built from the old weights: the fused decode
        path's stacked copies (``models.fused_decode.decode_stacks``)."""
        self.__dict__.pop("_fused_stacks", None)

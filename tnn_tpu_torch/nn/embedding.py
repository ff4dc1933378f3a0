"""Token and learned positional embeddings and the class token
(``tnn_tpu.nn.embedding``)."""
from __future__ import annotations

from typing import Optional

import torch

from ..core.module import Module, register_module
from ..ops.quant_matmul import Int8Weight, qmatmul
from . import initializers


@register_module("embedding")
class Embedding(Module):
    """Token embedding: int ids (..., S) -> (..., S, dim) in the compute
    dtype, plus the tied output head ``attend``. The table is a trainable
    parameter in the policy's param dtype, cast to the compute dtype at use
    (the looked-up rows only, which gives the same values), or an
    ``Int8Weight`` (``nn.quant``): (vocab, dim) int8 rows with a per-row
    scale, which is both the gather layout and the head's (N, K) layout.

    The table is made at once on ``device``; ``device=None`` leaves it to
    ``build`` (a ``Sequential`` child, or a layer rebuilt from its
    config)."""

    _params = ("table",)

    def __init__(self, vocab_size: int, dim: int, kernel_init="normal", *,
                 name=None, policy=None, device="cuda"):
        super().__init__(name=name, policy=policy)
        self.vocab_size = int(vocab_size)
        self.dim = int(dim)
        self.kernel_init = kernel_init
        self.table = None
        if device is not None:
            self.build((1, 1), device)

    def _build(self, input_shape, device):
        self.table = self._new_param((self.vocab_size, self.dim), device)

    def param_initializers(self):
        return {"table": initializers.name_of(self.kernel_init)}

    def output_shape(self, input_shape):
        return tuple(input_shape) + (self.dim,)

    def _config(self):
        return {"vocab_size": self.vocab_size, "dim": self.dim,
                "kernel_init": initializers.config_name(self.kernel_init)}

    @classmethod
    def from_config(cls, cfg):
        return super().from_config({**cfg, "device": None})

    def forward(self, ids: torch.Tensor, *, train: bool = False,
                generator=None) -> torch.Tensor:
        table = self.table
        if isinstance(table, Int8Weight):
            # dequantize just the looked-up rows, past the storage padding
            rows = table.q[:, :table.k][ids].float() \
                * table.scale[ids][..., None]
            return rows.to(self.policy.compute_dtype)
        return self.policy.cast_param(table[ids])

    def attend(self, x: torch.Tensor,
               rows: Optional[int] = None) -> torch.Tensor:
        """Tied-softmax logits ``x @ table.T`` in float32. ``rows`` is the
        row count an int8 table dispatches on (``qmatmul``)."""
        table = self.policy.cast_param(self.table)
        if isinstance(table, Int8Weight):
            return qmatmul(x, table, out_dtype=torch.float32, rows=rows)
        return qmatmul(x, table.t())


@register_module("positional_embedding")
class PositionalEmbedding(Module):
    """Learned positional embedding added to (N, S, D) activations.

    With ``max_len`` and ``dim`` the (max_len, dim) table is made at once
    on ``device``; otherwise ``build`` makes it, ``max_len=None`` sizing it
    from the input's sequence length (a ViT's patches and class token).
    """

    _params = ("pos",)

    def __init__(self, max_len: Optional[int] = None,
                 dim: Optional[int] = None, *, kernel_init="normal",
                 name=None, policy=None, device="cuda"):
        super().__init__(name=name, policy=policy)
        self.max_len = None if max_len is None else int(max_len)
        self.kernel_init = kernel_init
        self.pos = None
        if self.max_len is not None and dim is not None:
            self.build((1, self.max_len, int(dim)), device)

    def _build(self, input_shape, device):
        rows = self.max_len if self.max_len is not None else input_shape[-2]
        self.pos = self._new_param((rows, input_shape[-1]), device)

    def param_initializers(self):
        return {"pos": initializers.name_of(self.kernel_init)}

    def _config(self):
        return {"max_len": self.max_len,
                "kernel_init": initializers.config_name(self.kernel_init)}

    def forward(self, x: torch.Tensor, offset=0, *, train: bool = False,
                generator=None) -> torch.Tensor:
        """``offset`` is an int or a (B,) tensor of per-row first positions.

        Positions past the table clamp to its last row. Only padding tokens
        of a ragged step reach them (live positions stay below ``max_len``);
        the JAX package fills those with NaN instead, which no live output
        reads either.
        """
        s = x.shape[-2]
        steps = torch.arange(s, device=x.device)
        if isinstance(offset, torch.Tensor) and offset.ndim:
            idx = offset.long()[:, None] + steps          # (B, S)
        else:
            idx = int(offset) + steps
        idx = idx.clamp_max(self.pos.shape[0] - 1)
        return x + self.policy.cast_param(self.pos[idx])


@register_module("class_token")
class ClassToken(Module):
    """Prepend a learned [CLS] token: (N, S, D) -> (N, S + 1, D). The
    (1, 1, D) token starts at zero, as in the JAX package."""

    _params = ("token",)

    def _build(self, input_shape, device):
        self.token = self._new_param((1, 1, input_shape[-1]), device)

    def forward(self, x, *, train=False, generator=None):
        tok = self.policy.cast_param(self.token).to(x.dtype)
        return torch.cat([tok.expand(x.shape[0], 1, x.shape[-1]), x], dim=1)

    def output_shape(self, input_shape):
        n, s, d = input_shape
        return (n, s + 1, d)

"""Token and learned positional embeddings (``tnn_tpu.nn.embedding``)."""
from __future__ import annotations

import torch
from torch import nn

from ..core import dtypes as dt
from .layers import matmul_f32


class Embedding(nn.Module):
    """Token embedding: int ids (..., S) -> (..., S, dim) in the compute
    dtype, plus the tied output head ``attend``."""

    def __init__(self, vocab_size: int, dim: int, *, policy=None,
                 device="cuda"):
        super().__init__()
        self.policy = policy or dt.default_policy()
        self.table = nn.Parameter(
            torch.zeros(vocab_size, dim, dtype=self.policy.compute_dtype,
                        device=device), requires_grad=False)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return self.table[ids]

    def attend(self, x: torch.Tensor) -> torch.Tensor:
        """Tied-softmax logits ``x @ table.T`` in float32."""
        return matmul_f32(x, self.table.t())


class PositionalEmbedding(nn.Module):
    """Learned positional embedding added to (N, S, D) activations."""

    def __init__(self, max_len: int, dim: int, *, policy=None,
                 device="cuda"):
        super().__init__()
        self.policy = policy or dt.default_policy()
        self.pos = nn.Parameter(
            torch.zeros(max_len, dim, dtype=self.policy.compute_dtype,
                        device=device), requires_grad=False)

    def forward(self, x: torch.Tensor, offset=0) -> torch.Tensor:
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
        return x + self.pos[idx]

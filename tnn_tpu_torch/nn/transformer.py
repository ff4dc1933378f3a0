"""Pre-LN GPT decoder block (``tnn_tpu.nn.transformer.GPTBlock``), dense
MLP only."""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..core import dtypes as dt
from .attention import MultiHeadAttention
from .layers import Dense
from .norms import LayerNorm


class GPTBlock(nn.Module):
    """x + attn(ln1(x)), then x + proj(gelu(fc(ln2(x))))."""

    def __init__(self, d_model: int, num_heads: int, *, mlp_ratio: int = 4,
                 num_kv_heads: Optional[int] = None, policy=None,
                 device="cuda"):
        super().__init__()
        p = policy or dt.default_policy()
        self.ln1 = LayerNorm(d_model, policy=p, device=device)
        self.attn = MultiHeadAttention(d_model, num_heads,
                                       num_kv_heads=num_kv_heads, policy=p,
                                       device=device)
        self.ln2 = LayerNorm(d_model, policy=p, device=device)
        self.fc = Dense(d_model, mlp_ratio * d_model, activation="gelu",
                        policy=p, device=device)
        self.proj = Dense(mlp_ratio * d_model, d_model, policy=p,
                          device=device)

    def _mlp(self, x):
        return x + self.proj(self.fc(self.ln2(x)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._mlp(x + self.attn(self.ln1(x)))

    def apply_paged(self, x, pages_k, pages_v, block_tables, offsets, layer,
                    q_lens=None):
        """``forward`` against the paged KV pool; see
        ``MultiHeadAttention.apply_paged`` for the contract."""
        h = self.attn.apply_paged(self.ln1(x), pages_k, pages_v,
                                  block_tables, offsets, layer=layer,
                                  q_lens=q_lens)
        return self._mlp(x + h)

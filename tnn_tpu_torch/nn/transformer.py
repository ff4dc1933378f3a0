"""Pre-LN GPT decoder block (``tnn_tpu.nn.transformer.GPTBlock``), dense
MLP only."""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..core import dtypes as dt
from .attention import MultiHeadAttention
from .layers import Dense, Dropout
from .norms import LayerNorm


class GPTBlock(nn.Module):
    """x + drop(attn(ln1(x))), then x + drop(proj(gelu(fc(ln2(x))))).

    ``backend`` picks the attention backend ("xla" or "pallas", the flash
    kernels); ``dropout`` applies, when training, inside the attention
    block and after each residual branch, drawing from the caller's
    generator in that order. ``kv_cache_dtype="int8"`` quantizes the
    decode cache (``MultiHeadAttention``)."""

    def __init__(self, d_model: int, num_heads: int, *, mlp_ratio: int = 4,
                 num_kv_heads: Optional[int] = None, backend: str = "xla",
                 dropout: float = 0.0, kv_cache_dtype: Optional[str] = None,
                 policy=None, device="cuda"):
        super().__init__()
        p = policy or dt.default_policy()
        self.ln1 = LayerNorm(d_model, policy=p, device=device)
        self.attn = MultiHeadAttention(d_model, num_heads,
                                       num_kv_heads=num_kv_heads,
                                       backend=backend, dropout=dropout,
                                       kv_cache_dtype=kv_cache_dtype,
                                       policy=p, device=device)
        self.drop = Dropout(dropout)
        self.ln2 = LayerNorm(d_model, policy=p, device=device)
        self.fc = Dense(d_model, mlp_ratio * d_model, activation="gelu",
                        policy=p, device=device)
        self.proj = Dense(mlp_ratio * d_model, d_model, policy=p,
                          device=device)

    def _mlp(self, x, train=False, generator=None):
        h = self.proj(self.fc(self.ln2(x)))
        return x + self.drop(h, train=train, generator=generator)

    def forward(self, x: torch.Tensor, *, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        h = self.attn(self.ln1(x), train=train, generator=generator)
        x = x + self.drop(h, train=train, generator=generator)
        return self._mlp(x, train, generator)

    def init_cache(self, batch: int, max_len: int):
        return self.attn.init_cache(batch, max_len)

    def apply_cached(self, x, cache, offset):
        """``forward`` for new tokens at ``offset`` against a KV cache that
        it updates in place; see ``MultiHeadAttention.apply_cached``."""
        h, cache = self.attn.apply_cached(self.ln1(x), cache, offset)
        return self._mlp(x + h), cache

    def apply_paged(self, x, pages_k, pages_v, block_tables, offsets, layer,
                    q_lens=None):
        """``forward`` against the paged KV pool; see
        ``MultiHeadAttention.apply_paged`` for the contract."""
        h = self.attn.apply_paged(self.ln1(x), pages_k, pages_v,
                                  block_tables, offsets, layer=layer,
                                  q_lens=q_lens)
        return self._mlp(x + h)

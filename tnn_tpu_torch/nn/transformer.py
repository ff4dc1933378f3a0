"""Pre-LN transformer blocks (``tnn_tpu.nn.transformer``): the GPT
decoder block, with a dense MLP or a mixture-of-experts FFN
(``moe_experts > 0``), and the ViT encoder block, the same block without
the causal mask."""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..core import dtypes as dt
from .attention import MultiHeadAttention
from .layers import Dense, Dropout
from .moe import MoE
from .norms import LayerNorm


class GPTBlock(nn.Module):
    """x + drop(attn(ln1(x))), then x + drop(proj(gelu(fc(ln2(x))))).

    ``backend`` picks the attention backend ("xla" or "pallas", the flash
    kernels); ``dropout`` applies, when training, inside the attention
    block and after each residual branch, drawing from the caller's
    generator in that order. ``kv_cache_dtype="int8"`` quantizes the
    decode cache (``MultiHeadAttention``).

    ``moe_experts > 0`` replaces the MLP by a top-``moe_top_k`` ``MoE`` of
    that many experts (hidden width ``mlp_ratio * d_model``); ``fc`` and
    ``proj`` are None then, ``moe`` None otherwise. The training forward
    keeps the MoE's state (``{"aux_loss": ...}``, ``{}`` for a dense
    block) in ``net_state``; the cached and paged forwards drop it, as the
    JAX block does. MoE draws nothing from the generator (the JAX block
    splits a fourth key for MoE blocks only, which keeps dense blocks'
    draws unchanged; the port's draws are sequential, so they stay so)."""

    def __init__(self, d_model: int, num_heads: int, *, mlp_ratio: int = 4,
                 num_kv_heads: Optional[int] = None, backend: str = "xla",
                 dropout: float = 0.0, kv_cache_dtype: Optional[str] = None,
                 moe_experts: int = 0, moe_top_k: int = 2,
                 causal: bool = True, policy=None, device="cuda"):
        super().__init__()
        p = policy or dt.default_policy()
        self.mlp_ratio = int(mlp_ratio)
        self.moe_experts = int(moe_experts)
        self.moe_top_k = int(moe_top_k)
        self.net_state: dict = {}
        self.ln1 = LayerNorm(d_model, policy=p, device=device)
        self.attn = MultiHeadAttention(d_model, num_heads,
                                       num_kv_heads=num_kv_heads,
                                       causal=causal, backend=backend,
                                       dropout=dropout,
                                       kv_cache_dtype=kv_cache_dtype,
                                       policy=p, device=device)
        self.drop = Dropout(dropout)
        self.ln2 = LayerNorm(d_model, policy=p, device=device)
        self.moe = self.fc = self.proj = None
        if self.moe_experts > 0:
            self.moe = MoE(d_model, self.moe_experts, top_k=self.moe_top_k,
                           activation="gelu", hidden_ratio=self.mlp_ratio,
                           policy=p, device=device)
            # capacity tells identical padding rows apart, and a paged
            # decode step's padding rows read back the scratch slot they
            # all write: its writer must not vary from run to run
            self.attn.last_writer_scatter = True
        else:
            self.fc = Dense(d_model, mlp_ratio * d_model,
                            activation="gelu", policy=p, device=device)
            self.proj = Dense(mlp_ratio * d_model, d_model, policy=p,
                              device=device)

    def param_slots(self):
        """(path in the block's JAX tree, owning module, attribute) of each
        weight."""
        for ln in ("ln1", "ln2"):
            yield (ln, "scale"), getattr(self, ln), "scale"
            yield (ln, "bias"), getattr(self, ln), "bias"
        for name in ("qkv_kernel", "qkv_bias", "out_kernel", "out_bias"):
            yield ("attn", name), self.attn, name
        if self.moe is not None:
            yield ("moe", "gate", "kernel"), self.moe, "gate_kernel"
            for name in ("w_in", "b_in", "w_out", "b_out"):
                yield ("moe", name), self.moe, name
            return
        for dense in ("fc", "proj"):
            yield (dense, "kernel"), getattr(self, dense), "kernel"
            yield (dense, "bias"), getattr(self, dense), "bias"

    def _ffn(self, h):
        """The MLP or the MoE over ln2's output: (out, the layer's
        state)."""
        if self.moe is not None:
            out, aux = self.moe(h)
            return out, {"aux_loss": aux}
        return self.proj(self.fc(h)), {}

    def _mlp(self, x, train=False, generator=None):
        """x + drop(ffn(ln2(x))) and the layer's state."""
        h, state = self._ffn(self.ln2(x))
        return x + self.drop(h, train=train, generator=generator), state

    def forward(self, x: torch.Tensor, *, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        h = self.attn(self.ln1(x), train=train, generator=generator)
        x = x + self.drop(h, train=train, generator=generator)
        x, self.net_state = self._mlp(x, train, generator)
        return x

    def init_cache(self, batch: int, max_len: int):
        return self.attn.init_cache(batch, max_len)

    def apply_cached(self, x, cache, offset):
        """``forward`` for new tokens at ``offset`` against a KV cache that
        it updates in place; see ``MultiHeadAttention.apply_cached``."""
        h, cache = self.attn.apply_cached(self.ln1(x), cache, offset)
        return self._mlp(x + h)[0], cache

    def apply_paged(self, x, pages_k, pages_v, block_tables, offsets, layer,
                    q_lens=None):
        """``forward`` against the paged KV pool; see
        ``MultiHeadAttention.apply_paged`` for the contract."""
        h = self.attn.apply_paged(self.ln1(x), pages_k, pages_v,
                                  block_tables, offsets, layer=layer,
                                  q_lens=q_lens)
        return self._mlp(x + h)[0]


class EncoderBlock(GPTBlock):
    """The non-causal pre-LN encoder block of a ViT
    (``tnn_tpu.nn.transformer.EncoderBlock``): ``GPTBlock`` with
    ``causal=False``."""

    def __init__(self, d_model: int, num_heads: int, *, mlp_ratio: int = 4,
                 backend: str = "xla", dropout: float = 0.0, policy=None,
                 device="cuda"):
        super().__init__(d_model, num_heads, mlp_ratio=mlp_ratio,
                         backend=backend, dropout=dropout, causal=False,
                         policy=policy, device=device)

"""Llama-family decoder-only LM (``tnn_tpu.models.llama``): RoPE, RMSNorm,
SwiGLU and grouped-query attention, with tied embeddings by default.

``models.gpt2.generate`` drives it as it drives GPT-2 (duck-typed on
``init_cache`` / ``apply_cached`` / ``max_len``). Paged serving of a Llama
(``apply_paged`` with RoPE) is not ported yet.
"""
from __future__ import annotations

from typing import Iterator, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..core import dtypes as dt
from ..nn.attention import MultiHeadAttention
from ..nn.embedding import Embedding
from ..nn.layers import Dense
from ..nn.norms import RMSNorm
from ..ops.quant_matmul import qmatmul
from ..utils.device import resolve_device
from .params import JaxParamModule


class LlamaBlock(nn.Module):
    """Pre-RMSNorm decoder block: x + attn(rms(x)), then x + swiglu(rms(x))
    with swiglu(h) = down(silu(gate(h)) * up(h)), three bias-free
    projections; silu in f32, cast to up's dtype before the product, as in
    the JAX block. Attention is causal, bias-free and rotary."""

    def __init__(self, d_model: int, num_heads: int, mlp_hidden: int, *,
                 num_kv_heads: Optional[int] = None,
                 rope_theta: float = 10000.0, backend: str = "xla",
                 policy=None, device="cuda"):
        super().__init__()
        p = policy or dt.default_policy()
        self.ln1 = RMSNorm(d_model, policy=p, device=device)
        self.attn = MultiHeadAttention(
            d_model, num_heads, num_kv_heads=num_kv_heads, causal=True,
            backend=backend, rope_theta=rope_theta, use_bias=False,
            policy=p, device=device)
        self.ln2 = RMSNorm(d_model, policy=p, device=device)
        self.gate = Dense(d_model, mlp_hidden, use_bias=False, policy=p,
                          device=device)
        self.up = Dense(d_model, mlp_hidden, use_bias=False, policy=p,
                        device=device)
        self.down = Dense(mlp_hidden, d_model, use_bias=False, policy=p,
                          device=device)

    def _swiglu(self, h):
        u = self.up(h)
        return self.down(F.silu(self.gate(h).float()).to(u.dtype) * u)

    def forward(self, x: torch.Tensor, *, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = x + self.attn(self.ln1(x), train=train, generator=generator)
        return x + self._swiglu(self.ln2(x))

    def init_cache(self, batch: int, max_len: int):
        return self.attn.init_cache(batch, max_len)

    def apply_cached(self, x, cache, offset):
        """``forward`` for new tokens at ``offset`` against a KV cache that
        it updates in place (rotated keys)."""
        h, cache = self.attn.apply_cached(self.ln1(x), cache, offset)
        x = x + h
        return x + self._swiglu(self.ln2(x)), cache


class Llama(JaxParamModule):
    """Decoder-only LM: wte -> n x LlamaBlock -> RMSNorm -> head.

    No positional table: positions enter through RoPE, so ``max_len``
    bounds only the decode cache. ``mlp_hidden`` defaults to 8/3 d rounded
    up to a multiple of 128. The head is the tied embedding
    (``Embedding.attend``) or, with ``tie_embeddings=False``, a bias-free
    (d, V) kernel through ``qmatmul`` with f32 logits, as in the JAX model.

    ``forward(ids)`` gives (N, S, V) float32 logits, differentiable in every
    f32 master parameter; ``apply_cached`` steps a KV cache. Weights come
    from ``seed`` (None leaves them zero) or ``load_jax_params``.
    ``device`` defaults to "cuda" and raises without a card.
    """

    def __init__(self, vocab_size: int = 32000, max_len: int = 2048,
                 num_layers: int = 12, d_model: int = 768,
                 num_heads: int = 12, num_kv_heads: Optional[int] = None,
                 mlp_hidden: Optional[int] = None,
                 rope_theta: float = 10000.0, *, backend: str = "xla",
                 tie_embeddings: bool = True, policy=None, device="cuda",
                 seed: Optional[int] = 0):
        super().__init__()
        self.device = resolve_device(device)
        self.policy = p = policy or dt.default_policy()
        self.vocab_size = int(vocab_size)
        self.max_len = int(max_len)
        self.num_layers = int(num_layers)
        self.d_model = int(d_model)
        self.num_heads = int(num_heads)
        self.num_kv_heads = int(num_kv_heads) if num_kv_heads \
            else self.num_heads
        self.mlp_hidden = int(mlp_hidden) if mlp_hidden else (
            (8 * self.d_model // 3 + 127) // 128 * 128)
        self.rope_theta = float(rope_theta)
        self.backend = backend
        dev = self.device
        self.wte = Embedding(vocab_size, d_model, policy=p, device=dev)
        self.blocks = nn.ModuleList(
            LlamaBlock(d_model, num_heads, self.mlp_hidden,
                       num_kv_heads=self.num_kv_heads, rope_theta=rope_theta,
                       backend=backend, policy=p, device=dev)
            for _ in range(num_layers))
        self.ln_f = RMSNorm(d_model, policy=p, device=dev)
        self.head = None if tie_embeddings else Dense(
            d_model, vocab_size, use_bias=False, policy=p, device=dev)
        if seed is not None:
            self.init_params(seed)

    def _param_slots(self) -> Iterator[Tuple[Tuple[str, ...], nn.Module,
                                             str]]:
        yield ("wte", "table"), self.wte, "table"
        yield ("ln_f", "scale"), self.ln_f, "scale"
        if self.head is not None:
            yield ("head", "kernel"), self.head, "kernel"
        for i, blk in enumerate(self.blocks):
            h = f"h{i}"
            for ln in ("ln1", "ln2"):
                yield (h, ln, "scale"), getattr(blk, ln), "scale"
            for name in ("qkv_kernel", "out_kernel"):
                yield (h, "attn", name), blk.attn, name
            for dense in ("gate", "up", "down"):
                yield (h, dense, "kernel"), getattr(blk, dense), "kernel"

    def _head(self, x: torch.Tensor) -> torch.Tensor:
        """f32 logits of the final hidden state."""
        x = self.ln_f(x)
        if self.head is None:
            return self.wte.attend(x)
        return qmatmul(x, self.policy.cast_param(self.head.kernel),
                       out_dtype=torch.float32)

    def forward(self, ids: torch.Tensor, *, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = self.wte(ids)
        for blk in self.blocks:
            x = blk(x, train=train, generator=generator)
        return self._head(x)

    def init_cache(self, batch: int, max_len: Optional[int] = None):
        """One zeroed KV cache per block for ``apply_cached``."""
        max_len = max_len or self.max_len
        return [blk.init_cache(batch, max_len) for blk in self.blocks]

    def apply_cached(self, ids, caches, offset):
        """Forward ids (N, S_new) given caches covering [0, offset), which
        it extends in place; returns the new positions' f32 logits."""
        x = self.wte(ids)
        for blk, cache in zip(self.blocks, caches):
            x, _ = blk.apply_cached(x, cache, offset)
        return self._head(x)


def llama_small(**kw) -> Llama:
    """12L/768d, 12 q heads / 4 kv heads (D=64), SwiGLU 2048."""
    return Llama(num_layers=12, d_model=768, num_heads=12, num_kv_heads=4,
                 **kw)


def llama_1b(**kw) -> Llama:
    """16L/2048d, 32 q heads (D=64) / 8 kv heads."""
    return Llama(num_layers=16, d_model=2048, num_heads=32, num_kv_heads=8,
                 **kw)

"""Llama-family decoder-only LM (``tnn_tpu.models.llama``): RoPE, RMSNorm,
SwiGLU and grouped-query attention, with tied embeddings by default.

``models.gpt2.generate`` drives it as it drives GPT-2 (duck-typed on
``init_cache`` / ``apply_cached`` / ``max_len``); ``kv_cache_dtype="int8"``
quantizes that cache. ``MultiHeadAttention.apply_paged`` rotates at each
row's positions, but the engine serves no Llama, as the JAX engine does
not.
"""
from __future__ import annotations

from typing import Iterator, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..core import dtypes as dt
from ..core.module import Module, model_config, register_module
from ..nn.attention import MultiHeadAttention
from ..nn.embedding import Embedding
from ..nn.layers import Dense
from ..nn.norms import RMSNorm
from ..nn.run import LocalRun
from ..ops.quant_matmul import qmatmul
from ..utils.device import resolve_device
from .params import JaxParamModule


@register_module("llama_block")
class LlamaBlock(Module):
    """Pre-RMSNorm decoder block: x + attn(rms(x)), then x + swiglu(rms(x))
    with swiglu(h) = down(silu(gate(h)) * up(h)), three bias-free
    projections; silu in f32, cast to up's dtype before the product, as in
    the JAX block. Attention is causal, bias-free and rotary. With
    ``d_model`` the weights are made at once on ``device``; with None
    (registered as "llama_block") ``build`` sizes them from the input."""

    def __init__(self, d_model: Optional[int] = None,
                 num_heads: Optional[int] = None,
                 mlp_hidden: Optional[int] = None, *,
                 num_kv_heads: Optional[int] = None,
                 rope_theta: float = 10000.0, backend: str = "xla",
                 kv_cache_dtype: Optional[str] = None, name=None,
                 policy=None, device="cuda"):
        super().__init__(name=name, policy=policy)
        p = self.policy
        self.num_heads = int(num_heads)
        self.mlp_hidden = int(mlp_hidden)
        self.num_kv_heads = int(num_kv_heads) if num_kv_heads \
            else self.num_heads
        self.rope_theta = float(rope_theta)
        self.backend = backend
        self.kv_cache_dtype = kv_cache_dtype
        self.ln1 = RMSNorm(None, policy=p)
        self.attn = MultiHeadAttention(
            None, num_heads, num_kv_heads=num_kv_heads, causal=True,
            backend=backend, rope_theta=rope_theta, use_bias=False,
            kv_cache_dtype=kv_cache_dtype, policy=p)
        self.ln2 = RMSNorm(None, policy=p)
        self.gate = Dense(None, self.mlp_hidden, use_bias=False, policy=p)
        self.up = Dense(None, self.mlp_hidden, use_bias=False, policy=p)
        self.down = None
        if d_model is not None:
            self.build((1, int(d_model)), device)

    def _build(self, input_shape, device):
        for part in (self.ln1, self.attn, self.ln2, self.gate, self.up):
            part.build(input_shape, device)
        self.down = Dense(self.mlp_hidden, int(input_shape[-1]),
                          use_bias=False, policy=self.policy, device=device)

    def _param_slots(self):
        for key in ("ln1", "attn", "ln2", "gate", "up", "down"):
            for path, owner, attr in getattr(self, key)._param_slots():
                yield (key,) + path, owner, attr

    def _config(self):
        cfg = {"num_heads": self.num_heads, "mlp_hidden": self.mlp_hidden,
               "rope_theta": self.rope_theta, "backend": self.backend}
        if self.num_kv_heads != self.num_heads:
            cfg["num_kv_heads"] = self.num_kv_heads
        if self.kv_cache_dtype:
            cfg["kv_cache_dtype"] = self.kv_cache_dtype
        return cfg

    def _gate_up(self, h):
        u = self.up(h)
        return F.silu(self.gate(h).float()).to(u.dtype) * u

    def _swiglu(self, h):
        return self.down(self._gate_up(h))

    def forward(self, x: torch.Tensor, *, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return self.run(x, LocalRun(train, generator))

    def run(self, x, run):
        """The forward under ``run`` (``nn.run``: one device, or the
        parallel step's streams)."""
        x = run.add(x, run.layer(self.attn, run.layer(self.ln1, x)))
        h = run.mlp(self._gate_up, [self.gate, self.up], self.down,
                    run.layer(self.ln2, x))
        return run.add(x, h)

    def init_cache(self, batch: int, max_len: int):
        return self.attn.init_cache(batch, max_len)

    def apply_cached(self, x, cache, offset):
        """``forward`` for new tokens at ``offset`` against a KV cache that
        it updates in place (rotated keys)."""
        h, cache = self.attn.apply_cached(self.ln1(x), cache, offset)
        x = x + h
        return x + self._swiglu(self.ln2(x)), cache


@register_module("llama")
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
    ``kv_cache_dtype="int8"`` gives every block an int8 decode cache.
    """

    def __init__(self, vocab_size: int = 32000, max_len: int = 2048,
                 num_layers: int = 12, d_model: int = 768,
                 num_heads: int = 12, num_kv_heads: Optional[int] = None,
                 mlp_hidden: Optional[int] = None,
                 rope_theta: float = 10000.0, *, backend: str = "xla",
                 tie_embeddings: bool = True,
                 kv_cache_dtype: Optional[str] = None, policy=None,
                 device="cuda", seed: Optional[int] = 0):
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
        self.kv_cache_dtype = kv_cache_dtype
        dev = self.device
        self.wte = Embedding(vocab_size, d_model, policy=p, device=dev)
        self.blocks = nn.ModuleList(
            LlamaBlock(d_model, num_heads, self.mlp_hidden,
                       num_kv_heads=self.num_kv_heads, rope_theta=rope_theta,
                       backend=backend, kv_cache_dtype=kv_cache_dtype,
                       policy=p, device=dev)
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

    def get_config(self):
        """The JAX model's config dict (``core.module``)."""
        cfg = {"vocab_size": self.vocab_size, "max_len": self.max_len,
               "num_layers": self.num_layers, "d_model": self.d_model,
               "num_heads": self.num_heads, "mlp_hidden": self.mlp_hidden,
               "rope_theta": self.rope_theta, "backend": self.backend,
               "tie_embeddings": self.head is None}
        if self.num_kv_heads != self.num_heads:
            cfg["num_kv_heads"] = self.num_kv_heads
        if self.kv_cache_dtype:
            cfg["kv_cache_dtype"] = self.kv_cache_dtype
        return model_config(self, cfg)

    def _project(self, x: torch.Tensor) -> torch.Tensor:
        """f32 logits of the post-ln_f hidden state."""
        if self.head is None:
            return self.wte.attend(x)
        return qmatmul(x, self.policy.cast_param(self.head.kernel),
                       out_dtype=torch.float32)

    def _head(self, x: torch.Tensor) -> torch.Tensor:
        """f32 logits of the final hidden state."""
        return self._project(self.ln_f(x))

    def apply_hidden(self, ids: torch.Tensor, *, train: bool = False,
                     generator: Optional[torch.Generator] = None
                     ) -> torch.Tensor:
        """(N, S) ids -> the post-ln_f hidden state (N, S, D), without the
        head (``nn.lm_loss.lm_head_loss``)."""
        return self.run_hidden(ids, LocalRun(train, generator))

    def run_hidden(self, ids, run):
        """``apply_hidden`` under ``run`` (``nn.run``)."""
        x = run.layer(self.wte, ids)
        for blk in self.blocks:
            x = run.layer(blk, x)
        return run.layer(self.ln_f, x)

    def head_table(self) -> torch.Tensor:
        """The (V, D) matrix the head contracts against, in the compute
        dtype: the tied table or the head kernel's transpose."""
        if self.head is None:
            return self.policy.cast_param(self.wte.table)
        return self.policy.cast_param(self.head.kernel).t()

    def forward(self, ids: torch.Tensor, *, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return self._project(self.apply_hidden(ids, train=train,
                                               generator=generator))

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

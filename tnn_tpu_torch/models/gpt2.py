"""GPT-2 (``tnn_tpu.models.gpt2``): wte + wpe -> n_layer x GPTBlock -> ln_f
-> tied-head logits, with the paged forwards the serving engine steps."""
from __future__ import annotations

import math
from typing import Dict, Iterator, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..core import dtypes as dt
from ..nn.embedding import Embedding, PositionalEmbedding
from ..nn.norms import LayerNorm
from ..nn.transformer import GPTBlock
from ..utils.device import resolve_device


class GPT2(nn.Module):
    """Decoder-only LM with a tied output head.

    ``forward(ids)`` is the JAX model's ``apply``: (N, S) ids -> (N, S, V)
    float32 logits over the whole sequence. ``apply_paged`` and
    ``apply_decode_paged`` step the serving engine's ragged batches against
    the paged KV pool, whose pages they update in place.

    Weights come from ``seed`` (a numpy-seeded init with the JAX package's
    initializer families; None leaves them zero) or from
    ``load_jax_params``. ``device`` defaults to "cuda" and raises without a
    card.
    """

    def __init__(self, vocab_size: int = 50257, max_len: int = 1024,
                 num_layers: int = 12, d_model: int = 768,
                 num_heads: int = 12, num_kv_heads: Optional[int] = None,
                 *, policy=None, device="cuda", seed: Optional[int] = 0):
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
        dev = self.device
        self.wte = Embedding(vocab_size, d_model, policy=p, device=dev)
        self.wpe = PositionalEmbedding(max_len, d_model, policy=p, device=dev)
        self.blocks = nn.ModuleList(
            GPTBlock(d_model, num_heads, num_kv_heads=self.num_kv_heads,
                     policy=p, device=dev) for _ in range(num_layers))
        self.ln_f = LayerNorm(d_model, policy=p, device=dev)
        if seed is not None:
            self.init_params(seed)

    # -- weights --------------------------------------------------------------

    def jax_param_paths(self) -> Iterator[Tuple[Tuple[str, ...], nn.Parameter]]:
        """Every parameter beside its path in the JAX parameter tree."""
        yield ("wte", "table"), self.wte.table
        yield ("wpe", "pos"), self.wpe.pos
        yield ("ln_f", "scale"), self.ln_f.scale
        yield ("ln_f", "bias"), self.ln_f.bias
        for i, blk in enumerate(self.blocks):
            h = f"h{i}"
            for ln in ("ln1", "ln2"):
                yield (h, ln, "scale"), getattr(blk, ln).scale
                yield (h, ln, "bias"), getattr(blk, ln).bias
            for name in ("qkv_kernel", "qkv_bias", "out_kernel", "out_bias"):
                yield (h, "attn", name), getattr(blk.attn, name)
            for dense in ("fc", "proj"):
                yield (h, dense, "kernel"), getattr(blk, dense).kernel
                yield (h, dense, "bias"), getattr(blk, dense).bias

    @torch.no_grad()
    def load_jax_params(self, tree: Dict) -> "GPT2":
        """Copy the JAX parameter tree (nested dicts of numpy arrays, e.g.
        ``jax.tree.map(np.asarray, params)``) into this model.

        Kernels keep JAX's (in, out) layout, so nothing is transposed. Each
        value is rounded once into its parameter's dtype, which is the dtype
        the JAX model casts it to at its use site.
        """
        for path, param in self.jax_param_paths():
            node = tree
            for key in path:
                node = node[key]
            value = torch.tensor(np.asarray(node, dtype=np.float32))
            if tuple(value.shape) != tuple(param.shape):
                raise ValueError(f"{'.'.join(path)}: shape {tuple(value.shape)}"
                                 f" != {tuple(param.shape)}")
            param.copy_(value)
        return self

    @torch.no_grad()
    def init_params(self, seed: int) -> "GPT2":
        """Seeded random weights: normal(0.02) embeddings, xavier-uniform
        attention kernels, he-normal MLP kernels, zero biases, unit norms."""
        rng = np.random.default_rng(seed)
        for path, param in self.jax_param_paths():
            name = path[-1]
            shape = tuple(param.shape)
            if name in ("table", "pos"):
                value = rng.standard_normal(shape, dtype=np.float32) * 0.02
            elif name in ("qkv_kernel", "out_kernel"):
                limit = math.sqrt(6.0 / (shape[0] + shape[1]))
                value = rng.uniform(-limit, limit, shape).astype(np.float32)
            elif name == "kernel":
                value = rng.standard_normal(shape, dtype=np.float32) \
                    * math.sqrt(2.0 / shape[0])
            elif name == "scale":
                value = np.ones(shape, np.float32)
            else:
                value = np.zeros(shape, np.float32)
            param.copy_(torch.from_numpy(value))
        return self

    # -- forwards -------------------------------------------------------------

    def _head(self, x: torch.Tensor) -> torch.Tensor:
        return self.wte.attend(self.ln_f(x))   # f32 logits

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        x = self.wpe(self.wte(ids))
        for blk in self.blocks:
            x = blk(x)
        return self._head(x)

    def apply_decode_paged(self, toks, pages_k, pages_v, block_tables,
                           offsets) -> torch.Tensor:
        """One decode step: toks (B,) this step's token per row at positions
        ``offsets`` (B,) int32. Every layer writes its new K/V row into the
        pool pages (in place) and attends over the block tables. Returns
        the (B, V) float32 logits."""
        x = self.wpe(self.wte(toks[:, None]), offset=offsets)
        for i, blk in enumerate(self.blocks):
            x = blk.apply_paged(x, pages_k, pages_v, block_tables, offsets,
                                layer=i)
        return self._head(x)[:, -1]

    def apply_paged(self, toks, pages_k, pages_v, block_tables, offsets,
                    q_lens, *, last_only: bool = False) -> torch.Tensor:
        """Ragged multi-token step: toks (B, Q), row b carrying ``q_lens[b]``
        live tokens from position ``offsets[b]`` (the rest padding). Returns
        (B, Q, V) float32 logits, or with ``last_only`` just each row's
        next-token logits (B, V) at position ``q_lens[b] - 1``, which is all
        the engine reads."""
        x = self.wpe(self.wte(toks), offset=offsets)
        for i, blk in enumerate(self.blocks):
            x = blk.apply_paged(x, pages_k, pages_v, block_tables, offsets,
                                layer=i, q_lens=q_lens)
        if last_only:
            idx = (q_lens.long() - 1).clamp_min(0)
            x = x[torch.arange(x.shape[0], device=x.device), idx][:, None]
            return self._head(x)[:, 0]
        return self._head(x)


def gpt2_tiny(**kw) -> GPT2:
    """2L/128d/2h."""
    return GPT2(num_layers=2, d_model=128, num_heads=2, **kw)


def gpt2_small(**kw) -> GPT2:
    """12L/768d/12h, 50257 vocab, 1024 positions."""
    return GPT2(num_layers=12, d_model=768, num_heads=12, **kw)


def gpt2_small_hd128(**kw) -> GPT2:
    """12L/768d/6h: gpt2_small's widths with 128-wide heads."""
    return GPT2(num_layers=12, d_model=768, num_heads=6, **kw)


def gpt2_small_gqa4(**kw) -> GPT2:
    """12L/768d/12h with 4 KV heads (grouped-query attention)."""
    return GPT2(num_layers=12, d_model=768, num_heads=12, num_kv_heads=4,
                **kw)

"""GPT-2 (``tnn_tpu.models.gpt2``): wte + wpe -> n_layer x GPTBlock -> ln_f
-> tied-head logits; the training forward, KV-cache ``generate``, and the
paged forwards the serving engine steps."""
from __future__ import annotations

import math
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..core import dtypes as dt
from ..nn.embedding import Embedding, PositionalEmbedding
from ..nn.layers import Dropout
from ..nn.norms import LayerNorm
from ..nn.quant import set_weight
from ..nn.transformer import GPTBlock
from ..ops.quant_matmul import Int8Weight
from ..utils.device import resolve_device
from .sampling import sample_ragged


class GPT2(nn.Module):
    """Decoder-only LM with a tied output head.

    ``forward(ids)`` is the JAX model's ``apply``: (N, S) ids -> (N, S, V)
    float32 logits over the whole sequence, differentiable in every
    parameter (``train=True`` turns dropout on, drawing from
    ``generator``). ``apply_cached`` steps a KV cache (``generate``);
    ``apply_paged`` and ``apply_decode_paged`` step the serving engine's
    ragged batches against the paged KV pool, whose pages they update in
    place.

    Parameters are float32 masters (the policy's param dtype), cast to the
    compute dtype at use. Weights come from ``seed`` (``init_params``; None
    leaves them zero) or from ``load_jax_params``. ``backend`` is the
    attention backend ("xla", or "pallas" for the flash kernels).
    ``device`` defaults to "cuda" and raises without a card.
    """

    def __init__(self, vocab_size: int = 50257, max_len: int = 1024,
                 num_layers: int = 12, d_model: int = 768,
                 num_heads: int = 12, num_kv_heads: Optional[int] = None,
                 *, backend: str = "xla", dropout: float = 0.0, policy=None,
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
        self.backend = backend
        dev = self.device
        self.wte = Embedding(vocab_size, d_model, policy=p, device=dev)
        self.wpe = PositionalEmbedding(max_len, d_model, policy=p, device=dev)
        self.drop = Dropout(dropout)
        self.blocks = nn.ModuleList(
            GPTBlock(d_model, num_heads, num_kv_heads=self.num_kv_heads,
                     backend=backend, dropout=dropout, policy=p, device=dev)
            for _ in range(num_layers))
        self.ln_f = LayerNorm(d_model, policy=p, device=dev)
        if seed is not None:
            self.init_params(seed)

    # -- weights --------------------------------------------------------------

    def _param_slots(self) -> Iterator[Tuple[Tuple[str, ...], nn.Module,
                                             str]]:
        """(JAX tree path, owning module, attribute name) of every weight."""
        yield ("wte", "table"), self.wte, "table"
        yield ("wpe", "pos"), self.wpe, "pos"
        yield ("ln_f", "scale"), self.ln_f, "scale"
        yield ("ln_f", "bias"), self.ln_f, "bias"
        for i, blk in enumerate(self.blocks):
            h = f"h{i}"
            for ln in ("ln1", "ln2"):
                yield (h, ln, "scale"), getattr(blk, ln), "scale"
                yield (h, ln, "bias"), getattr(blk, ln), "bias"
            for name in ("qkv_kernel", "qkv_bias", "out_kernel", "out_bias"):
                yield (h, "attn", name), blk.attn, name
            for dense in ("fc", "proj"):
                yield (h, dense, "kernel"), getattr(blk, dense), "kernel"
                yield (h, dense, "bias"), getattr(blk, dense), "bias"

    def jax_param_paths(self) -> Iterator[Tuple[Tuple[str, ...], Any]]:
        """Every weight (a parameter, or an ``Int8Weight`` where the model
        was quantized) beside its path in the JAX parameter tree."""
        for path, module, name in self._param_slots():
            yield path, getattr(module, name)

    @torch.no_grad()
    def load_jax_params(self, tree: Dict) -> "GPT2":
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
                # the table is quantized through its transpose
                want = tuple(param.shape)[::-1] if name == "table" \
                    else tuple(param.shape)
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
    def init_params(self, seed: int) -> "GPT2":
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
        return self

    # -- forwards -------------------------------------------------------------

    def _head(self, x: torch.Tensor,
              rows: Optional[int] = None) -> torch.Tensor:
        """f32 logits; ``rows`` is the row count an int8 head dispatches on
        (``qmatmul``), where x holds only some rows of a larger call."""
        return self.wte.attend(self.ln_f(x), rows=rows)

    def forward(self, ids: torch.Tensor, *, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = self.drop(self.wpe(self.wte(ids)), train=train,
                      generator=generator)
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
        x = self.wpe(self.wte(ids), offset=offset)
        for blk, cache in zip(self.blocks, caches):
            x, _ = blk.apply_cached(x, cache, offset)
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
            # the head runs on B rows but takes the int8 branch that the
            # JAX engine's head over all B*Q positions takes
            return self._head(x, rows=toks.numel())[:, 0]
        return self._head(x)


@torch.inference_mode()
def generate(model: GPT2, prompt_ids, max_new_tokens: int,
             temperature: float = 0.0,
             generator: Optional[torch.Generator] = None,
             max_len: Optional[int] = None, top_k: int = 0,
             top_p: float = 0.0) -> torch.Tensor:
    """Autoregressive generation with a KV cache (``tnn_tpu.models.gpt2.
    generate``): one prefill pass over the prompt, then one token per step.
    temperature <= 0 is greedy; otherwise tokens are drawn with
    ``generator`` (on the model's device) after top-k / top-p filtering.
    The cache defaults to the request's length. Returns (batch,
    max_new_tokens) int64 token ids."""
    prompt = torch.as_tensor(prompt_ids, device=model.device).long()
    if prompt.ndim == 1:
        prompt = prompt[None]
    batch, prompt_len = prompt.shape
    max_len = max_len or min(model.max_len, prompt_len + max_new_tokens)
    if prompt_len + max_new_tokens > max_len:
        raise ValueError(f"prompt_len {prompt_len} + max_new_tokens "
                         f"{max_new_tokens} exceeds max_len {max_len}")
    caches = model.init_cache(batch, max_len)
    last = model.apply_cached(prompt, caches, 0)[:, -1]
    toks = []
    for i in range(max_new_tokens):
        tok = sample_ragged(last, generator, temperature, top_k, top_p)
        toks.append(tok)
        if i + 1 < max_new_tokens:   # the last token's logits are unused
            last = model.apply_cached(tok[:, None], caches,
                                      prompt_len + i)[:, -1]
    return torch.stack(toks, dim=1)


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


def gpt2_medium(**kw) -> GPT2:
    """24L/1024d/16h."""
    return GPT2(num_layers=24, d_model=1024, num_heads=16, **kw)


def gpt2_large(**kw) -> GPT2:
    """36L/1280d/20h."""
    return GPT2(num_layers=36, d_model=1280, num_heads=20, **kw)

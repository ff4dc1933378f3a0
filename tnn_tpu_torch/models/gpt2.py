"""GPT-2 (``tnn_tpu.models.gpt2``): wte + wpe -> n_layer x GPTBlock -> ln_f
-> head logits (tied to wte, or an untied ``head``); the training forward,
KV-cache ``generate``, and the paged forwards the serving engine steps."""
from __future__ import annotations

from typing import Iterator, Optional, Tuple

import torch
from torch import nn

from ..core import dtypes as dt
from ..core.module import model_config, register_module
from ..nn.embedding import Embedding, PositionalEmbedding
from ..nn.layers import Dense, Dropout
from ..nn.norms import LayerNorm
from ..nn.transformer import GPTBlock
from ..ops.quant_matmul import qmatmul
from ..utils.device import resolve_device
from .params import JaxParamModule
from .sampling import sample_ragged


@register_module("gpt2")
class GPT2(JaxParamModule):
    """Decoder-only LM with a tied or untied output head.

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
    ``get_config()`` is the JAX model's config dict (``core.module``).
    ``tie_embeddings=False`` gives the model its own (D, V) ``head``
    kernel (``params["head"]["kernel"]``), whose f32 logits come from
    ``qmatmul``, so ``quantize_for_decode`` quantizes it as any kernel.
    ``moe_experts > 0`` makes every block's MLP a top-2 mixture of that
    many experts (``nn.moe``); ``net_state()`` then holds each block's
    load-balancing loss of the last training forward.
    ``kv_cache_dtype="int8"`` gives every block an int8 decode cache
    (``generate``); the serving engine refuses such a model.
    """

    def __init__(self, vocab_size: int = 50257, max_len: int = 1024,
                 num_layers: int = 12, d_model: int = 768,
                 num_heads: int = 12, num_kv_heads: Optional[int] = None,
                 *, backend: str = "xla", dropout: float = 0.0,
                 tie_embeddings: bool = True, moe_experts: int = 0,
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
        self.backend = backend
        self.dropout = float(dropout)
        self.tie_embeddings = bool(tie_embeddings)
        self.moe_experts = int(moe_experts)
        self.kv_cache_dtype = kv_cache_dtype
        dev = self.device
        self.wte = Embedding(vocab_size, d_model, policy=p, device=dev)
        self.wpe = PositionalEmbedding(max_len, d_model, policy=p, device=dev)
        self.drop = Dropout(dropout)
        self.blocks = nn.ModuleList(
            GPTBlock(d_model, num_heads, num_kv_heads=self.num_kv_heads,
                     backend=backend, dropout=dropout,
                     kv_cache_dtype=kv_cache_dtype,
                     moe_experts=self.moe_experts, policy=p, device=dev)
            for _ in range(num_layers))
        self.ln_f = LayerNorm(d_model, policy=p, device=dev)
        self.head = None if self.tie_embeddings else Dense(
            d_model, vocab_size, use_bias=False, policy=p, device=dev)
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
            if blk.moe is not None:
                yield (h, "moe", "gate", "kernel"), blk.moe, "gate_kernel"
                for name in ("w_in", "b_in", "w_out", "b_out"):
                    yield (h, "moe", name), blk.moe, name
                continue
            for dense in ("fc", "proj"):
                yield (h, dense, "kernel"), getattr(blk, dense), "kernel"
                yield (h, dense, "bias"), getattr(blk, dense), "bias"
        if self.head is not None:
            yield ("head", "kernel"), self.head, "kernel"

    def get_config(self):
        cfg = {"vocab_size": self.vocab_size, "max_len": self.max_len,
               "num_layers": self.num_layers, "d_model": self.d_model,
               "num_heads": self.num_heads, "dropout": self.dropout,
               "backend": self.backend,
               "tie_embeddings": self.tie_embeddings}
        if self.moe_experts:
            cfg["moe_experts"] = self.moe_experts
        if self.num_kv_heads != self.num_heads:
            cfg["num_kv_heads"] = self.num_kv_heads
        if self.kv_cache_dtype:
            cfg["kv_cache_dtype"] = self.kv_cache_dtype
        return model_config(self, cfg)

    # -- forwards -------------------------------------------------------------

    def _head(self, x: torch.Tensor,
              rows: Optional[int] = None) -> torch.Tensor:
        """ln_f, then the f32 logits; ``rows`` is the row count an int8
        head dispatches on (``qmatmul``), where x holds only some rows of a
        larger call."""
        return self._logits(self.ln_f(x), rows=rows)

    def _logits(self, h: torch.Tensor,
                rows: Optional[int] = None) -> torch.Tensor:
        """The head over post-ln_f hidden states: f32 logits."""
        if self.head is None:
            return self.wte.attend(h, rows=rows)
        w = self.policy.cast_param(self.head.kernel)
        return qmatmul(h, w, out_dtype=torch.float32, rows=rows)

    def apply_hidden(self, ids: torch.Tensor, *, train: bool = False,
                     generator: Optional[torch.Generator] = None
                     ) -> torch.Tensor:
        """(N, S) ids -> the post-ln_f hidden state (N, S, D), without the
        head: what ``nn.lm_loss.lm_head_loss`` contracts against
        ``head_table()`` in vocab tiles."""
        x = self.drop(self.wpe(self.wte(ids)), train=train,
                      generator=generator)
        for blk in self.blocks:
            x = blk(x, train=train, generator=generator)
        return self.ln_f(x)

    def head_table(self) -> torch.Tensor:
        """The (V, D) matrix the head contracts against: the tied table or
        the untied kernel's transpose, in the compute dtype,
        differentiable into the f32 master."""
        if self.head is not None:
            return self.policy.cast_param(self.head.kernel).t()
        return self.policy.cast_param(self.wte.table)

    def net_state(self):
        """The JAX model's mutable state after the last training forward:
        ``{"h{i}": {"aux_loss": ...}}`` for each MoE block (empty for a
        dense model)."""
        return {f"h{i}": blk.net_state for i, blk in enumerate(self.blocks)
                if blk.net_state}

    def forward(self, ids: torch.Tensor, *, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return self._logits(self.apply_hidden(ids, train=train,
                                              generator=generator))

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
def generate(model, prompt_ids, max_new_tokens: int,
             temperature: float = 0.0,
             generator: Optional[torch.Generator] = None,
             max_len: Optional[int] = None, top_k: int = 0,
             top_p: float = 0.0) -> torch.Tensor:
    """Autoregressive generation with a KV cache (``tnn_tpu.models.gpt2.
    generate``): one prefill pass over the prompt, then one token per step.
    ``model`` is a ``GPT2`` or a ``Llama``: anything with ``init_cache``,
    ``apply_cached``, ``max_len`` and ``device``.
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

"""Fused-stack GPT-2 decode (``tnn_tpu.models.fused_decode``): the glue
between the ``GPT2`` module tree and ``ops.decode_stack`` (K8, one launch
per token).

``stack_decode_weights`` stacks every block's int8 weights and f32 vectors
into the (L, ...) tensors the kernel reads; ``caches_to_stacked`` turns the
per-layer caches that prefill fills into the kernel's (L, B, T, D) layout;
``fused_generate`` prefills through ``apply_cached`` and then runs one K8
launch, ln_f and the tied head per token.

The model must be a copy made by ``nn.quant.quantize_for_decode``: the
kernel's matmuls are int8 x int8. Models the kernel cannot run (float
weights, padded int8 weights, grouped-query attention, an int8 cache, MoE
blocks) and geometries ``pick_chunks`` refuses raise ValueError; the
caller falls back to ``models.gpt2.generate``.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from ..ops.decode_stack import fused_decode_stack
from ..ops.quant_matmul import Int8Weight
from .sampling import sample_ragged


def _iw(module, name: str) -> Int8Weight:
    w = getattr(module, name)
    if not isinstance(w, Int8Weight):
        raise ValueError(
            f"fused decode needs int8 params ({name} is {type(w).__name__}); "
            "run nn.quant.quantize_for_decode(model) first")
    if tuple(w.q.shape) != (w.n, w.k):
        raise ValueError(f"{name}: stored shape {tuple(w.q.shape)} carries "
                         f"padding (logical {(w.n, w.k)}); dims must be "
                         "multiples of 128 for the fused kernel")
    return w


def stack_decode_weights(model) -> Dict[str, torch.Tensor]:
    """Stack every block's weights into (L, ...) tensors for the kernel
    (keys ``ops.decode_stack.STACK_KEYS``): int8 (L, N, K) values, f32
    scales, biases and LayerNorm vectors."""
    if getattr(model, "kv_cache_dtype", None):
        # the stacked cache the kernel reads is in the compute dtype; an
        # int8 + scale cache would reach it as raw codes
        raise ValueError("fused decode does not support kv_cache_dtype="
                         f"{model.kv_cache_dtype!r}; use the standard "
                         "generate() path")
    if getattr(model, "num_kv_heads", model.num_heads) != model.num_heads:
        raise ValueError("fused decode does not support grouped-query "
                         "attention (num_kv_heads != num_heads)")
    blocks = list(model.blocks)
    for blk in blocks:
        if getattr(blk, "moe", None) is not None:
            raise ValueError("fused decode does not support MoE blocks")

    def stack(get):
        return torch.stack([get(b).detach().float() for b in blocks])

    def stack_q(get):
        return torch.stack([get(b).q for b in blocks])

    return {
        "ln1_s": stack(lambda b: b.ln1.scale),
        "ln1_b": stack(lambda b: b.ln1.bias),
        "ln2_s": stack(lambda b: b.ln2.scale),
        "ln2_b": stack(lambda b: b.ln2.bias),
        "qkv_q": stack_q(lambda b: _iw(b.attn, "qkv_kernel")),
        "qkv_s": stack(lambda b: b.attn.qkv_kernel.scale),
        "qkv_b": stack(lambda b: b.attn.qkv_bias),
        "out_q": stack_q(lambda b: _iw(b.attn, "out_kernel")),
        "out_s": stack(lambda b: b.attn.out_kernel.scale),
        "out_b": stack(lambda b: b.attn.out_bias),
        "fc_q": stack_q(lambda b: _iw(b.fc, "kernel")),
        "fc_s": stack(lambda b: b.fc.kernel.scale),
        "fc_b": stack(lambda b: b.fc.bias),
        "proj_q": stack_q(lambda b: _iw(b.proj, "kernel")),
        "proj_s": stack(lambda b: b.proj.kernel.scale),
        "proj_b": stack(lambda b: b.proj.bias),
    }


def caches_to_stacked(caches):
    """Per-layer {"k": (B, H, T, Dh), "v": ...} caches -> the (L, B, T, D)
    pair, new contiguous tensors."""
    def flat(c):
        b, h, t, dh = c.shape
        return c.transpose(1, 2).reshape(b, t, h * dh)

    return (torch.stack([flat(c["k"]) for c in caches]),
            torch.stack([flat(c["v"]) for c in caches]))


def pick_chunks(d_model: int, mlp_hidden: int, batch: int, max_len: int,
                cache_bytes: int = 2, budget: int = 15 * 2 ** 20):
    """Smallest MLP chunk count whose footprint fits the TPU kernel's VMEM
    budget (double-buffered int8 weight blocks, the KV staging 2 B T D,
    about 2 MB of temporaries); None when even 8 chunks do not fit.

    Copied exactly from the JAX package. The budget is the TPU core's, not
    a limit of this card, but the chunk count changes the numerics (the
    GELU output is quantized per chunk), so the port picks what the
    reference picks, and refuses what it refuses."""
    fixed = 2 * batch * max_len * d_model * cache_bytes + 2 * 2 ** 20
    for c in (1, 2, 4, 8):
        if mlp_hidden % c:
            continue
        w = 4 * d_model * d_model + 2 * (mlp_hidden // c) * d_model
        if 2 * w + fixed <= budget:
            return c
    return None


def decode_stacks(model) -> Dict[str, torch.Tensor]:
    """``stack_decode_weights(model)``, built once per model object and
    weight load: stacking copies every layer's weights. A
    ``quantize_for_decode`` copy is a new object, and ``load_jax_params``
    / ``init_params`` drop the stacks of the weights they replace, so new
    weights never meet old stacks."""
    stacks = getattr(model, "_fused_stacks", None)
    if stacks is None:
        stacks = model._fused_stacks = stack_decode_weights(model)
    return stacks


@torch.inference_mode()
def fused_generate(model, prompt_ids, max_new_tokens: int,
                   temperature: float = 0.0,
                   generator: Optional[torch.Generator] = None,
                   max_len: Optional[int] = None,
                   chunks: Optional[int] = None, top_k: int = 0,
                   top_p: float = 0.0) -> torch.Tensor:
    """``models.gpt2.generate`` with K8 on the per-token path.

    ``model`` is a ``quantize_for_decode`` copy of a GPT2. Prefill runs
    ``apply_cached``; each generated token is wte + wpe, one
    ``fused_decode_stack`` launch, ln_f and the tied head on B rows (w8a8,
    as the JAX head at B rows). The last token's logits are unused, so
    there are ``max_new_tokens - 1`` launches (the JAX scan makes
    ``max_new_tokens``, the last one unused). Returns (batch,
    max_new_tokens) int64 token ids; greedy when temperature <= 0."""
    prompt = torch.as_tensor(prompt_ids, device=model.device).long()
    if prompt.ndim == 1:
        prompt = prompt[None]
    batch, prompt_len = prompt.shape
    max_len = max_len or min(model.max_len, prompt_len + max_new_tokens)
    if prompt_len + max_new_tokens > max_len:
        raise ValueError("prompt + new tokens exceed max_len")
    if chunks is None:
        chunks = pick_chunks(model.d_model, 4 * model.d_model, batch,
                             max_len)
        if chunks is None:
            raise ValueError("model too large for the fused kernel's "
                             "budget; use models.gpt2.generate")
    stacks = decode_stacks(model)
    caches = model.init_cache(batch, max_len)
    last = model.apply_cached(prompt, caches, 0)[:, -1]
    kc, vc = caches_to_stacked(caches)
    del caches
    toks = []
    for i in range(max_new_tokens):
        tok = sample_ragged(last, generator, temperature, top_k, top_p)
        toks.append(tok)
        if i + 1 == max_new_tokens:
            break
        offset = prompt_len + i
        x = model.wpe(model.wte(tok[:, None]), offset=offset)[:, 0]
        x_out, kc, vc = fused_decode_stack(
            x, offset, kc, vc, stacks,
            num_heads=model.num_heads, chunks=chunks)
        last = model._head(x_out[:, None, :])[:, -1]
    return torch.stack(toks, dim=1)

"""Multi-head attention (``tnn_tpu.nn.attention``): ``sdpa`` with its
"xla" and "pallas" (flash kernel) backends, and the whole-sequence, cached
and paged forms of ``MultiHeadAttention``."""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from ..core import dtypes as dt
from ..ops import flash_attention as fa
from ..ops import paged_attention as pa
from ..ops.quant_matmul import qmatmul
from .layers import Dropout

_MASK_VALUE = -1e9   # tnn_tpu.core.dtypes.neg_inf


def local_attention(q, k, v, *, causal: bool = False, mask=None,
                    scale: Optional[float] = None, kv_offset=None):
    """Plain softmax attention over (B, H, S, Dh) tensors, the JAX package's
    ``local_xla_attention`` (sdpa's "xla" backend): f32 logits,
    probabilities rounded to v's dtype before the PV product, f32
    accumulation. GQA repeats the kv heads. ``kv_offset`` is an int, a 0-d
    tensor or a (B,) tensor of per-row positions of q[0]; ``mask`` a boolean
    broadcastable to (B, H, Sq, Skv), whose fully masked rows output 0.
    Differentiable."""
    sq, skv = q.shape[-2], k.shape[-2]
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if k.shape[1] != q.shape[1]:
        g = q.shape[1] // k.shape[1]
        k = k.repeat_interleave(g, dim=1)
        v = v.repeat_interleave(g, dim=1)
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    live = None
    if causal:
        qpos = torch.arange(sq, device=q.device)[:, None]
        if kv_offset is not None:
            off = torch.as_tensor(kv_offset, device=q.device)
            qpos = qpos + (off[:, None, None, None] if off.ndim else off)
        live = qpos >= torch.arange(skv, device=q.device)[None, :]
        logits = torch.where(live, logits, _MASK_VALUE)
    if mask is not None:
        mask = torch.as_tensor(mask, device=q.device).bool()
        live = mask if live is None else mask & live
        logits = torch.where(mask, logits, _MASK_VALUE)
    probs = torch.softmax(logits, dim=-1)
    if mask is not None:
        # a fully masked row attends to nothing (output 0), as the flash
        # kernel's l == 0 rows do
        row_live = live.broadcast_to(logits.shape).any(dim=-1, keepdim=True)
        probs = torch.where(row_live, probs, 0.0)
    out = torch.einsum("bhqk,bhkd->bhqd", probs.to(v.dtype).float(),
                       v.float())
    return out.to(v.dtype)


def sdpa(q, k, v, *, causal: bool = False, mask=None,
         scale: Optional[float] = None, backend: str = "xla",
         kv_offset=None):
    """Scaled dot-product attention over (B, H, S, Dh) tensors
    (``tnn_tpu.nn.attention.sdpa``).

    ``backend="pallas"`` runs the flash kernels (K4 forward, K7 backward)
    when ``kv_offset`` is absent or a scalar; a per-row (B,) ``kv_offset``
    (ragged cached decode) takes the plain "xla" path, as in the JAX
    package. The port has no sequence-parallel context yet, so
    ``backend="ring"`` raises, as the JAX package does outside one.
    """
    if backend == "ring":
        raise RuntimeError(
            "backend='ring' needs a sequence-parallel ring context, which "
            "the port does not have yet (ROADMAP.md); use 'xla' or 'pallas'")
    if backend not in ("xla", "pallas"):
        raise ValueError(f"unknown attention backend {backend!r}")
    ragged = kv_offset is not None and getattr(kv_offset, "ndim", 0) > 0
    if backend == "pallas" and not ragged:
        return fa.flash_attention(q, k, v, causal=causal, scale=scale,
                                  mask=mask, kv_offset=kv_offset)
    return local_attention(q, k, v, causal=causal, mask=mask, scale=scale,
                           kv_offset=kv_offset)


class MultiHeadAttention(nn.Module):
    """Multi-head self-attention over (N, S, D) with a fused qkv projection
    and grouped-query attention (``num_kv_heads`` < ``num_heads``).

    Kernels keep JAX's (in, out) layout: ``qkv_kernel`` is (D, D + 2 * kv_d)
    with columns [q | k | v]. Every parameter is trainable and kept in the
    policy's param dtype; kernels and biases are cast to the compute dtype
    at use, as the JAX layer does. Either kernel may be an ``Int8Weight``
    (``nn.quant``); both projections go through ``qmatmul``. ``backend``
    picks ``sdpa``'s backend; ``dropout`` applies to the output projection
    when training.
    """

    def __init__(self, d_model: int, num_heads: int, *,
                 num_kv_heads: Optional[int] = None, causal: bool = True,
                 backend: str = "xla", dropout: float = 0.0, policy=None,
                 device="cuda"):
        super().__init__()
        self.policy = policy or dt.default_policy()
        self.num_heads = int(num_heads)
        self.num_kv_heads = int(num_kv_heads) if num_kv_heads \
            else self.num_heads
        if self.num_kv_heads <= 0 or self.num_heads % self.num_kv_heads:
            raise ValueError(f"num_kv_heads {self.num_kv_heads} must be a "
                             f"positive divisor of num_heads "
                             f"{self.num_heads}")
        if d_model % self.num_heads:
            raise ValueError(f"model dim {d_model} not divisible by "
                             f"num_heads {self.num_heads}")
        self.causal = bool(causal)
        self.backend = backend
        self.drop = Dropout(dropout)
        self.d_model = int(d_model)
        self.head_dim = d_model // self.num_heads
        self.kv_d = self.head_dim * self.num_kv_heads
        pd = self.policy.param_dtype

        def param(*shape):
            return nn.Parameter(torch.zeros(*shape, dtype=pd, device=device))

        self.qkv_kernel = param(d_model, d_model + 2 * self.kv_d)
        self.qkv_bias = param(d_model + 2 * self.kv_d)
        self.out_kernel = param(d_model, d_model)
        self.out_bias = param(d_model)

    def _project_qkv(self, x):
        """(B, S, D) -> q (B, S, H, Dh), k and v (B, S, H_kv, Dh)."""
        x = self.policy.cast_in(x)
        w = self.policy.cast_param(self.qkv_kernel)
        qkv = qmatmul(x, w).to(x.dtype)
        qkv = qkv + self.qkv_bias.to(x.dtype)
        b, s, _ = x.shape
        d, kv_d, dh = self.d_model, self.kv_d, self.head_dim
        q = qkv[..., :d].reshape(b, s, self.num_heads, dh)
        k = qkv[..., d:d + kv_d].reshape(b, s, self.num_kv_heads, dh)
        v = qkv[..., d + kv_d:].reshape(b, s, self.num_kv_heads, dh)
        return q, k, v

    def _project_out(self, attn, train=False, generator=None):
        """(B, S, H, Dh) -> (B, S, D) in the io dtype."""
        y = attn.reshape(*attn.shape[:2], self.d_model)
        w = self.policy.cast_param(self.out_kernel)
        y = qmatmul(y, w).to(y.dtype) + self.out_bias.to(y.dtype)
        y = self.drop(y, train=train, generator=generator)
        return self.policy.cast_out(y)

    def forward(self, x: torch.Tensor, *, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Whole-sequence attention (JAX's ``_apply``)."""
        q, k, v = self._project_qkv(x)
        attn = sdpa(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                    causal=self.causal, backend=self.backend)
        return self._project_out(attn.transpose(1, 2), train, generator)

    # -- cached autoregressive decode -----------------------------------------

    def init_cache(self, batch: int, max_len: int):
        """A zeroed (k, v) cache of (batch, H_kv, max_len, Dh) in the
        compute dtype (the int8 cache waits for the int8 slice)."""
        shape = (batch, self.num_kv_heads, max_len, self.head_dim)
        dev = self.qkv_kernel.device
        cd = self.policy.compute_dtype
        return {"k": torch.zeros(shape, dtype=cd, device=dev),
                "v": torch.zeros(shape, dtype=cd, device=dev)}

    def apply_cached(self, x, cache, offset):
        """Decode step: x (N, S_new, D); ``cache`` holds keys and values for
        positions [0, offset). ``offset`` is an int (uniform batch) or an
        (N,) tensor (each row writes and masks at its own position).

        The new K/V rows are written into ``cache`` IN PLACE (the JAX
        package returns an updated copy); attention runs over the whole
        cache buffer with a causal mask at ``offset``, through the
        configured backend (the flash kernel with ``kv_offset`` under
        "pallas"). Returns (out (N, S_new, D), cache)."""
        q, k_new, v_new = self._project_qkv(x)          # (N, S, H*, Dh)
        s = x.shape[1]
        if isinstance(offset, torch.Tensor) and offset.ndim:
            pos = offset.long()[:, None] + torch.arange(s, device=x.device)
            rows = torch.arange(x.shape[0], device=x.device)[:, None]
            cache["k"][rows, :, pos] = k_new.to(cache["k"].dtype)
            cache["v"][rows, :, pos] = v_new.to(cache["v"].dtype)
        else:
            off = int(offset)
            cache["k"][:, :, off:off + s] = k_new.transpose(1, 2)
            cache["v"][:, :, off:off + s] = v_new.transpose(1, 2)
        backend = self.backend if self.backend != "ring" else "xla"
        out = sdpa(q.transpose(1, 2), cache["k"], cache["v"], causal=True,
                   kv_offset=offset, backend=backend)
        return self._project_out(out.transpose(1, 2)), cache

    def apply_paged(self, x, pages_k, pages_v, block_tables, offsets,
                    layer: int = 0, q_lens=None):
        """One step straight against the paged KV pool.

        x : (B, Q, D) this step's new tokens per row (Q = 1 for pure decode).
        pages_k / pages_v : the pool's (L, N, H_kv, bs, Dh) tensors, or its
            ``QuantPages`` bundles under int8; the new K/V rows of ``layer``
            are written into them IN PLACE (an int8 pool quantizes them as
            it writes, so they are not cast first).
        block_tables : (B, nb) int32; offsets : (B,) int32 the position each
            row writes first (its kv length before this step).
        q_lens : (B,) int32 live tokens per row, or None for the decode form
            (Q must then be 1). Tokens past ``q_lens[b]`` are padding: their
            KV lands in the scratch page and their outputs are garbage.

        Returns the attention block's output (B, Q, D).
        """
        q, k_new, v_new = self._project_qkv(x)
        if not isinstance(pages_k, pa.QuantPages):
            k_new, v_new = k_new.to(pages_k.dtype), v_new.to(pages_v.dtype)
        if q_lens is None:
            if x.shape[1] != 1:
                raise ValueError("apply_paged with Q > 1 requires q_lens")
            pa.scatter_kv_rows(pages_k, block_tables, offsets, k_new[:, 0],
                               layer=layer)
            pa.scatter_kv_rows(pages_v, block_tables, offsets, v_new[:, 0],
                               layer=layer)
            out = pa.paged_attention(q[:, 0].contiguous(), pages_k, pages_v,
                                     block_tables, kv_lens=offsets + 1,
                                     layer=layer)
            return self._project_out(out[:, None])
        pa.scatter_kv_chunk(pages_k, block_tables, offsets, k_new, q_lens,
                            layer=layer)
        pa.scatter_kv_chunk(pages_v, block_tables, offsets, v_new, q_lens,
                            layer=layer)
        out = pa.paged_attention(q.contiguous(), pages_k, pages_v,
                                 block_tables, kv_lens=offsets + q_lens,
                                 q_lens=q_lens, layer=layer)
        return self._project_out(out)

"""Multi-head attention (``tnn_tpu.nn.attention``): the whole-sequence
form and the paged form the serving engine steps through."""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from ..core import dtypes as dt
from ..ops import paged_attention as pa
from .layers import matmul_f32

_MASK_VALUE = -1e9   # tnn_tpu.core.dtypes.neg_inf


def local_attention(q, k, v, *, causal: bool = False,
                    scale: Optional[float] = None):
    """Plain softmax attention over (B, H, S, Dh) tensors, the JAX package's
    ``local_xla_attention``: f32 logits, probabilities rounded to v's dtype
    before the PV product, f32 accumulation. GQA repeats the kv heads."""
    sq, skv = q.shape[-2], k.shape[-2]
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if k.shape[1] != q.shape[1]:
        g = q.shape[1] // k.shape[1]
        k = k.repeat_interleave(g, dim=1)
        v = v.repeat_interleave(g, dim=1)
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if causal:
        qpos = torch.arange(sq, device=q.device)[:, None]
        kpos = torch.arange(skv, device=q.device)[None, :]
        logits = torch.where(qpos >= kpos, logits, _MASK_VALUE)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", probs.to(v.dtype).float(),
                       v.float())
    return out.to(v.dtype)


class MultiHeadAttention(nn.Module):
    """Multi-head self-attention over (N, S, D) with a fused qkv projection
    and grouped-query attention (``num_kv_heads`` < ``num_heads``).

    Kernels keep JAX's (in, out) layout in the compute dtype: ``qkv_kernel``
    is (D, D + 2 * kv_d) with columns [q | k | v]; the biases are read in
    the compute dtype, as the JAX layer adds them.
    """

    def __init__(self, d_model: int, num_heads: int, *,
                 num_kv_heads: Optional[int] = None, causal: bool = True,
                 policy=None, device="cuda"):
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
        self.d_model = int(d_model)
        self.head_dim = d_model // self.num_heads
        self.kv_d = self.head_dim * self.num_kv_heads
        cd = self.policy.compute_dtype

        def param(*shape):
            return nn.Parameter(torch.zeros(*shape, dtype=cd, device=device),
                                requires_grad=False)

        self.qkv_kernel = param(d_model, d_model + 2 * self.kv_d)
        self.qkv_bias = param(d_model + 2 * self.kv_d)
        self.out_kernel = param(d_model, d_model)
        self.out_bias = param(d_model)

    def _project_qkv(self, x):
        """(B, S, D) -> q (B, S, H, Dh), k and v (B, S, H_kv, Dh)."""
        x = self.policy.cast_in(x)
        qkv = matmul_f32(x, self.qkv_kernel).to(x.dtype)
        qkv = qkv + self.qkv_bias
        b, s, _ = x.shape
        d, kv_d, dh = self.d_model, self.kv_d, self.head_dim
        q = qkv[..., :d].reshape(b, s, self.num_heads, dh)
        k = qkv[..., d:d + kv_d].reshape(b, s, self.num_kv_heads, dh)
        v = qkv[..., d + kv_d:].reshape(b, s, self.num_kv_heads, dh)
        return q, k, v

    def _project_out(self, attn):
        """(B, S, H, Dh) -> (B, S, D) in the io dtype."""
        y = attn.reshape(*attn.shape[:2], self.d_model)
        y = matmul_f32(y, self.out_kernel).to(y.dtype) + self.out_bias
        return self.policy.cast_out(y)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """Whole-sequence attention (JAX's ``_apply``)."""
        q, k, v = self._project_qkv(x)
        attn = local_attention(q.transpose(1, 2), k.transpose(1, 2),
                               v.transpose(1, 2), causal=self.causal)
        return self._project_out(attn.transpose(1, 2))

    def apply_paged(self, x, pages_k, pages_v, block_tables, offsets,
                    layer: int = 0, q_lens=None):
        """One step straight against the paged KV pool.

        x : (B, Q, D) this step's new tokens per row (Q = 1 for pure decode).
        pages_k / pages_v : the pool's (L, N, H_kv, bs, Dh) tensors; the new
            K/V rows of ``layer`` are written into them IN PLACE.
        block_tables : (B, nb) int32; offsets : (B,) int32 the position each
            row writes first (its kv length before this step).
        q_lens : (B,) int32 live tokens per row, or None for the decode form
            (Q must then be 1). Tokens past ``q_lens[b]`` are padding: their
            KV lands in the scratch page and their outputs are garbage.

        Returns the attention block's output (B, Q, D).
        """
        q, k_new, v_new = self._project_qkv(x)
        if q_lens is None:
            if x.shape[1] != 1:
                raise ValueError("apply_paged with Q > 1 requires q_lens")
            pa.scatter_kv_rows(pages_k, block_tables, offsets,
                               k_new[:, 0].to(pages_k.dtype), layer=layer)
            pa.scatter_kv_rows(pages_v, block_tables, offsets,
                               v_new[:, 0].to(pages_v.dtype), layer=layer)
            out = pa.paged_attention(q[:, 0].contiguous(), pages_k, pages_v,
                                     block_tables, kv_lens=offsets + 1,
                                     layer=layer)
            return self._project_out(out[:, None])
        pa.scatter_kv_chunk(pages_k, block_tables, offsets,
                            k_new.to(pages_k.dtype), q_lens, layer=layer)
        pa.scatter_kv_chunk(pages_v, block_tables, offsets,
                            v_new.to(pages_v.dtype), q_lens, layer=layer)
        out = pa.paged_attention(q.contiguous(), pages_k, pages_v,
                                 block_tables, kv_lens=offsets + q_lens,
                                 q_lens=q_lens, layer=layer)
        return self._project_out(out)

"""Multi-head attention (``tnn_tpu.nn.attention``): ``sdpa`` with its
"xla" and "pallas" (flash kernel) backends, rotary position embedding
(``apply_rope``), and the whole-sequence, cached and paged forms of
``MultiHeadAttention``.

Sequence parallelism is a run-time context, not model configuration:
inside ``with ring_context(mesh, method=...)`` every ``sdpa`` call that
can run as a ring (no mask, no ``kv_offset``) runs as ``method`` ("ring":
``parallel.ring_attention``, "ulysses": ``parallel.ulysses_attention``)
over the mesh's seq positions, whatever the model's backend; the model is
never mutated, so it decodes on one device after a seq-parallel run.
``backend="ring"`` outside a context raises.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from ..core.module import Module, register_module
from ..ops import flash_attention as fa
from ..ops import paged_attention as pa
from ..ops.quant_matmul import qmatmul
from . import initializers
from .layers import Dropout

_MASK_VALUE = -1e9   # tnn_tpu.core.dtypes.neg_inf

# the active sequence-parallel context (``ring_context``)
_RING_CTX = {"mesh": None, "axis": "seq", "batch_axis": None,
             "method": "ring"}


class ring_context:
    """``with ring_context(mesh, axis="seq"): step(...)``: seq-parallel
    attention (the module docstring). ``batch_axis`` (a name or a tuple of
    names) also cuts the batch, each batch shard running its own ring;
    ``method`` is "ring" (K/V rotation, any head count) or "ulysses"
    (all-to-all head re-sharding, num_heads % sp == 0)."""

    def __init__(self, mesh, axis: str = "seq", batch_axis=None,
                 method: str = "ring"):
        if method not in ("ring", "ulysses"):
            raise ValueError(f"unknown seq-parallel method {method!r}")
        self.mesh, self.axis, self.batch_axis = mesh, axis, batch_axis
        self.method = method

    def __enter__(self):
        self._prev = dict(_RING_CTX)
        _RING_CTX.update(mesh=self.mesh, axis=self.axis,
                         batch_axis=self.batch_axis, method=self.method)
        return self

    def __exit__(self, *exc):
        _RING_CTX.update(self._prev)


def active_ring_context() -> dict:
    """The active context's mesh, axis, batch_axis and method (mesh None
    outside any)."""
    return dict(_RING_CTX)


def count_attention_modules(module) -> int:
    """How many submodules carry a switchable attention ``backend`` (what
    a seq-parallel layout checks it has to parallelize); mutates
    nothing."""
    return set_attention_backend(module, None)


def set_attention_backend(module, backend) -> int:
    """Set ``backend`` on every submodule that has one (a model built with
    "xla" runs the flash kernels after ``set_attention_backend(m,
    "pallas")``); ``backend=None`` only counts. Returns the count."""
    count = 0
    for m in module.modules():
        if hasattr(m, "backend"):
            if backend is not None:
                m.backend = backend
            count += 1
    return count


def apply_rope(x, offset=0, theta: float = 10000.0):
    """Rotary position embedding over (B, H, S, Dh) (``tnn_tpu.nn.attention.
    apply_rope``): half-split (NeoX) pairs rotated in f32 by the ABSOLUTE
    position ``offset + s``, cast back to x's dtype. ``offset`` is an int, a
    0-d tensor or a (B,) tensor of per-row positions of x[..., 0, :].

    The inverse frequencies theta^(-i / half) take the exponent in f32 and
    the power in f64, rounded once to f32: the correctly rounded values,
    which are the JAX package's. A float32 ``pow`` may land one ulp off, and
    at position 32,767 one ulp of a frequency turns the angle by up to
    2e-3 rad."""
    d = x.shape[-1]
    if d % 2:
        raise ValueError(f"RoPE needs an even head dim, got {d}")
    half = d // 2
    steps = torch.arange(x.shape[-2], device=x.device)
    if isinstance(offset, torch.Tensor) and offset.ndim:
        pos = offset.to(x.device).long()[:, None] + steps       # (B, S)
    else:
        pos = int(offset) + steps
    expo = -torch.arange(half, dtype=torch.float32, device=x.device) / half
    inv = torch.pow(torch.tensor(float(theta), dtype=torch.float64,
                                 device=x.device), expo.double()).float()
    freqs = pos[..., None].float() * inv                        # (.., S, half)
    cos, sin = torch.cos(freqs), torch.sin(freqs)
    if cos.ndim == 3:      # per-row: (B, S, half) over the head dim
        cos, sin = cos[:, None], sin[:, None]
    x1 = x[..., :half].float()
    x2 = x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def local_xla_attention(q, k, v, *, causal: bool = False, mask=None,
                        scale: Optional[float] = None, kv_offset=None):
    """The plain attention math, bypassing the ring context: the JAX
    package's name for ``local_attention``."""
    return local_attention(q, k, v, causal=causal, mask=mask, scale=scale,
                           kv_offset=kv_offset)


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
        if isinstance(kv_offset, torch.Tensor) \
                or getattr(kv_offset, "ndim", 0):
            off = torch.as_tensor(kv_offset, device=q.device)
            qpos = qpos + (off[:, None, None, None] if off.ndim else off)
        elif kv_offset is not None:
            # a scalar stays on the host: a tensor made of it would be a
            # blocking copy to the card
            qpos = qpos + int(kv_offset)
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
    package. Inside a ``ring_context`` a call without mask and kv_offset
    runs as the context's method over its mesh, whatever ``backend``;
    ``backend="ring"`` outside one raises the JAX package's errors.
    """
    ringable = mask is None and kv_offset is None
    if _RING_CTX["mesh"] is not None and ringable:
        ctx = _RING_CTX
        if ctx["method"] == "ulysses":
            from ..parallel.ulysses import ulysses_attention as par
        else:
            from ..parallel.ring_attention import ring_attention as par
        return par(q, k, v, ctx["mesh"], axis=ctx["axis"], causal=causal,
                   scale=scale, batch_axis=ctx["batch_axis"])
    if backend == "ring":
        raise RuntimeError(
            "backend='ring' needs an enclosing nn.attention.ring_context(mesh)"
            " — e.g. train_model with mesh_axes={'seq': N}" if ringable else
            "ring attention does not support mask/kv_offset (cached decode); "
            "run decode outside the ring context with backend='xla'")
    if backend not in ("xla", "pallas"):
        raise ValueError(f"unknown attention backend {backend!r}")
    ragged = kv_offset is not None and getattr(kv_offset, "ndim", 0) > 0
    if backend == "pallas" and not ragged:
        return fa.flash_attention(q, k, v, causal=causal, scale=scale,
                                  mask=mask, kv_offset=kv_offset)
    return local_attention(q, k, v, causal=causal, mask=mask, scale=scale,
                           kv_offset=kv_offset)


@register_module("multihead_attention")
class MultiHeadAttention(Module):
    """Multi-head self-attention over (N, S, D) with a fused qkv projection
    and grouped-query attention (``num_kv_heads`` < ``num_heads``).

    Kernels keep JAX's (in, out) layout: ``qkv_kernel`` is (D, D + 2 * kv_d)
    with columns [q | k | v]. Every parameter is trainable and kept in the
    policy's param dtype; kernels and biases are cast to the compute dtype
    at use, as the JAX layer does. Either kernel may be an ``Int8Weight``
    (``nn.quant``); both projections go through ``qmatmul``. ``backend``
    picks ``sdpa``'s backend; ``dropout`` applies to the output projection
    when training. ``rope_theta`` rotates q and k by their absolute
    positions after the projection split (Llama; None: no rotation), and
    ``use_bias=False`` drops both biases.

    With ``d_model`` the weights are made at once on ``device``; with None
    (a ``Sequential`` child, or a layer rebuilt from its config, registered
    as "multihead_attention") ``build`` sizes them from the input.
    """

    _params = ("qkv_kernel", "qkv_bias", "out_kernel", "out_bias")

    def __init__(self, d_model: Optional[int] = None,
                 num_heads: Optional[int] = None, *,
                 num_kv_heads: Optional[int] = None, causal: bool = True,
                 backend: str = "xla", dropout: float = 0.0,
                 rope_theta: Optional[float] = None, use_bias: bool = True,
                 kv_cache_dtype: Optional[str] = None,
                 kernel_init="xavier_uniform", name=None, policy=None,
                 device="cuda"):
        super().__init__(name=name, policy=policy)
        if kv_cache_dtype not in (None, "int8"):
            raise ValueError(f"kv_cache_dtype {kv_cache_dtype!r}: only "
                             "None (compute dtype) or 'int8' supported")
        self.kv_cache_dtype = kv_cache_dtype
        self.num_heads = int(num_heads)
        self.num_kv_heads = int(num_kv_heads) if num_kv_heads \
            else self.num_heads
        if self.num_kv_heads <= 0 or self.num_heads % self.num_kv_heads:
            raise ValueError(f"num_kv_heads {self.num_kv_heads} must be a "
                             f"positive divisor of num_heads "
                             f"{self.num_heads}")
        self.causal = bool(causal)
        self.rope_theta = float(rope_theta) if rope_theta else None
        self.use_bias = bool(use_bias)
        self.backend = backend
        self.dropout = float(dropout)
        self.kernel_init = kernel_init
        self.drop = Dropout(dropout)
        self.qkv_kernel = self.qkv_bias = None
        self.out_kernel = self.out_bias = None
        # the paged scatters' last-writer rule (ops.paged_attention.
        # scatter_kv_rows): set by a block whose rows interact (MoE)
        self.last_writer_scatter = False
        if d_model is not None:
            self.build((1, int(d_model)), device)

    def _build(self, input_shape, device):
        d = int(input_shape[-1])
        if d % self.num_heads:
            raise ValueError(f"model dim {d} not divisible by "
                             f"num_heads {self.num_heads}")
        self.d_model = d
        self.head_dim = d // self.num_heads
        self.kv_d = self.head_dim * self.num_kv_heads
        self.qkv_kernel = self._new_param((d, d + 2 * self.kv_d), device)
        self.out_kernel = self._new_param((d, d), device)
        if self.use_bias:
            self.qkv_bias = self._new_param((d + 2 * self.kv_d,), device)
            self.out_bias = self._new_param((d,), device)

    def _config(self):
        cfg = {"num_heads": self.num_heads, "causal": self.causal,
               "dropout": self.dropout, "backend": self.backend,
               "num_kv_heads": self.num_kv_heads,
               "kernel_init": initializers.config_name(self.kernel_init)}
        if self.kv_cache_dtype:
            cfg["kv_cache_dtype"] = self.kv_cache_dtype
        if self.rope_theta:
            cfg["rope_theta"] = self.rope_theta
        if not self.use_bias:
            cfg["use_bias"] = False
        return cfg

    def param_initializers(self):
        """The JAX layer's initializers (seeded ``Module.init_params``);
        the biases start at zero."""
        name = initializers.name_of(self.kernel_init)
        return {"qkv_kernel": name, "out_kernel": name}

    def _project_qkv(self, x):
        """(B, S, D) -> q (B, S, h, Dh), k and v (B, S, h_kv, Dh): h = H
        and h_kv = H_kv, or a tensor-parallel piece's heads when the
        kernel holds only its columns (``parallel.tensor_parallel.
        _permute_qkv``)."""
        x = self.policy.cast_in(x)
        w = self.policy.cast_param(self.qkv_kernel)
        qkv = qmatmul(x, w).to(x.dtype)
        if self.qkv_bias is not None:
            qkv = qkv + self.qkv_bias.to(x.dtype)
        b, s, _ = x.shape
        dh = self.head_dim
        heads = qkv.shape[-1] // dh
        kv = heads // (self.num_heads // self.num_kv_heads + 2)
        q, k, v = qkv.split([(heads - 2 * kv) * dh, kv * dh, kv * dh], -1)
        return (q.reshape(b, s, -1, dh), k.reshape(b, s, kv, dh),
                v.reshape(b, s, kv, dh))

    def _out_product(self, attn):
        """(B, S, h, Dh) -> attn @ out_kernel, (B, S, D) f32: the whole
        product, or a tensor-parallel piece's partial one."""
        y = attn.reshape(*attn.shape[:2], -1)
        return qmatmul(y, self.policy.cast_param(self.out_kernel))

    def _out_finish(self, y, dtype, train=False, generator=None):
        """The out product in ``dtype`` (attention's), its bias and
        dropout, in the io dtype."""
        y = y.to(dtype)
        if self.out_bias is not None:
            y = y + self.out_bias.to(dtype)
        y = self.drop(y, train=train, generator=generator)
        return self.policy.cast_out(y)

    def _project_out(self, attn, train=False, generator=None):
        """(B, S, H, Dh) -> (B, S, D) in the io dtype."""
        return self._out_finish(self._out_product(attn), attn.dtype, train,
                                generator)

    def forward(self, x: torch.Tensor, *, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Whole-sequence attention (JAX's ``_apply``)."""
        q, k, v = (t.transpose(1, 2) for t in self._project_qkv(x))
        if self.rope_theta:
            q = apply_rope(q, 0, self.rope_theta)
            k = apply_rope(k, 0, self.rope_theta)
        attn = sdpa(q, k, v, causal=self.causal, backend=self.backend)
        return self._project_out(attn.transpose(1, 2), train, generator)

    def output_shape(self, input_shape):
        return tuple(input_shape)

    # -- cached autoregressive decode -----------------------------------------

    def init_cache(self, batch: int, max_len: int):
        """A zeroed (k, v) cache of (batch, H_kv, max_len, Dh) in the
        compute dtype; with ``kv_cache_dtype="int8"`` int8 ``k`` / ``v``
        beside f32 ``k_scale`` / ``v_scale`` of (batch, H_kv, max_len, 1)."""
        shape = (batch, self.num_kv_heads, max_len, self.head_dim)
        dev = self.qkv_kernel.device
        if self.kv_cache_dtype == "int8":
            def z(dtype, last):
                return torch.zeros(shape[:-1] + (last,), dtype=dtype,
                                   device=dev)
            return {"k": z(torch.int8, self.head_dim),
                    "v": z(torch.int8, self.head_dim),
                    "k_scale": z(torch.float32, 1),
                    "v_scale": z(torch.float32, 1)}
        cd = self.policy.compute_dtype
        return {"k": torch.zeros(shape, dtype=cd, device=dev),
                "v": torch.zeros(shape, dtype=cd, device=dev)}

    @staticmethod
    def _quant_rows(x):
        """Symmetric per-row (per position, per head) int8: scale = amax /
        127, amax clamped at 1e-8; ``torch.round`` rounds half to even, as
        ``jnp.round`` does."""
        xf = x.float()
        scale = xf.abs().amax(dim=-1, keepdim=True).clamp_min(1e-8) / 127.0
        q = torch.round(xf / scale).clamp(-127, 127).to(torch.int8)
        return q, scale

    def apply_cached(self, x, cache, offset):
        """Decode step: x (N, S_new, D); ``cache`` holds keys and values for
        positions [0, offset). ``offset`` is an int (uniform batch) or an
        (N,) tensor (each row writes and masks at its own position).

        The new K/V rows are written into ``cache`` IN PLACE (the JAX
        package returns an updated copy); attention runs over the whole
        cache buffer with a causal mask at ``offset``, through the
        configured backend (the flash kernel with ``kv_offset`` under
        "pallas"). With ``rope_theta`` q and the new keys are rotated at
        their absolute positions, so the cache holds rotated keys. An int8
        cache stores the new rows quantized and attention reads the whole
        cache dequantized to the compute dtype. Returns (out (N, S_new, D),
        cache)."""
        q, k_new, v_new = self._project_qkv(x)          # (N, S, H*, Dh)
        if self.rope_theta:
            q, k_new = (apply_rope(t.transpose(1, 2), offset,
                                   self.rope_theta).transpose(1, 2)
                        for t in (q, k_new))
        s = x.shape[1]
        if isinstance(offset, torch.Tensor) and offset.ndim:
            pos = offset.long()[:, None] + torch.arange(s, device=x.device)
            rows = torch.arange(x.shape[0], device=x.device)[:, None]

            def put(buf, new):                   # new (N, S, H, last)
                buf[rows, :, pos] = new.to(buf.dtype)
        else:
            off = int(offset)

            def put(buf, new):
                buf[:, :, off:off + s] = new.transpose(1, 2).to(buf.dtype)
        if self.kv_cache_dtype == "int8":
            for name, new in (("k", k_new), ("v", v_new)):
                codes, scale = self._quant_rows(new)
                put(cache[name], codes)
                put(cache[name + "_scale"], scale)
            cd = self.policy.compute_dtype
            k = (cache["k"].float() * cache["k_scale"]).to(cd)
            v = (cache["v"].float() * cache["v_scale"]).to(cd)
        else:
            put(cache["k"], k_new)
            put(cache["v"], v_new)
            k, v = cache["k"], cache["v"]
        backend = self.backend if self.backend != "ring" else "xla"
        out = sdpa(q.transpose(1, 2), k, v, causal=True, kv_offset=offset,
                   backend=backend)
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

        With ``rope_theta`` q and the new keys are rotated at their
        absolute positions, ``offsets + arange(Q)`` per row, so the pages
        hold rotated keys. A model with ``kv_cache_dtype`` raises: the pool
        stores its own pages (``kv_dtype="int8"`` quantizes those).

        Returns the attention block's output (B, Q, D).
        """
        if self.kv_cache_dtype == "int8":
            raise NotImplementedError(
                "paged decode with int8 KV pages is future work: pool pages "
                "are compute-dtype (quantize the pool with kv_dtype='int8')")
        q, k_new, v_new = self._project_qkv(x)
        if self.rope_theta:
            q, k_new = (apply_rope(t.transpose(1, 2), offsets,
                                   self.rope_theta).transpose(1, 2)
                        for t in (q, k_new))
        if not isinstance(pages_k, pa.QuantPages):
            k_new, v_new = k_new.to(pages_k.dtype), v_new.to(pages_v.dtype)
        if q_lens is None:
            if x.shape[1] != 1:
                raise ValueError("apply_paged with Q > 1 requires q_lens")
            pa.scatter_kv_rows(pages_k, block_tables, offsets, k_new[:, 0],
                               layer=layer,
                               last_writer=self.last_writer_scatter)
            pa.scatter_kv_rows(pages_v, block_tables, offsets, v_new[:, 0],
                               layer=layer,
                               last_writer=self.last_writer_scatter)
            out = pa.paged_attention(q[:, 0].contiguous(), pages_k, pages_v,
                                     block_tables, kv_lens=offsets + 1,
                                     layer=layer)
            return self._project_out(out[:, None])
        pa.scatter_kv_chunk(pages_k, block_tables, offsets, k_new, q_lens,
                            layer=layer, last_writer=self.last_writer_scatter)
        pa.scatter_kv_chunk(pages_v, block_tables, offsets, v_new, q_lens,
                            layer=layer, last_writer=self.last_writer_scatter)
        out = pa.paged_attention(q.contiguous(), pages_k, pages_v,
                                 block_tables, kv_lens=offsets + q_lens,
                                 q_lens=q_lens, layer=layer)
        return self._project_out(out)

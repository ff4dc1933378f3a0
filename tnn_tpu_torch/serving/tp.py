"""Tensor-parallel serving (``tnn_tpu.serving.tp``): one replica's attention
heads and MLP columns split over tp shards.

Each shard owns ``H/tp`` query heads and ``H_kv/tp`` KV heads of every
layer and a column slice of the MLP; the paged pool splits on its head axis
(``kv_pool.PagedKVPool(tp=)``), so each shard holds its heads of EVERY
block and sweeps its own pages with the unmodified paged-attention kernel.
Exactly two all-reduces per layer (after the attention out-projection and
after the MLP down-projection, ``all_reduce``) rebuild the replicated
residual stream. Embeddings, layer norms, the head and sampling run once,
on the lead shard's device (the model's), so the engine's host-side
bookkeeping (block tables, refcounts, prefix index, scheduler) is that of
tp = 1.

Layout of shard s of tp (the JAX package's ``_spec_for``):

    qkv_kernel  (D, D + 2*KVD)   columns, after ``_permute_qkv``
    qkv_bias    (D + 2*KVD,)     columns, same permutation
    out_kernel  (D, D)           rows (head-major)
    fc/kernel   (D, 4D)          columns
    fc/bias     (4D,)            columns
    proj/kernel (4D, D)          rows
    out_bias, proj/bias, ln*, wte, wpe, head   replicated (the base model's)

The fused qkv kernel's columns are ``[q | k | v]``; ``_permute_qkv``
reorders them once, at load, to ``[q_0 k_0 v_0 | q_1 k_1 v_1 | ...]``, so
an even column split hands each shard whole heads of all three.

Placement: the JAX package shards over a device mesh under ``shard_map``.
The port has no mesh: ``TPContext.devices`` names one device per shard,
and a device may repeat. The default on CUDA is the first tp cards; on the
CPU it is tp copies of "cpu" (the counterpart of the JAX suite's virtual
CPU devices). Shards that share a card run every TP code path, the kernel
on per-shard pages included, but move no data between cards: they measure
neither NCCL nor peer bandwidth.

Exactness contract (the JAX package's): the qkv and fc products contract
over the full, unsplit axis, and attention never mixes heads, so both are
those of tp = 1 per head and column. Only the two split-K sums per layer
differ, about an ulp in f32; greedy decode over a well-separated argmax is
token-exact against tp = 1.
"""
from __future__ import annotations

from typing import Any, List, Optional, Sequence

import torch

from ..nn import activations
from ..nn.attention import apply_rope, sdpa
from ..ops import paged_attention as pa
from ..ops.quant_matmul import Int8Weight, qmatmul
from ..parallel.tensor_parallel import _permute_qkv
from . import kv_pool
from .sp import default_devices

#: the leaves split over the shards: "columns" (last axis) or "rows"
_SPLIT = {"attn/qkv_kernel": "columns", "attn/qkv_bias": "columns",
          "attn/out_kernel": "rows", "fc/kernel": "columns",
          "fc/bias": "columns", "proj/kernel": "rows"}


def _spec_for(path: Sequence[str]) -> Optional[str]:
    """How one leaf of the JAX parameter tree splits: "columns", "rows" or
    None (replicated)."""
    name = "/".join(path)
    for suffix, spec in _SPLIT.items():
        if name.endswith(suffix):
            return spec
    return None


def all_reduce(parts: Sequence[torch.Tensor],
               device: torch.device) -> torch.Tensor:
    """The TP all-reduce: per-shard f32 partial sums brought to ``device``
    and added in shard order. Every collective of a TP step goes through
    here, two per layer."""
    total = parts[0].to(device)
    for p in parts[1:]:
        total = total + p.to(device)
    return total


class TPContext:
    """The shards' devices, their weight slices and the TP model adapter
    the engine steps. ``tracer`` (set by the engine) records one
    ``serve.allreduce`` span per dispatched program (``span``)."""

    def __init__(self, model, tp: int, *,
                 devices: Optional[Sequence[Any]] = None):
        tp = int(tp)
        if tp < 2:
            raise ValueError(f"TPContext needs tp >= 2, got {tp}")
        if devices is None:
            if model.device.type == "cuda" \
                    and tp > torch.cuda.device_count():
                raise ValueError(
                    f"tp={tp} needs {tp} devices but only "
                    f"{torch.cuda.device_count()} are visible; name them "
                    "with tp_devices (a card may hold several shards)")
            devices = default_devices(model.device, tp)
        else:
            devices = [torch.device(d) for d in devices]
        if len(devices) != tp:
            raise ValueError(f"tp={tp} needs {tp} devices, got "
                             f"{len(devices)}: {devices}")
        if model.num_heads % tp:
            raise ValueError(
                f"num_heads={model.num_heads} not divisible by tp={tp}")
        if model.num_kv_heads % tp:
            raise ValueError(
                f"num_kv_heads={model.num_kv_heads} not divisible by "
                f"tp={tp}: each shard must own whole KV heads")
        if devices[0].type == "cuda" and devices[0].index is None:
            devices[0] = torch.device("cuda", torch.cuda.current_device())
        if devices[0] != model.device:
            raise ValueError(f"the first shard's device {devices[0]} must "
                             f"be the model's, {model.device}: replicated "
                             "math runs there")
        self.tp = tp
        self.devices = devices
        self.tracer = None
        # two collectives per layer: attention out-projection + MLP proj
        self.n_allreduce = 2 * model.num_layers
        self.model = TPModel(model, self._shard_weights(model), devices)

    @torch.no_grad()
    def _shard_weights(self, model) -> List[List[dict]]:
        """weights[layer][shard]: the split leaves of each block, keyed by
        their tree path past ``h{i}/``, on the shard's device."""
        head_dim = model.d_model // model.num_heads
        out = [[{} for _ in self.devices] for _ in range(model.num_layers)]
        for path, leaf in model.jax_param_paths():
            spec = _spec_for(path)
            if spec is None:
                continue
            if isinstance(leaf, Int8Weight):
                raise ValueError("tensor-parallel serving needs float "
                                 "weights: int8 leaves do not split")
            w = leaf.detach()
            if path[-1] in ("qkv_kernel", "qkv_bias"):
                w = _permute_qkv(w, model.num_heads, model.num_kv_heads,
                                 head_dim, self.tp)
            axis = -1 if spec == "columns" else 0
            for s, (piece, dev) in enumerate(
                    zip(w.chunk(self.tp, dim=axis), self.devices)):
                # a copy, as the JAX package places a copy on each shard
                out[int(path[0][1:])][s]["/".join(path[1:])] = piece.clone(
                    memory_format=torch.contiguous_format).to(dev)
        return out

    def span(self):
        """The ``serve.allreduce`` span one dispatch records."""
        return self.tracer.span("serve.allreduce", tp=self.tp,
                                count=self.n_allreduce)


class _ShardInputs:
    """A step's tables, offsets and row lengths on each shard's device
    (copied once a step; a shard on the lead device reuses the tensors)."""

    def __init__(self, devices, tables, offsets, q_lens=None):
        self.tables = [tables.to(d) for d in devices]
        self.offsets = [offsets.to(d) for d in devices]
        self.q_lens = [None if q_lens is None else q_lens.to(d)
                       for d in devices]


class TPModel:
    """GPT2 adapter whose forwards take the per-shard pages (lists in shard
    order) in place of one pool's: the paged forwards, ``apply_cached``
    over per-shard caches, and the assembled-cache steps of the engine's
    standard path. Embeddings, norms and head are the base model's own."""

    def __init__(self, base, weights: List[List[dict]],
                 devices: Sequence[torch.device]):
        self.base = base
        self.devices = list(devices)
        self.blocks = [TPBlock(b, w, self.devices)
                       for b, w in zip(base.blocks, weights)]

    def _trunk(self, toks, offsets):
        base = self.base
        return base.wpe(base.wte(toks), offset=offsets)

    def apply_decode_paged(self, toks, pages_k, pages_v, block_tables,
                           offsets) -> torch.Tensor:
        """``GPT2.apply_decode_paged`` over the shards: (B, V) logits."""
        ins = _ShardInputs(self.devices, block_tables, offsets)
        x = self._trunk(toks[:, None], offsets)
        for i, blk in enumerate(self.blocks):
            x = blk.apply_paged(x, pages_k, pages_v, ins, layer=i)
        return self.base._head(x)[:, -1]

    def apply_paged(self, toks, pages_k, pages_v, block_tables, offsets,
                    q_lens, *, last_only: bool = False) -> torch.Tensor:
        """``GPT2.apply_paged`` over the shards."""
        ins = _ShardInputs(self.devices, block_tables, offsets, q_lens)
        x = self._trunk(toks, offsets)
        for i, blk in enumerate(self.blocks):
            x = blk.apply_paged(x, pages_k, pages_v, ins, layer=i)
        if last_only:
            idx = (q_lens.long() - 1).clamp_min(0)
            x = x[torch.arange(x.shape[0], device=x.device), idx][:, None]
            return self.base._head(x, rows=toks.numel())[:, 0]
        return self.base._head(x)

    def init_cache(self, batch: int, max_len: int):
        """caches[layer][shard]: zeroed per-shard KV caches."""
        return [blk.attn.init_cache(batch, max_len) for blk in self.blocks]

    def apply_cached(self, ids, caches, offset) -> torch.Tensor:
        """``GPT2.apply_cached`` over per-shard caches (updated in place):
        the new positions' f32 logits."""
        x = self._trunk(ids, offset)
        for blk, cache in zip(self.blocks, caches):
            x = blk.apply_cached(x, cache, offset)
        return self.base._head(x)

    def _assembled(self, pages_k, pages_v, tables, starts, toks, pad: int):
        """Each shard's contiguous caches gathered from its pages (the time
        axis padded by ``pad``) and the blocks run over them; returns the
        hidden state and caches[layer][shard], written at the step's
        positions."""
        cd = self.base.policy.compute_dtype
        kvs = []
        for pk, pv, dev in zip(pages_k, pages_v, self.devices):
            kf, vf = kv_pool.gather_kv(pk, pv, tables.to(dev), out_dtype=cd)
            if pad:
                kf = torch.nn.functional.pad(kf, (0, 0, 0, pad))
                vf = torch.nn.functional.pad(vf, (0, 0, 0, pad))
            kvs.append((kf, vf))
        x = self._trunk(toks, starts)
        caches = []
        for i, blk in enumerate(self.blocks):
            layer = [{"k": kf[i], "v": vf[i]} for kf, vf in kvs]
            x = blk.apply_cached(x, layer, starts)
            caches.append(layer)
        return x, caches

    def mixed_standard(self, toks, pages_k, pages_v, tables, starts, q_lens,
                       *, last_only: bool = True) -> torch.Tensor:
        """The engine's ragged mixed step on assembled per-shard caches
        (``InferenceEngine._mixed_standard``): logits of each row's last
        live position (every position without ``last_only``); each shard's
        new rows go back to its pages."""
        b, qw = toks.shape
        # the time axis padded by qw: a chunk ending at the assembly edge
        # writes past it (that tail is never scattered back)
        x, caches = self._assembled(pages_k, pages_v, tables, starts, toks,
                                    pad=qw)
        if last_only:
            rows = torch.arange(b, device=x.device)
            last = x[rows, (q_lens.long() - 1).clamp_min(0)]
            logits = self.base._head(last[:, None])[:, 0]
        else:
            logits = self.base._head(x)
        for s, (pk, pv, dev) in enumerate(zip(pages_k, pages_v,
                                              self.devices)):
            st = starts.to(dev)
            rows = torch.arange(b, device=dev)[:, None]
            pos = st.long()[:, None] + torch.arange(qw, device=dev)
            for pages, key in ((pk, "k"), (pv, "v")):
                kv_pool.scatter_chunk(
                    pages, tables.to(dev), st,
                    torch.stack([c[s][key][rows, :, pos] for c in caches]),
                    q_lens.to(dev))
        return logits

    def decode_standard(self, toks, pages_k, pages_v, tables,
                        offsets) -> torch.Tensor:
        """The engine's ragged pure-decode step on assembled per-shard
        caches (``InferenceEngine._decode_standard``)."""
        b = toks.shape[0]
        x, caches = self._assembled(pages_k, pages_v, tables, offsets,
                                    toks[:, None], pad=0)
        logits = self.base._head(x)[:, -1]
        for s, (pk, pv, dev) in enumerate(zip(pages_k, pages_v,
                                              self.devices)):
            off = offsets.to(dev)
            rows = torch.arange(b, device=dev)
            for pages, key in ((pk, "k"), (pv, "v")):
                kv_pool.scatter_token(
                    pages, tables.to(dev), off,
                    torch.stack([c[s][key][rows, :, off.long()]
                                 for c in caches]))
        return logits


class TPBlock:
    """GPTBlock adapter: replicated layer norms, head-split attention, and
    the column/row-split MLP with one all-reduce after the
    down-projection."""

    def __init__(self, base, weights: List[dict],
                 devices: Sequence[torch.device]):
        if getattr(base, "moe", None) is not None:
            raise ValueError("tensor-parallel serving does not support MoE "
                             "blocks (gate moe_experts off under tp>1)")
        self.base = base
        self.weights = weights
        self.devices = list(devices)
        self.attn = TPAttention(base.attn, weights, self.devices)

    def _mlp(self, x: torch.Tensor) -> torch.Tensor:
        """x + proj(gelu(fc(ln2(x)))), fc's columns and proj's rows split:
        each shard's split-K partial in f32, summed before the bias and
        the cast."""
        base = self.base
        p = base.fc.policy
        h = base.ln2(x)
        act = activations.get(base.fc.activation)
        parts = []
        for w, dev in zip(self.weights, self.devices):
            hs = qmatmul(p.cast_in(h.to(dev)), p.cast_param(w["fc/kernel"]))
            hs = p.cast_out(act(hs + w["fc/bias"].float()))
            parts.append(qmatmul(p.cast_in(hs),
                                 p.cast_param(w["proj/kernel"])))
        y = all_reduce(parts, x.device) + base.proj.bias.float()
        return x + p.cast_out(y)

    def apply_paged(self, x, pages_k, pages_v, ins: _ShardInputs, layer):
        h = self.attn.apply_paged(self.base.ln1(x), pages_k, pages_v, ins,
                                  layer=layer)
        return self._mlp(x + h)

    def apply_cached(self, x, caches, offset):
        h = self.attn.apply_cached(self.base.ln1(x), caches, offset)
        return self._mlp(x + h)


class TPAttention:
    """MultiHeadAttention adapter with local head counts (``hl = H/tp``
    query heads, ``kl = H_kv/tp`` KV heads a shard): the base module's cast
    chain operation for operation on each shard's slice, then the one
    all-reduce after the out-projection, before the replicated bias."""

    def __init__(self, base, weights: List[dict],
                 devices: Sequence[torch.device]):
        if getattr(base, "kv_cache_dtype", None):
            raise ValueError("tensor-parallel serving stores compute-dtype "
                             "pages; quantize the pool instead")
        tp = len(devices)
        self.base = base
        self.weights = weights
        self.devices = list(devices)
        self.hl = base.num_heads // tp
        self.kl = base.num_kv_heads // tp

    def _project_qkv(self, s: int, x: torch.Tensor):
        """Shard s: (B, S, D) -> q (B, S, hl, Dh), k and v (B, S, kl,
        Dh)."""
        base, w = self.base, self.weights[s]
        p = base.policy
        x = p.cast_in(x)
        qkv = qmatmul(x, p.cast_param(w["attn/qkv_kernel"])).to(x.dtype)
        if base.qkv_bias is not None:
            qkv = qkv + w["attn/qkv_bias"].to(x.dtype)
        b, sq, _ = x.shape
        dh, hl, kl = base.head_dim, self.hl, self.kl
        q = qkv[..., :hl * dh].reshape(b, sq, hl, dh)
        k = qkv[..., hl * dh:(hl + kl) * dh].reshape(b, sq, kl, dh)
        v = qkv[..., (hl + kl) * dh:].reshape(b, sq, kl, dh)
        return q, k, v

    def _project_out(self, parts, attn_dtype, lead) -> torch.Tensor:
        """The shards' f32 out-projection partials -> (B, S, D) in the io
        dtype: all-reduce, cast, replicated bias."""
        base = self.base
        y = all_reduce(parts, lead).to(attn_dtype)
        if base.out_bias is not None:
            y = y + base.out_bias.to(attn_dtype)
        return base.policy.cast_out(y)

    def _partial(self, s: int, attn: torch.Tensor, lead) -> torch.Tensor:
        """Shard s's (B, S, hl, Dh) attention -> its f32 partial of the
        out-projection, on the lead device."""
        y = attn.reshape(*attn.shape[:2], self.hl * self.base.head_dim)
        w = self.base.policy.cast_param(self.weights[s]["attn/out_kernel"])
        return qmatmul(y, w).to(lead)

    def init_cache(self, batch: int, max_len: int):
        """[shard]: a zeroed (k, v) cache of (batch, kl, max_len, Dh) in
        the compute dtype on each shard's device."""
        cd = self.base.policy.compute_dtype
        shape = (batch, self.kl, max_len, self.base.head_dim)
        return [{"k": torch.zeros(shape, dtype=cd, device=d),
                 "v": torch.zeros(shape, dtype=cd, device=d)}
                for d in self.devices]

    def apply_cached(self, x, caches, offset):
        """``MultiHeadAttention.apply_cached`` on each shard's heads and
        cache (updated in place)."""
        base = self.base
        lead = x.device
        parts, dtype = [], None
        for s, (dev, cache) in enumerate(zip(self.devices, caches)):
            off = offset.to(dev) if isinstance(offset, torch.Tensor) \
                else offset
            q, k_new, v_new = self._project_qkv(s, x.to(dev))
            if base.rope_theta:
                q, k_new = (apply_rope(t.transpose(1, 2), off,
                                       base.rope_theta).transpose(1, 2)
                            for t in (q, k_new))
            sq = x.shape[1]
            if isinstance(off, torch.Tensor) and off.ndim:
                pos = off.long()[:, None] + torch.arange(sq, device=dev)
                rows = torch.arange(x.shape[0], device=dev)[:, None]
                cache["k"][rows, :, pos] = k_new.to(cache["k"].dtype)
                cache["v"][rows, :, pos] = v_new.to(cache["v"].dtype)
            else:
                o = int(off)
                cache["k"][:, :, o:o + sq] = k_new.transpose(1, 2).to(
                    cache["k"].dtype)
                cache["v"][:, :, o:o + sq] = v_new.transpose(1, 2).to(
                    cache["v"].dtype)
            backend = base.backend if base.backend != "ring" else "xla"
            out = sdpa(q.transpose(1, 2), cache["k"], cache["v"],
                       causal=True, kv_offset=off, backend=backend)
            out = out.transpose(1, 2)
            dtype = out.dtype
            parts.append(self._partial(s, out, lead))
        return self._project_out(parts, dtype, lead)

    def apply_paged(self, x, pages_k, pages_v, ins: _ShardInputs,
                    layer: int = 0):
        """``MultiHeadAttention.apply_paged`` on each shard's heads and
        pages (written in place)."""
        base = self.base
        lead = x.device
        decode = ins.q_lens[0] is None
        if decode and x.shape[1] != 1:
            raise ValueError("apply_paged with Q > 1 requires q_lens")
        parts, dtype = [], None
        for s, (dev, pk, pv) in enumerate(zip(self.devices, pages_k,
                                              pages_v)):
            tables, off, ql = ins.tables[s], ins.offsets[s], ins.q_lens[s]
            q, k_new, v_new = self._project_qkv(s, x.to(dev))
            if base.rope_theta:
                q, k_new = (apply_rope(t.transpose(1, 2), off,
                                       base.rope_theta).transpose(1, 2)
                            for t in (q, k_new))
            if not isinstance(pk, pa.QuantPages):
                k_new, v_new = k_new.to(pk.dtype), v_new.to(pv.dtype)
            if decode:
                pa.scatter_kv_rows(pk, tables, off, k_new[:, 0], layer=layer)
                pa.scatter_kv_rows(pv, tables, off, v_new[:, 0], layer=layer)
                out = pa.paged_attention(q[:, 0].contiguous(), pk, pv,
                                         tables, kv_lens=off + 1,
                                         layer=layer)[:, None]
            else:
                pa.scatter_kv_chunk(pk, tables, off, k_new, ql, layer=layer)
                pa.scatter_kv_chunk(pv, tables, off, v_new, ql, layer=layer)
                out = pa.paged_attention(q.contiguous(), pk, pv, tables,
                                         kv_lens=off + ql, q_lens=ql,
                                         layer=layer)
            dtype = out.dtype
            parts.append(self._partial(s, out, lead))
        return self._project_out(parts, dtype, lead)

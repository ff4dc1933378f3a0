"""Sequence-parallel serving (``tnn_tpu.serving.sp``): one request's KV
blocks spread over several shards of the paged pool.

The pool's block axis is range-partitioned (``kv_pool.PagedKVPool(sp=)``):
shard s owns global block ids ``[s * N_l, (s + 1) * N_l)``, and a
sequence's table positions draw their blocks round-robin, so the aggregate
pool, and with it the longest servable context, is sp times one shard's.
The only sharded state is the pages. Each step hands every shard its LOCAL
block table (``step_build.shard_tables``: local ids where it owns the
block, -1 holes elsewhere); in every layer each shard scatters the new K/V
rows it owns, sweeps its own pages with the paged kernel's stats form
(``paged_attention(..., return_stats=True)``), and the partials merge into
the full-row softmax (``ops.softmax_merge.merge_shards``) before the
out-projection.

Placement: the JAX package runs its shards under ``shard_map`` over a
device mesh. The port has no mesh: ``SPContext.devices`` names one device
per shard, and a device may repeat. The default on CUDA is the first sp
cards; on the CPU it is sp copies of "cpu" (the counterpart of the JAX
suite's virtual CPU devices). Two shards on one card run every code path of
SP, its kernel included, but move no data between cards: they measure
neither NCCL nor peer bandwidth.

Exactness contract (the JAX package's): every matmul is replicated and
runs once, on the first shard's device (the model's), as at sp = 1. Only
the reassociated softmax differs, per-shard online softmax plus one merge
per layer, about an ulp in f32; greedy decode over a well-separated argmax
is token-exact against sp = 1.
"""
from __future__ import annotations

from typing import Any, List, Optional, Sequence

import torch

from ..nn.attention import apply_rope
from ..ops import paged_attention as pa
from ..ops.softmax_merge import merge_shards


def default_devices(model_device: torch.device, sp: int) -> List[Any]:
    """The first ``sp`` cards on CUDA, ``sp`` copies of the CPU else."""
    if model_device.type != "cuda":
        return [model_device] * sp
    count = torch.cuda.device_count()
    if sp > count:
        raise ValueError(f"sp={sp} needs {sp} devices but only {count} are "
                         "visible; name them with sp_devices (a card may "
                         "hold several shards)")
    return [torch.device("cuda", i) for i in range(sp)]


class SPContext:
    """The shards' devices and the SP model adapter the engine steps."""

    def __init__(self, model, sp: int, *,
                 devices: Optional[Sequence[Any]] = None):
        sp = int(sp)
        if sp < 2:
            raise ValueError(f"SPContext needs sp >= 2, got {sp}")
        devices = default_devices(model.device, sp) if devices is None \
            else [torch.device(d) for d in devices]
        if len(devices) != sp:
            raise ValueError(f"sp={sp} needs {sp} devices, got "
                             f"{len(devices)}: {devices}")
        if devices[0].type == "cuda" and devices[0].index is None:
            devices[0] = torch.device("cuda", torch.cuda.current_device())
        if devices[0] != model.device:
            raise ValueError(f"the first shard's device {devices[0]} must "
                             f"be the model's, {model.device}: replicated "
                             "math runs there")
        self.sp = sp
        self.devices = devices
        self.model = SPModel(model, devices)


class SPModel:
    """GPT2 adapter whose paged forwards take the per-shard pages and local
    tables (lists in shard order) in place of one pool's. Embeddings,
    norms, projections, MLP and head are the base model's own, on its
    device."""

    def __init__(self, base, devices: Sequence[torch.device]):
        self.base = base
        self.devices = list(devices)
        self.blocks = [SPBlock(b, self.devices) for b in base.blocks]

    def apply_decode_paged(self, toks, pages_k, pages_v, block_tables,
                           offsets) -> torch.Tensor:
        """``GPT2.apply_decode_paged`` over the shards: (B, V) logits."""
        base = self.base
        x = base.wpe(base.wte(toks[:, None]), offset=offsets)
        for i, blk in enumerate(self.blocks):
            x = blk.apply_paged(x, pages_k, pages_v, block_tables, offsets,
                                layer=i)
        return base._head(x)[:, -1]

    def apply_paged(self, toks, pages_k, pages_v, block_tables, offsets,
                    q_lens, *, last_only: bool = False) -> torch.Tensor:
        """``GPT2.apply_paged`` over the shards."""
        base = self.base
        x = base.wpe(base.wte(toks), offset=offsets)
        for i, blk in enumerate(self.blocks):
            x = blk.apply_paged(x, pages_k, pages_v, block_tables, offsets,
                                layer=i, q_lens=q_lens)
        if last_only:
            idx = (q_lens.long() - 1).clamp_min(0)
            x = x[torch.arange(x.shape[0], device=x.device), idx][:, None]
            return base._head(x, rows=toks.numel())[:, 0]
        return base._head(x)


class SPBlock:
    """GPTBlock adapter: everything replicated but the attention sweep."""

    def __init__(self, base, devices: Sequence[torch.device]):
        self.base = base
        self.attn = SPAttention(base.attn, devices)

    def apply_paged(self, x, pages_k, pages_v, block_tables, offsets, layer,
                    q_lens=None):
        base = self.base
        h = self.attn.apply_paged(base.ln1(x), pages_k, pages_v,
                                  block_tables, offsets, layer=layer,
                                  q_lens=q_lens)
        return base._mlp(x + h)[0]


class SPAttention:
    """MultiHeadAttention adapter for the per-shard page sweep: the
    projections run once on the lead device; each shard gets q and the
    new K/V rows (a no-op copy when it shares the lead's device), writes
    the rows its local table owns (-1 holes land in its scratch row),
    attends over its own pages with the stats form, and returns (out, m,
    l) to the lead device, where ``merge_shards`` combines them."""

    def __init__(self, base, devices: Sequence[torch.device]):
        self.base = base
        self.devices = list(devices)

    def apply_paged(self, x, pages_k, pages_v, block_tables, offsets,
                    layer: int = 0, q_lens=None):
        base = self.base
        if getattr(base, "kv_cache_dtype", None) == "int8":
            raise NotImplementedError(
                "paged decode with a model-level int8 KV cache is not "
                "served: quantize the pool instead (kv_dtype='int8')")
        if q_lens is None and x.shape[1] != 1:
            raise ValueError("apply_paged with Q > 1 requires q_lens")
        q, k_new, v_new = base._project_qkv(x)
        if base.rope_theta:
            q, k_new = (apply_rope(t.transpose(1, 2), offsets,
                                   base.rope_theta).transpose(1, 2)
                        for t in (q, k_new))
        if not isinstance(pages_k[0], pa.QuantPages):
            k_new = k_new.to(pages_k[0].dtype)
            v_new = v_new.to(pages_v[0].dtype)
        lead = x.device
        outs, ms, ls = [], [], []
        for dev, pk, pv, tables in zip(self.devices, pages_k, pages_v,
                                       block_tables):
            off = offsets.to(dev)
            if q_lens is None:
                k_s, v_s = k_new[:, 0].to(dev), v_new[:, 0].to(dev)
                pa.scatter_kv_rows(pk, tables, off, k_s, layer=layer)
                pa.scatter_kv_rows(pv, tables, off, v_s, layer=layer)
                out, m, l = pa.paged_attention(  # noqa: E741
                    q[:, 0].to(dev).contiguous(), pk, pv, tables,
                    kv_lens=off + 1, layer=layer, return_stats=True)
            else:
                ql = q_lens.to(dev)
                pa.scatter_kv_chunk(pk, tables, off, k_new.to(dev), ql,
                                    layer=layer)
                pa.scatter_kv_chunk(pv, tables, off, v_new.to(dev), ql,
                                    layer=layer)
                out, m, l = pa.paged_attention(  # noqa: E741
                    q.to(dev).contiguous(), pk, pv, tables,
                    kv_lens=off + ql, q_lens=ql, layer=layer,
                    return_stats=True)
            outs.append(out.to(lead))
            ms.append(m.to(lead))
            ls.append(l.to(lead))
        out = merge_shards(outs, ms, ls)
        return base._project_out(out[:, None] if q_lens is None else out)

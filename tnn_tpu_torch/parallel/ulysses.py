"""Ulysses (all-to-all) sequence parallelism
(``tnn_tpu.parallel.ulysses``).

One all-to-all re-shards q, k and v from sequence-sharded (B, H, S/sp, D)
to head-sharded (B, H/sp, S, D); each position then holds the whole
sequence for its heads and runs single-device attention; a second
all-to-all restores the sequence sharding. It needs num_heads % sp == 0
and num_kv_heads % sp == 0; the ring (``ring_attention``) has neither
limit.

The local attention is the flash kernels on a CUDA tensor: K4 forward and
K7 backward, or K5 + K6 where ``ops.flash_attention.use_fused_bwd`` says
split (Llama at S = 32,768); a build or launch failure is an error. On
the CPU it is the plain ``nn.attention.local_attention``, which bypasses
the ring context (``sdpa`` would route back here).

Across processes (``over``, the seq slice's ``mesh.Span``) each
all-to-all sends the pieces for another process's positions in one
``process_group.all_to_all``.
"""
from __future__ import annotations

import math
from typing import List, Optional, Sequence

import torch

from . import mesh as mesh_lib
from .mesh import Mesh
from .ring_attention import check_heads


def _local_full_attention(q, k, v, *, causal: bool, scale: float):
    if q.is_cuda:
        from ..ops.flash_attention import flash_attention

        return flash_attention(q, k, v, causal=causal, scale=scale)
    from ..nn.attention import local_attention

    return local_attention(q, k, v, causal=causal, scale=scale)


def ulysses_attention_local(qs: Sequence[torch.Tensor],
                            ks: Sequence[torch.Tensor],
                            vs: Sequence[torch.Tensor], *, causal: bool,
                            scale: float,
                            over: Optional[mesh_lib.Span] = None
                            ) -> List[torch.Tensor]:
    """Ulysses over one group of positions: (B, H, S/sp, D) shards in,
    the same shards of the output out (across processes, this process's
    run of ``over``'s positions)."""
    qh = mesh_lib.all_to_all(qs, 1, 2, over)
    kh = mesh_lib.all_to_all(ks, 1, 2, over)
    vh = mesh_lib.all_to_all(vs, 1, 2, over)
    oh = [_local_full_attention(q, k, v, causal=causal, scale=scale)
          for q, k, v in zip(qh, kh, vh)]
    return mesh_lib.all_to_all(oh, 2, 1, over)


def check_ulysses(heads: int, kv_heads: int, seq: int, sp: int) -> None:
    """The JAX function's three refusals."""
    if seq % sp:
        raise ValueError(f"seq len {seq} not divisible by sp size {sp}")
    if heads % sp:
        raise ValueError(
            f"num_heads {heads} not divisible by sp size {sp} — Ulysses "
            f"shards heads during attention; use ring_attention for this "
            f"layout")
    if kv_heads % sp:
        raise ValueError(
            f"kv heads {kv_heads} not divisible by sp size {sp} — use "
            f"ring_attention (GQA-aware) for this layout")


def ulysses_attention(q, k, v, mesh: Mesh, *, axis: str = "seq",
                      causal: bool = False, scale: Optional[float] = None,
                      batch_axis=None) -> torch.Tensor:
    """Attention over (B, H, S, D) tensors whose S is cut over ``axis``'s
    positions: the contract of ``ring_attention``, so the two schemes
    swap where num_heads % sp == 0."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    sp = mesh_lib.axis_size(mesh, axis)
    heads, seq = q.shape[1], q.shape[-2]
    if seq % sp or heads % sp:
        check_ulysses(heads, k.shape[1], seq, sp)
    check_heads(q, k, v)
    check_ulysses(heads, k.shape[1], seq, sp)

    def body(qs, ks, vs):
        return ulysses_attention_local(qs, ks, vs, causal=causal,
                                       scale=scale)

    return mesh_lib.seq_shard_map(body, mesh, axis, batch_axis)(q, k, v)

"""Ring attention: sequence (context) parallelism over the "seq" positions
(``tnn_tpu.parallel.ring_attention``).

Each position holds a slice of the sequence. K/V blocks travel round the
ring (``mesh.ring_hop``, ring - 1 hops; the last block is attended where
it lands) while each position folds its queries' attention against every
block into the online-softmax state of ``ops.softmax_merge``
(``block_update``, then ``finalize``). The blocks travel at H_kv heads and
are repeated to H only at compute (GQA). The causal mask uses global
positions: after r hops position idx holds the block of
``owner = (idx - r) % ring``.

Across processes (``over``, the seq slice's ``mesh.Span``) a process
holds a run of the ring's positions: each hop moves its last block to
the next process and takes the previous one's (``mesh.ring_hop``), the
same blocks meeting the same queries in the same order as in one
process.

Plain torch, as the JAX package's ring is jnp ops: a Python loop takes the
place of ``lax.scan``, and autograd carries the gradient back through the
hops. Each block's update runs under a checkpoint, so the backward
recomputes the block's logits instead of keeping them: a position keeps
O(S_local x D) a block, not O(S_local^2), the same values either way.
"""
from __future__ import annotations

import math
from typing import List, Optional, Sequence

import torch
import torch.utils.checkpoint

from ..ops import softmax_merge
from . import mesh as mesh_lib
from .mesh import Mesh


def _attend(q, k_blk, v_blk, m, l, acc, owner: int, idx: int,  # noqa: E741
            causal: bool, scale: float):
    """One block's update of (m, l, acc) for the queries of position
    ``idx`` against the block first held by ``owner``."""
    group = q.shape[1] // k_blk.shape[1]
    if group > 1:
        k_blk = k_blk.repeat_interleave(group, dim=1)
        v_blk = v_blk.repeat_interleave(group, dim=1)
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(),
                          k_blk.float()) * scale
    if causal:
        s = q.shape[-2]
        qpos = idx * s + torch.arange(s, device=q.device)[:, None]
        kpos = owner * s + torch.arange(s, device=q.device)[None, :]
        logits = torch.where(qpos >= kpos, logits, softmax_merge.NEG_INF)
    return softmax_merge.block_update(m, l, acc, logits, v_blk)


def ring_attention_local(qs: Sequence[torch.Tensor],
                         ks: Sequence[torch.Tensor],
                         vs: Sequence[torch.Tensor], *, causal: bool,
                         scale: float, over: Optional[mesh_lib.Span] = None
                         ) -> List[torch.Tensor]:
    """The ring over one group: ``qs[i]`` (B, H, S_local, D) and
    ``ks[i]`` / ``vs[i]`` (B, H_kv, S_local, D) are position i's shards,
    each on its device (across processes, this process's run of
    ``over``'s positions). Returns each position's output shard."""
    crosses = over is not None and over.crosses
    ring = len(over.owners) if crosses else len(qs)
    lo = over.lo if crosses else 0
    state = []
    for q in qs:
        b, h, s, d = q.shape
        state.append((
            torch.full((b, h, s, 1), softmax_merge.NEG_INF,
                       dtype=torch.float32, device=q.device),
            torch.zeros((b, h, s, 1), dtype=torch.float32, device=q.device),
            torch.zeros((b, h, s, d), dtype=torch.float32, device=q.device)))
    k_blk, v_blk = list(ks), list(vs)
    for r in range(ring):
        for i, q in enumerate(qs):
            owner = (lo + i - r) % ring
            state[i] = torch.utils.checkpoint.checkpoint(
                _attend, q, k_blk[i], v_blk[i], *state[i], owner, lo + i,
                causal, scale, use_reentrant=False)
        if r < ring - 1:
            k_blk = mesh_lib.ring_hop(k_blk, over)
            v_blk = mesh_lib.ring_hop(v_blk, over)
    return [softmax_merge.finalize(*st, q.dtype) for st, q in zip(state, qs)]


def check_heads(q, k, v) -> None:
    if q.shape[1] % k.shape[1] or v.shape[1] != k.shape[1]:
        raise ValueError(f"q has {q.shape[1]} heads but k/v have "
                         f"{k.shape[1]}/{v.shape[1]}; need H % H_kv == 0")


def ring_attention(q, k, v, mesh: Mesh, *, axis: str = "seq",
                   causal: bool = False, scale: Optional[float] = None,
                   batch_axis=None) -> torch.Tensor:
    """Attention over (B, H, S, D) tensors whose S is cut over ``axis``'s
    positions (the JAX function's contract on whole tensors): S must
    divide by the ring size. ``batch_axis`` (a name or a tuple, e.g.
    ("data", "fsdp")) also cuts B, each batch shard running its own ring.
    Returns the whole output on q's device."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    ring = mesh_lib.axis_size(mesh, axis)
    if q.shape[-2] % ring:
        raise ValueError(f"seq len {q.shape[-2]} not divisible by ring size "
                         f"{ring}")
    check_heads(q, k, v)

    def body(qs, ks, vs):
        return ring_attention_local(qs, ks, vs, causal=causal, scale=scale)

    return mesh_lib.seq_shard_map(body, mesh, axis, batch_axis)(q, k, v)

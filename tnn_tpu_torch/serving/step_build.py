"""Host-side batch packing (``tnn_tpu.serving.step_build``), without the
speculative-decoding drafts.

``pack_mixed`` puts decode-phase rows first (one committed token each), then
mid-prefill chunk rows, into a ragged (B, qw) batch whose width is the
power-of-two bucket of the widest chunk; ``pack_decode`` is the pure-decode
batch, one token per row, and names the program that runs it: "pdecode"
(the paged path), "fdecode" (the fused kernel, when every live row sits at
one offset: a lockstep batch) or "decode" (the assembled-cache standard
path). Padding rows point their tables at the pool's scratch block and
carry q_len 0. ``shard_tables`` turns a step's global tables into each
sequence-parallel shard's local ones.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Sequence

import numpy as np

from ..utils.bucketing import pow2_bucket


@dataclasses.dataclass
class PackedStep:
    """One step's host-side arrays."""
    tables: np.ndarray              # (B, nb) block tables, scratch-padded
    temps: np.ndarray               # (B,) sampling temperature per row
    topks: np.ndarray               # (B,) top-k per row
    topps: np.ndarray               # (B,) top-p per row


@dataclasses.dataclass
class MixedStep(PackedStep):
    """The ragged mixed prefill+decode batch."""
    toks: np.ndarray = None         # (B, qw) token matrix
    starts: np.ndarray = None       # (B,) first write position per row
    q_lens: np.ndarray = None       # (B,) live tokens per row


@dataclasses.dataclass
class DecodeStep(PackedStep):
    """The pure-decode batch: one committed token per row."""
    toks: np.ndarray = None         # (B,) this step's token per row
    offsets: np.ndarray = None      # (B,) kv length before this token
    lockstep: bool = False          # every row at one offset (fused path)
    program: str = ""               # "pdecode", "fdecode" or "decode"


def shard_tables(tables: np.ndarray, sp: int,
                 blocks_per_shard: int) -> np.ndarray:
    """GLOBAL block tables -> stacked per-shard LOCAL tables for sequence
    parallelism (``tnn_tpu.serving.step_build.shard_tables``).

    ``tables`` holds global block ids of any rank. Ownership comes from the
    id range: shard ``g // blocks_per_shard`` holds block ``g``. Returns
    (sp, *tables.shape) int32 where shard s's entry is the local row ``g %
    blocks_per_shard`` if shard s owns ``g``, else ``-1``: the paged kernel
    skips -1 blocks, the scatters send them to the shard's scratch row 0,
    and ``kv_pool.gather_kv`` zeros them before it sums the shards.
    """
    owner = tables // blocks_per_shard
    local = (tables % blocks_per_shard).astype(np.int32)
    shards = np.arange(sp, dtype=np.int32).reshape(
        (sp,) + (1,) * tables.ndim)
    return np.where(owner[None] == shards, local[None], np.int32(-1))


def _fill_row(step: PackedStep, i: int, req) -> None:
    step.tables[i, :len(req.block_table)] = req.block_table
    step.temps[i] = req.temperature
    step.topks[i] = req.top_k
    step.topps[i] = req.top_p


def _alloc_common(b: int, nb: int, scratch: int):
    return dict(tables=np.full((b, nb), scratch, np.int32),
                temps=np.zeros((b,), np.float32),
                topks=np.zeros((b,), np.int32),
                topps=np.zeros((b,), np.float32))


def pack_mixed(rows: Sequence[Any], n_dec: int, takes: Dict[int, int], *,
               b: int, nb: int, scratch: int) -> MixedStep:
    """Pack decode rows (the first ``n_dec`` of ``rows``, one token each)
    and prompt-chunk rows (the rest, ``takes[rid]`` tokens each)."""
    widest = max([takes[r.rid] for r in rows[n_dec:]] + [1])
    qw = pow2_bucket(widest)
    step = MixedStep(toks=np.zeros((b, qw), np.int32),
                     starts=np.zeros((b,), np.int32),
                     q_lens=np.zeros((b,), np.int32),
                     **_alloc_common(b, nb, scratch))
    for i, req in enumerate(rows):
        step.starts[i] = req.cache_len
        _fill_row(step, i, req)
        if i < n_dec:
            step.toks[i, 0] = req.next_token
            step.q_lens[i] = 1
        else:
            take = takes[req.rid]
            seq = req.resume_tokens
            step.toks[i, :take] = seq[req.cache_len:req.cache_len + take]
            step.q_lens[i] = take
    return step


def pack_decode(live: Sequence[Any], *, b: int, nb: int, scratch: int,
                paged: bool, fused_available: bool) -> DecodeStep:
    """Pack the pure-decode batch. Off the paged path, with the fused
    kernel available, a batch whose live rows share one offset is
    lockstep: its padded rows take that offset too, so the kernel's one
    position is uniform and their writes stay in the scratch block."""
    step = DecodeStep(toks=np.zeros((b,), np.int32),
                      offsets=np.zeros((b,), np.int32),
                      **_alloc_common(b, nb, scratch))
    for i, req in enumerate(live):
        step.toks[i] = req.next_token
        step.offsets[i] = req.cache_len
        _fill_row(step, i, req)
    step.lockstep = (not paged and fused_available
                     and len(set(step.offsets[:len(live)].tolist())) == 1)
    if step.lockstep:
        step.offsets[len(live):] = step.offsets[0]
    step.program = ("pdecode" if paged else "fdecode" if step.lockstep
                    else "decode")
    return step

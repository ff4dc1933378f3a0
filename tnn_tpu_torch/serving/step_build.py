"""Host-side batch packing (``tnn_tpu.serving.step_build``).

``pack_mixed`` puts decode-phase rows first (one committed token each, plus
any speculative draft), then mid-prefill chunk rows, into a ragged (B, qw)
batch whose width is the power-of-two bucket of the widest row. Host
drafts land in the token matrix here; device drafts (``spec_decode.
DeviceDraft``) are listed for the engine to splice on the device, so their
values never pass through the host. ``pack_decode`` is the pure-decode
batch, one token per row, and names the program that runs it: "pdecode"
(the paged path), "fdecode" (the fused kernel, when every live row sits at
one offset: a lockstep batch) or "decode" (the assembled-cache standard
path). Padding rows point their tables at the pool's scratch block and
carry q_len 0. Every packed step carries a (B,) f32 ``poison`` column,
zero, which the engine's fault plan sets to NaN on the rows it poisons and
every step program adds to its logits before the logit guard (as in the
JAX package). ``shard_tables`` turns a step's global tables into each
sequence-parallel shard's local ones. ``flat_inputs`` / ``split_inputs``
put a step's int32 and float32 arrays into one int32 buffer and back, so
a step's inputs reach the card in one copy.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Sequence, Tuple

import numpy as np
import torch

from ..utils.bucketing import pow2_bucket
from .spec_decode import DeviceDraft


@dataclasses.dataclass
class PackedStep:
    """One step's host-side arrays."""
    tables: np.ndarray              # (B, nb) block tables, scratch-padded
    temps: np.ndarray               # (B,) sampling temperature per row
    topks: np.ndarray               # (B,) top-k per row
    topps: np.ndarray               # (B,) top-p per row
    # (B,) f32 added to each row's logits before the logit guard: zero in
    # every packed step, NaN where a fault plan poisons a row
    poison: np.ndarray


@dataclasses.dataclass
class MixedStep(PackedStep):
    """The ragged mixed prefill+decode batch."""
    toks: np.ndarray = None         # (B, qw) token matrix
    starts: np.ndarray = None       # (B,) first write position per row
    q_lens: np.ndarray = None       # (B,) live tokens per row
    n_draft: np.ndarray = None      # (B,) drafted lookahead per decode row
    # (row index, DeviceDraft) pairs spliced in on the device
    dev_drafts: List[Tuple[int, Any]] = dataclasses.field(
        default_factory=list)


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


def flat_inputs(arrays: Sequence[np.ndarray]) -> np.ndarray:
    """int32 and float32 arrays back to back in one flat int32 array
    (floats by their bits)."""
    for a in arrays:
        if a.dtype not in (np.int32, np.float32):
            raise TypeError(f"step inputs are int32 or float32, got "
                            f"{a.dtype}")
    return np.concatenate([np.ascontiguousarray(a).view(np.int32).ravel()
                           for a in arrays])


def split_inputs(flat: torch.Tensor,
                 like: Sequence[np.ndarray]) -> List[torch.Tensor]:
    """Views of ``flat`` (what ``flat_inputs(like)`` made, on any device)
    with each array's shape and dtype."""
    out, at = [], 0
    for a in like:
        v = flat[at:at + a.size].view(a.shape)
        out.append(v.view(torch.float32) if a.dtype == np.float32 else v)
        at += a.size
    return out


def _fill_row(step: PackedStep, i: int, req) -> None:
    step.tables[i, :len(req.block_table)] = req.block_table
    step.temps[i] = req.temperature
    step.topks[i] = req.top_k
    step.topps[i] = req.top_p


def _alloc_common(b: int, nb: int, scratch: int):
    return dict(tables=np.full((b, nb), scratch, np.int32),
                temps=np.zeros((b,), np.float32),
                topks=np.zeros((b,), np.int32),
                topps=np.zeros((b,), np.float32),
                poison=np.zeros((b,), np.float32))


def pack_mixed(rows: Sequence[Any], n_dec: int, drafts: Dict[int, Any],
               takes: Dict[int, int], *, b: int, nb: int,
               scratch: int) -> MixedStep:
    """Pack decode rows (the first ``n_dec`` of ``rows``, one token each
    plus ``drafts[rid]`` when drafted) and prompt-chunk rows (the rest,
    ``takes[rid]`` tokens each)."""
    widest = max([takes[r.rid] for r in rows[n_dec:]]
                 + [1 + len(drafts.get(r.rid, ())) for r in rows[:n_dec]])
    qw = pow2_bucket(widest)
    step = MixedStep(toks=np.zeros((b, qw), np.int32),
                     starts=np.zeros((b,), np.int32),
                     q_lens=np.zeros((b,), np.int32),
                     n_draft=np.zeros((b,), np.int32),
                     **_alloc_common(b, nb, scratch))
    for i, req in enumerate(rows):
        step.starts[i] = req.cache_len
        _fill_row(step, i, req)
        if i < n_dec:
            d = drafts.get(req.rid, [])
            step.toks[i, 0] = req.next_token
            if isinstance(d, DeviceDraft):
                step.dev_drafts.append((i, d))
            elif d:
                step.toks[i, 1:1 + len(d)] = d
            step.q_lens[i] = 1 + len(d)
            step.n_draft[i] = len(d)
        else:
            take = takes[req.rid]
            seq = req.resume_tokens
            step.toks[i, :take] = seq[req.cache_len:req.cache_len + take]
            step.q_lens[i] = take
    return step


def pack_decode(live: Sequence[Any], *, b: int, nb: int, scratch: int,
                paged: bool, fused_available: bool,
                speculative: bool = False) -> DecodeStep:
    """Pack the pure-decode batch. Off the paged path, with the fused
    kernel available, a batch whose live rows share one offset is
    lockstep: its padded rows take that offset too, so the kernel's one
    position is uniform and their writes stay in the scratch block.
    ``speculative=True`` packs the overlapped engine's predicted step N+1:
    each offset assumes one more committed token, the token column stays
    zero (the program reads step N's sampled tokens on the device), and
    the batch is never lockstep."""
    step = DecodeStep(toks=np.zeros((b,), np.int32),
                      offsets=np.zeros((b,), np.int32),
                      **_alloc_common(b, nb, scratch))
    for i, req in enumerate(live):
        if not speculative:
            step.toks[i] = req.next_token
        step.offsets[i] = req.cache_len + (1 if speculative else 0)
        _fill_row(step, i, req)
    step.lockstep = (not paged and fused_available and not speculative
                     and len(set(step.offsets[:len(live)].tolist())) == 1)
    if step.lockstep:
        step.offsets[len(live):] = step.offsets[0]
    step.program = ("pdecode" if paged else "fdecode" if step.lockstep
                    else "decode")
    return step

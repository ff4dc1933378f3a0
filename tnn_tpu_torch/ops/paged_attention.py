"""Ragged paged attention over the KV pool, and its write half.

Port of ``tnn_tpu/ops/pallas/paged_attention.py``. The pool keeps each
request's KV cache in fixed-size pages

    pages_k, pages_v : (L, num_blocks, H_kv, block_size, head_dim)

and a per-request block table names its pages in logical order.

``paged_attention`` is the kernel wrapper. On CUDA tensors it launches one
of the hand-written CUDA kernels of ``csrc/paged_attention.cu`` on the
current stream, or raises: over bf16/f32 pages the one that replaces the
TPU kernel's ``_attn_kernel`` body (counted by ``paged_attention.launches``),
over int8 ``QuantPages`` the one that replaces ``_attn_kernel_int8``
(counted by ``paged_attention.int8_launches``). With ``return_stats`` the
same kernels also write each query row's online-softmax state (m, l),
which the TPU kernel emits with ``stats=True`` (K1s, counted by
``paged_attention.stats_launches`` and ``int8_stats_launches``; a call
is one launch, whatever its split-KV count).
``plan_paged_splits`` is the rule that splits each row's table over
blocks (split-KV), from host-known shapes only. On CPU
tensors it computes ``paged_attention_reference``, the plain PyTorch
version with the same signature and masking (gather the tables
contiguous, masked softmax; with stats, the unnormalized form of JAX's
stats reference).

INT8 PAGES: a ``QuantPages`` bundle holds the pages as int8 ``data`` and a
per-(position, head) f32 ``scale`` in the same layout with the head dim
collapsed to 1. The scatters quantize rows as they write them
(``quantize_kv_rows``); both readers dequantize K/V to f32 (the plain
version at its gather, the kernel as pages reach it), so with int8 pages q
is promoted and QK, the softmax and PV all run in f32.

``scatter_kv_rows`` / ``scatter_kv_chunk`` write the step's new K/V rows
into their pages in place (the JAX package returns updated arrays and
donates the old ones; here the pool tensors are mutated). Dead tokens and
``-1`` table holes land in the pool's scratch block 0.
"""
from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Optional

import torch

from . import runtime

_NEG_INF = -1e30
_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# The kernel's blocks (csrc/paged_attention.cu): a tile of up to 16 query
# rows (token t, head of the GQA group) of one row and kv head; the split
# rule counts blocks with it. Split-KV gives each split MIN_SPLIT_PAGES
# table entries (one staged set of 8 pages), unless that makes more than
# SPLIT_BLOCKS_PER_SM blocks per SM.
TILE_ROWS = 16
SPLIT_BLOCKS_PER_SM = 12
MIN_SPLIT_PAGES = 8


def plan_paged_splits(batch: int, q_width: int, heads: int, kv_heads: int,
                      table_width: int, sms: int = runtime.H100_SMS):
    """(splits, pages per split): how many blocks share each row's block
    table, from shapes the host knows (never ``kv_lens``, so the launch
    needs no sync). Split sp takes table entries [sp * pps, (sp + 1) *
    pps). Each split takes ``MIN_SPLIT_PAGES`` entries, one staged set,
    as long as the query tiles x kv heads x rows x splits stay within
    ``SPLIT_BLOCKS_PER_SM`` x ``sms`` blocks; then the split count is cut
    to the fewest slices of that length, so none is empty."""
    g = heads // kv_heads
    tiles = -(-q_width * g // TILE_ROWS) * kv_heads * batch
    if tiles == 0 or table_width <= MIN_SPLIT_PAGES:
        return 1, table_width
    splits = min(SPLIT_BLOCKS_PER_SM * sms // tiles,
                 -(-table_width // MIN_SPLIT_PAGES), 65535 // batch)
    splits = max(splits, 1)
    pps = -(-table_width // splits)
    return -(-table_width // pps), pps


class QuantPages(NamedTuple):
    """Int8 KV pages and their per-(position, head) f32 scale: ``scale[l,
    n, h, s, 0]`` dequantizes row ``data[l, n, h, s, :]``. The two share
    one block-id space, so the pool's bookkeeping needs no second ledger."""
    data: torch.Tensor    # (L, N, H_kv, bs, Dh) int8
    scale: torch.Tensor   # (L, N, H_kv, bs, 1) float32


def quantize_kv_rows(x: torch.Tensor):
    """Symmetric per-row int8 over the last axis: scale = max(amax, 1e-8) /
    127, q = round-half-even(x / scale) clipped to +-127. Returns (int8
    values, f32 scales with the last axis 1)."""
    xf = x.float()
    scale = xf.abs().amax(dim=-1, keepdim=True).clamp_min(1e-8) / 127.0
    q = torch.round(xf / scale).clamp(-127, 127).to(torch.int8)
    return q, scale


def _pages_shape(pages):
    return tuple((pages.data if isinstance(pages, QuantPages)
                  else pages).shape)


def _check_args(q, pages_k, pages_v, block_tables, kv_lens, q_lens, scale):
    quant = isinstance(pages_k, QuantPages)
    if quant != isinstance(pages_v, QuantPages):
        raise ValueError("pages_k / pages_v must both be QuantPages or "
                         "both plain tensors")
    if quant:
        if pages_k.data.ndim == 4:   # single-layer: add the unit layer axis
            pages_k = QuantPages(pages_k.data[None], pages_k.scale[None])
            pages_v = QuantPages(pages_v.data[None], pages_v.scale[None])
        for p in (pages_k, pages_v):
            want = tuple(p.data.shape[:-1]) + (1,)
            if tuple(p.scale.shape) != want:
                raise ValueError(f"QuantPages scale {tuple(p.scale.shape)} "
                                 f"must be pages {tuple(p.data.shape)} with "
                                 "the last axis collapsed to 1")
    elif pages_k.ndim == 4:   # single-layer pages: add the unit layer axis
        pages_k, pages_v = pages_k[None], pages_v[None]
    pk_shape, pv_shape = _pages_shape(pages_k), _pages_shape(pages_v)
    if pk_shape != pv_shape or len(pk_shape) != 5:
        raise ValueError(f"pages must both be (L, N, H_kv, bs, Dh); got "
                         f"{pk_shape} / {pv_shape}")
    was_3d = q.ndim == 3
    if was_3d:
        if q_lens is not None:
            raise ValueError("q_lens requires multi-token q (B, Q, H, Dh); "
                             f"got q {tuple(q.shape)}")
        q = q[:, None]
    if q.ndim != 4:
        raise ValueError(f"q must be (B, H, Dh) or (B, Q, H, Dh); "
                         f"got {tuple(q.shape)}")
    b, qw, h, dh = q.shape
    hkv = pk_shape[2]
    if h % hkv or pk_shape[4] != dh:
        raise ValueError(f"q has {h} heads / Dh {dh} but pages carry "
                         f"{hkv} kv heads / Dh {pk_shape[4]}; "
                         "need H % H_kv == 0 and equal head dims")
    if block_tables.shape[0] != b or tuple(kv_lens.shape) != (b,):
        raise ValueError(f"block_tables {tuple(block_tables.shape)} / kv_lens "
                         f"{tuple(kv_lens.shape)} do not match batch {b}")
    if q_lens is not None and tuple(q_lens.shape) != (b,):
        raise ValueError(f"q_lens {tuple(q_lens.shape)} does not match "
                         f"batch {b}")
    if scale is None:
        scale = 1.0 / math.sqrt(dh)
    return q, was_3d, q_lens, pages_k, pages_v, scale


def _attention_reference(q, pages_k, pages_v, block_tables, kv_lens, q_lens,
                         layer, scale, stats=False):
    b, qw, h, dh = q.shape
    _, _, hkv, bs, _ = _pages_shape(pages_k)
    g = h // hkv
    t = block_tables.shape[1] * bs
    tbl = block_tables.long().clamp_min(0)   # clamp -1 holes for the gather

    def gather(pages):
        if isinstance(pages, QuantPages):    # dequantize AT the gather, f32
            x = pages.data[layer][tbl].float() * pages.scale[layer][tbl]
        else:
            x = pages[layer][tbl]                # (B, nb, Hkv, bs, Dh)
        return x.transpose(1, 2).reshape(b, hkv, t, dh)

    k, v = gather(pages_k), gather(pages_v)
    qg = q.reshape(b, qw, hkv, g, dh)
    s = torch.einsum("bqhgd,bhtd->bqhgt", qg.float(), k.float()) * scale
    kv_lens = kv_lens.long()
    q_lens = torch.full_like(kv_lens, qw) if q_lens is None \
        else q_lens.long()
    start = (kv_lens - q_lens)[:, None]                    # (B, 1)
    tpos = torch.arange(qw, device=q.device)[None, :]      # (1, Q)
    kpos = torch.arange(t, device=q.device)
    live = (kpos[None, None, :] <= (start + tpos)[:, :, None]) \
        & (tpos < q_lens[:, None])[:, :, None]             # (B, Q, T)
    live = live & torch.repeat_interleave(block_tables >= 0, bs,
                                          dim=1)[:, None, :]
    s = torch.where(live[:, :, None, None, :], s, _NEG_INF)
    if stats:
        # the unnormalized form of JAX's _paged_attention_xla_mq(stats=
        # True): the row max over the masked scores, p = exp(s - m) on live
        # positions, l = sum(p); a row with no live key keeps m = -1e30,
        # l = 0 and outputs 0
        m = s.amax(dim=-1, keepdim=True)                   # (B,Q,Hkv,G,1)
        p = torch.where(live[:, :, None, None, :], torch.exp(s - m), 0.0)
        l = p.sum(dim=-1, keepdim=True)  # noqa: E741
        out = torch.einsum("bqhgt,bhtd->bqhgd", p.to(v.dtype).float(),
                           v.float())
        out = out / torch.where(l == 0, 1.0, l)
        return (out.to(q.dtype).reshape(b, qw, h, dh),
                m.reshape(b, qw, h, 1), l.reshape(b, qw, h, 1))
    p = torch.softmax(s, dim=-1)
    # fully-masked query rows (padding past q_lens, or q_lens/kv_lens == 0)
    # output exactly 0, matching the kernel's l == 0 guard
    row_live = (tpos < q_lens[:, None]) & (start + tpos >= 0) \
        & live.any(dim=-1)                                 # (B, Q)
    p = torch.where(row_live[:, :, None, None, None], p, 0.0)
    out = torch.einsum("bqhgt,bhtd->bqhgd", p.to(v.dtype).float(), v.float())
    return out.to(q.dtype).reshape(b, qw, h, dh)


def _decode_form(result, was_3d):
    """Drop the unit query axis of the decode form from out (and m, l)."""
    if not was_3d:
        return result
    if isinstance(result, tuple):
        return tuple(x[:, 0] for x in result)
    return result[:, 0]


def paged_attention_reference(q, pages_k, pages_v, block_tables, kv_lens, *,
                              q_lens=None, layer: int = 0,
                              scale: Optional[float] = None,
                              return_stats: bool = False):
    """Plain PyTorch paged attention: the kernel's parity oracle.

    Same signature and semantics as ``paged_attention``. It gathers every
    table entry into a contiguous cache, which is what the kernel exists to
    avoid.
    """
    q, was_3d, q_lens, pages_k, pages_v, scale = _check_args(
        q, pages_k, pages_v, block_tables, kv_lens, q_lens, scale)
    return _decode_form(_attention_reference(
        q, pages_k, pages_v, block_tables, kv_lens, q_lens, layer, scale,
        return_stats), was_3d)


def paged_attention(q, pages_k, pages_v, block_tables, kv_lens, *,
                    q_lens=None, layer: int = 0,
                    scale: Optional[float] = None,
                    return_stats: bool = False):
    """Ragged attention for the current step's query rows over paged KV.

    q : (B, H, Dh) decode form, one token per row, or (B, Q, H, Dh) ragged
        chunks with ``q_lens[b]`` live tokens per row (left-aligned; the
        rest is padding and outputs exactly 0).
    pages_k / pages_v : (L, N, H_kv, bs, Dh) pool pages, or one layer's
        (N, H_kv, bs, Dh).
    block_tables : (B, nb) int32 page ids in logical order; -1 entries are
        holes whose positions are skipped.
    kv_lens : (B,) int32 live KV positions per row, including this step's
        rows (the caller scatters them first). A 0 row outputs exactly 0.
    q_lens : (B,) int32 live query tokens per row (4-D q only). Token t of
        row b sits at position ``kv_lens[b] - q_lens[b] + t`` and attends
        causally.
    layer : which layer's pages to read.
    return_stats : also return each query row's online-softmax state, f32
        and shaped like the output with the head dim collapsed to 1: ``m``,
        the max of its scaled, masked scores, and ``l``, the normalizer at
        that max. A row with no live key (kv_len 0, a padding token, all
        its blocks -1 holes) gives exactly (0, -1e30, 0). This is what a
        sequence-parallel shard hands ``ops.softmax_merge.merge_shards``.

    GQA: H % H_kv == 0. Returns q's shape and dtype, or ``(out, m, l)``.
    On CUDA tensors the kernels take bf16 or f32 q, pages of q's dtype or
    ``QuantPages``, Dh 64 or 128 and block sizes 4 to 32 (a multiple of 4
    for int8), all contiguous, and raise on anything else.
    """
    q, was_3d, q_lens, pages_k, pages_v, scale = _check_args(
        q, pages_k, pages_v, block_tables, kv_lens, q_lens, scale)
    if q.device.type == "cpu":
        result = _attention_reference(q, pages_k, pages_v, block_tables,
                                      kv_lens, q_lens, layer, scale,
                                      return_stats)
    else:
        result = _launch(q, pages_k, pages_v, block_tables, kv_lens, q_lens,
                         layer, scale, return_stats)
    return _decode_form(result, was_3d)


paged_attention.launches = 0         # bf16 / f32 pages (K1)
paged_attention.int8_launches = 0    # QuantPages (K2)
# the same kernels with return_stats (K1s): counted apart by page type
paged_attention.stats_launches = 0
paged_attention.int8_stats_launches = 0


def _launch(q, pages_k, pages_v, block_tables, kv_lens, q_lens, layer, scale,
            stats=False):
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention kernel needs CUDA tensors; q is "
                         f"on {q.device}")
    quant = isinstance(pages_k, QuantPages)
    # q_lens None (every row QW tokens) goes to the kernel as a null pointer
    tensors = {"q": q, "block_tables": block_tables, "kv_lens": kv_lens}
    if q_lens is not None:
        tensors["q_lens"] = q_lens
    if quant:
        tensors.update(data_k=pages_k.data, scale_k=pages_k.scale,
                       data_v=pages_v.data, scale_v=pages_v.scale)
    else:
        tensors.update(pages_k=pages_k, pages_v=pages_v)
    for name, x in tensors.items():
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name in ("block_tables", "kv_lens", "q_lens"):
        if name in tensors and tensors[name].dtype != torch.int32:
            raise ValueError(f"{name} must be int32, got "
                             f"{tensors[name].dtype}")
    if q.dtype not in _KERNEL_DTYPES:
        raise ValueError(f"kernel takes bf16 or f32 q, got {q.dtype}")
    if quant:
        if any(t.dtype != torch.int8 for t in (pages_k.data, pages_v.data)) \
                or any(t.dtype != torch.float32
                       for t in (pages_k.scale, pages_v.scale)):
            raise ValueError("QuantPages must hold int8 data and f32 scales")
    elif pages_k.dtype != q.dtype or pages_v.dtype != q.dtype:
        raise ValueError(f"kernel takes pages of q's dtype; got q {q.dtype}, "
                         f"pages {pages_k.dtype} / {pages_v.dtype}")
    b, qw, h, dh = q.shape
    nl, n, hkv, bs, _ = _pages_shape(pages_k)
    if dh not in (64, 128):
        raise ValueError(f"kernel supports head_dim 64 or 128, got {dh}")
    if not 4 <= bs <= 32 or (quant and bs % 4):
        raise ValueError(f"kernel supports block sizes 4..32 (multiples of "
                         f"4 over int8 pages), got {bs}")
    if not 0 <= int(layer) < nl:
        raise ValueError(f"layer {layer} out of range for {nl} layers")
    out = torch.empty_like(q)
    nb = block_tables.shape[1]
    splits, _ = plan_paged_splits(b, qw, h, hkv, nb,
                                  runtime.sm_count(q.device))
    lib = _library()
    ws = counters = None
    if splits > 1:   # the partials, and one counter per (tile, kv head, row)
        ws = torch.empty((b, splits, qw * h, dh + 2), dtype=torch.float32,
                         device=q.device)
        counters = runtime.zeroed_counters(
            "paged_attention", q.device,
            lib.tnn_paged_attention_counters(b, qw, h, hkv))
    m_ptr = l_ptr = None          # null: the kernel writes no stats
    if stats:
        m = torch.empty((b, qw, h, 1), dtype=torch.float32, device=q.device)
        l = torch.empty_like(m)  # noqa: E741
        m_ptr, l_ptr = m.data_ptr(), l.data_ptr()
    common = (block_tables.data_ptr(), kv_lens.data_ptr(),
              None if q_lens is None else q_lens.data_ptr(),
              out.data_ptr(), m_ptr, l_ptr, _KERNEL_DTYPES[q.dtype], b, qw,
              h, hkv, dh, n, bs, nb, int(layer), float(scale), splits,
              None if ws is None else ws.data_ptr(),
              None if counters is None else counters.data_ptr(),
              torch.cuda.current_stream(q.device).cuda_stream)
    if quant:
        err = lib.tnn_paged_attention_int8(
            q.data_ptr(), pages_k.data.data_ptr(), pages_v.data.data_ptr(),
            pages_k.scale.data_ptr(), pages_v.scale.data_ptr(), *common)
    else:
        err = lib.tnn_paged_attention(
            q.data_ptr(), pages_k.data_ptr(), pages_v.data_ptr(), *common)
    if err != 0:
        raise RuntimeError(f"paged_attention kernel launch failed: CUDA "
                           f"error {err}")
    counter = ("int8_" if quant else "") + ("stats_" if stats else "") \
        + "launches"
    runtime.count_launch(paged_attention, counter)
    return (out, m, l) if stats else out


def _library():
    lib = runtime.load("paged_attention")
    ptr, i = ctypes.c_void_p, ctypes.c_int
    for fn, pages in ((lib.tnn_paged_attention, 2),
                      (lib.tnn_paged_attention_int8, 4)):
        if fn.argtypes is None:
            fn.argtypes = [ptr] * (7 + pages) + [i] * 10 + [
                ctypes.c_float, i, ptr, ptr, ptr]
            fn.restype = ctypes.c_int
    fn = lib.tnn_paged_attention_counters
    if fn.argtypes is None:
        fn.argtypes = [i] * 4
        fn.restype = ctypes.c_longlong
    return lib


def _last_writers(dest: torch.Tensor) -> torch.Tensor:
    """For each write of a flat list of destinations (in row-major order),
    the index of the LAST write to the same destination. Writing every
    duplicate with that row leaves what a sequential scatter leaves (the
    CPU's, and the JAX package's on the CPU), whatever order the card runs
    the writes in."""
    order = torch.argsort(dest, stable=True)
    sorted_dest = dest[order]
    last = torch.searchsorted(sorted_dest, sorted_dest, side="right") - 1
    win = torch.empty_like(order)
    win[order] = order[last]
    return win


def _scatter(pages, layer, blk, slot, rows, last_writer):
    """``pages[layer][blk, :, slot] = rows`` over flat (n,) destinations
    and (n, H, last) rows; with ``last_writer`` duplicates take their last
    writer's row. Under ``QuantPages`` the rows are quantized and the codes
    and scales written through the same indices."""
    if last_writer:
        win = _last_writers(blk * _pages_shape(pages)[-2] + slot)
        rows = rows[win]
    if isinstance(pages, QuantPages):
        qrows, srows = quantize_kv_rows(rows)
        _layer_view(pages.data, layer)[blk, :, slot, :] = qrows
        _layer_view(pages.scale, layer)[blk, :, slot, :] = srows
    else:
        _layer_view(pages, layer)[blk, :, slot, :] = rows
    return pages


def scatter_kv_rows(pages, block_tables, offsets, rows, *, layer=None,
                    last_writer: bool = False):
    """Write one new KV row per sequence at its decode position, in place.

    ``pages`` is (L, N, H, bs, Dh) with ``layer`` naming the layer (or one
    layer's (N, H, bs, Dh)); ``block_tables`` (B, nb); ``offsets`` (B,) the
    position each row writes; ``rows`` (B, H, Dh). A -1 table hole writes
    to the scratch page. Padding rows all write one slot of the scratch
    page; on the card which of them lands is not defined, and with
    ``last_writer`` it is the last such row, as on the CPU (a model whose
    rows interact, MoE, reads it back: its capacity tells identical
    padding rows apart). ``QuantPages`` quantize the rows here and write
    the int8 values and their scales through the same indices. Returns
    ``pages``.
    """
    bs = _pages_shape(pages)[-2]
    offsets = offsets.long()
    blk = block_tables.long().gather(1, (offsets // bs)[:, None])[:, 0]
    return _scatter(pages, layer, blk.clamp_min(0), offsets % bs, rows,
                    last_writer)


def scatter_kv_chunk(pages, block_tables, starts, rows, q_lens, *,
                     layer=None, last_writer: bool = False):
    """Write a ragged chunk of new KV rows per sequence, in place.

    ``rows`` is (B, Q, H, Dh): row b's tokens t < q_lens[b] land at
    positions ``starts[b] + t`` through its block table; padding tokens
    (and whole rows with q_lens == 0) and -1 holes go to the scratch page
    0, which is never allocated to a request. ``last_writer`` and
    ``QuantPages`` as for ``scatter_kv_rows`` (row-major order). Returns
    ``pages``.
    """
    bs = _pages_shape(pages)[-2]
    qw = rows.shape[1]
    nbt = block_tables.shape[1]
    steps = torch.arange(qw, device=rows.device)
    pos = starts.long()[:, None] + steps                 # (B, Q)
    live = steps[None, :] < q_lens.long()[:, None]       # (B, Q)
    blk = block_tables.long().gather(1, (pos // bs).clamp(0, nbt - 1))
    blk = torch.where(live, blk, 0).clamp_min(0)
    return _scatter(pages, layer, blk.reshape(-1), (pos % bs).reshape(-1),
                    rows.reshape(-1, *rows.shape[2:]), last_writer)


def _layer_view(pages, layer):
    if pages.ndim == 5:
        if layer is None:
            raise ValueError("layer is required for (L, N, H, bs, Dh) pages")
        return pages[layer]
    return pages

"""Block-based paged KV pool (``tnn_tpu.serving.kv_pool``).

The pool owns two device tensors of fixed-size token pages,

    pages_k, pages_v : (L, num_blocks, H_kv, block_size, head_dim)

plus host-side bookkeeping: a LIFO free list and a per-block refcount.
Sequences hold a block table, the ordered list of their block ids; position
``p`` lives at ``pages[layer, table[p // block_size], :, p % block_size]``.
Block 0 is reserved scratch: padded rows of a batch point their tables at
it, so their writes land somewhere harmless. The model writes new rows into
the pages in place (``ops.paged_attention.scatter_kv_*``), where the JAX
package donated the old arrays to each step.

With ``kv_dtype="int8"`` each ``pages_*`` is a ``QuantPages`` bundle: int8
``data`` in the layout above and a per-(position, head) f32 ``scale`` of
shape ``(L, N, H_kv, bs, 1)``. Rows are quantized as they are scattered and
dequantized where attention reads them; the block-table bookkeeping never
looks inside the bundle. ``kv_dtype="f32"`` (the JAX name) keeps pages in
``dtype``, the model's compute dtype.

SEQUENCE PARALLELISM (``sp > 1``): the block axis is range-partitioned
over ``sp`` shards. Shard s owns global ids ``[s * N_l, (s + 1) * N_l)``
(``N_l = blocks_per_shard``), its local row 0 is its scratch page, and
``pages_k`` / ``pages_v`` are lists with one contiguous ``(L, N_l, H_kv,
bs, Dh)`` tensor (or ``QuantPages``) per shard, on that shard's device
(``devices``; one card may hold several shards). ``alloc(n, start=)``
draws table position j's block from shard ``j % sp``; ``num_allocatable``
is the bottleneck shard's. A step hands each shard its LOCAL table
(``step_build.shard_tables``: local ids where it owns the block, -1
holes elsewhere). At sp = 1 the pool holds one tensor per side, as before.

The module's step-side helpers serve the assembled-cache ("standard" and
"fused") decode paths: ``gather_kv`` builds each row's contiguous cache
from its block table, and ``scatter_token`` / ``scatter_chunk`` write one
step's new rows back for all layers at once. Each takes one shard's pages
and table, or under SP the lists of per-shard pages and local tables.

The prefix-cache parts of the JAX pool (fork, the evictable LRU, the demote
hooks) are not ported yet.
"""
from __future__ import annotations

import math
from collections import Counter
from typing import Dict, Iterable, List, Optional, Sequence

import torch

from ..ops.paged_attention import QuantPages, quantize_kv_rows


class PoolExhausted(RuntimeError):
    """No free blocks: the scheduler preempts and retries."""


class PagedKVPool:
    SCRATCH = 0  # reserved block for padded/inactive batch rows

    def __init__(self, num_layers: int, num_kv_heads: int, head_dim: int,
                 num_blocks: int, block_size: int = 16,
                 dtype: torch.dtype = torch.float32, device="cuda", *,
                 kv_dtype: str = "f32", sp: int = 1,
                 devices: Optional[Sequence] = None):
        if num_blocks < 2:
            raise ValueError("need >= 2 blocks (block 0 is reserved scratch)")
        if block_size < 1:
            raise ValueError(f"block_size must be >= 1, got {block_size}")
        if kv_dtype not in ("f32", "int8"):
            raise ValueError(f"kv_dtype must be 'f32' or 'int8', "
                             f"got {kv_dtype!r}")
        if sp < 1:
            raise ValueError(f"sp must be >= 1, got {sp}")
        if num_blocks % sp:
            raise ValueError(f"num_blocks {num_blocks} must divide evenly "
                             f"over sp {sp} shards")
        if sp > 1 and num_blocks // sp < 2:
            raise ValueError(f"num_blocks {num_blocks} leaves < 2 blocks "
                             f"per shard at sp {sp} (each shard reserves "
                             "one scratch block)")
        self.num_layers = int(num_layers)
        self.num_kv_heads = int(num_kv_heads)
        self.head_dim = int(head_dim)
        self.num_blocks = int(num_blocks)
        self.block_size = int(block_size)
        self.dtype = dtype
        self.kv_dtype = kv_dtype
        # sequence parallelism: shard s owns the GLOBAL block ids [s * N_l,
        # (s + 1) * N_l), N_l = num_blocks // sp, and its local row 0
        # (global id s * N_l) is its scratch page. The bookkeeping stays
        # global; only where alloc draws a block from, and the per-shard
        # capacity, know about shards.
        self.sp = int(sp)
        self.blocks_per_shard = self.num_blocks // self.sp
        self._scratch = frozenset(s * self.blocks_per_shard
                                  for s in range(self.sp))
        devices = list(devices) if devices is not None \
            else [device] * self.sp
        if len(devices) != self.sp:
            raise ValueError(f"{len(devices)} devices for sp {sp}")
        shape = (self.num_layers, self.blocks_per_shard, self.num_kv_heads,
                 self.block_size, self.head_dim)

        def fresh(dev):
            if kv_dtype == "int8":
                return QuantPages(
                    torch.zeros(shape, dtype=torch.int8, device=dev),
                    torch.zeros(shape[:-1] + (1,), dtype=torch.float32,
                                device=dev))
            return torch.zeros(shape, dtype=dtype, device=dev)

        # one contiguous page tensor (or bundle) per shard, on its device;
        # at sp = 1 the pool holds the tensors themselves
        pk = [fresh(d) for d in devices]
        pv = [fresh(d) for d in devices]
        self.devices = [(p.data if kv_dtype == "int8" else p).device
                        for p in pk]
        self.pages_k, self.pages_v = (pk, pv) if self.sp > 1 \
            else (pk[0], pv[0])
        # LIFO free list: freshly freed blocks are reused first; scratch
        # blocks never enter it
        self._free: List[int] = [b for b in range(self.num_blocks - 1, -1, -1)
                                 if b not in self._scratch]
        self._ref: Dict[int, int] = {}

    # -- bookkeeping ----------------------------------------------------------

    @property
    def capacity(self) -> int:
        """Allocatable blocks: all but one scratch block per shard."""
        return self.num_blocks - self.sp

    @property
    def num_allocatable(self) -> int:
        """Blocks an alloc can take now. Under sequence parallelism table
        position j's block must come from shard ``j % sp``, so the
        BOTTLENECK shard gates it: ``sp * min_s(free_s)``, the longest run
        of table positions allocatable from any start. The scheduler reads
        only this, so admission follows the scarcest shard."""
        if self.sp == 1:
            return len(self._free)
        return self.sp * min(self._shard_free(s) for s in range(self.sp))

    @property
    def num_allocated(self) -> int:
        return self.capacity - len(self._free)

    @property
    def page_itemsize(self) -> int:
        """Bytes per stored KV element in the page arrays (1 under int8)."""
        if self.kv_dtype == "int8":
            return 1
        return torch.empty((), dtype=self.dtype).element_size()

    @property
    def kv_bytes_per_token(self) -> int:
        """Page-array bytes one resident token costs (K + V, all layers),
        without the int8 scales (``kv_scale_bytes_per_token``), which do
        not shrink with the page dtype."""
        return 2 * self.num_layers * self.num_kv_heads * self.head_dim \
            * self.page_itemsize

    @property
    def kv_scale_bytes_per_token(self) -> int:
        """Scale bytes per token: one f32 per (position, head) for K and V
        each under int8; zero otherwise."""
        if self.kv_dtype != "int8":
            return 0
        return 2 * self.num_layers * self.num_kv_heads * 4

    def blocks_for(self, num_tokens: int) -> int:
        """Blocks needed to hold ``num_tokens`` cache positions."""
        return max(1, math.ceil(num_tokens / self.block_size))

    def owner(self, block: int) -> int:
        """The sequence-parallel shard a global block id lives on."""
        return block // self.blocks_per_shard

    def shard_pages(self):
        """[(pages_k, pages_v)] of each shard, in shard order."""
        if self.sp == 1:
            return [(self.pages_k, self.pages_v)]
        return list(zip(self.pages_k, self.pages_v))

    def _shard_free(self, shard: int) -> int:
        return sum(1 for b in self._free if self.owner(b) == shard)

    def _shard_need(self, n: int, start: int) -> List[int]:
        """Blocks each shard gives ``n`` table positions from ``start``."""
        need = [0] * self.sp
        for i in range(n):
            need[(start + i) % self.sp] += 1
        return need

    def can_alloc(self, n: int, start: int = 0) -> bool:
        if self.sp == 1:
            return n <= len(self._free)
        return all(need <= self._shard_free(s)
                   for s, need in enumerate(self._shard_need(n, start)))

    def _pick_free(self, shard: int) -> int:
        """Pop the most recently freed block of ``shard`` (LIFO per
        shard)."""
        for i in range(len(self._free) - 1, -1, -1):
            if self.owner(self._free[i]) == shard:
                return self._free.pop(i)
        raise AssertionError(f"shard {shard} has no free block")

    def alloc(self, n: int, start: int = 0) -> List[int]:
        """Take ``n`` blocks (refcount 1 each); raises PoolExhausted.

        ``start`` is the table position the first block will take: under
        sequence parallelism block i comes from shard ``(start + i) % sp``,
        so a sequence's pages spread round-robin over the shards. At sp = 1
        it is ignored."""
        if self.sp == 1:
            if n > len(self._free):
                raise PoolExhausted(f"need {n} blocks, {len(self._free)} "
                                    f"free (capacity {self.capacity})")
            blocks = [self._free.pop() for _ in range(n)]
        else:
            for s, need in enumerate(self._shard_need(n, start)):
                have = self._shard_free(s)
                if need > have:
                    raise PoolExhausted(
                        f"need {n} blocks from table position {start}, but "
                        f"shard {s} can cover only {have} of its {need} "
                        f"(capacity {self.capacity}, {self.sp} SP shards)")
            blocks = [self._pick_free((start + i) % self.sp)
                      for i in range(n)]
        for b in blocks:
            self._ref[b] = 1
        return blocks

    def free(self, blocks: Sequence[int]) -> None:
        """Drop one reference per block; blocks reaching zero return to the
        free list (deepest first, as the JAX pool orders them)."""
        for b in reversed(list(blocks)):
            r = self._ref.get(b)
            if r is None:
                raise KeyError(f"block {b} is not allocated (double free?)")
            if r == 1:
                del self._ref[b]
                self._free.append(b)
            else:
                self._ref[b] = r - 1

    def check_invariants(
            self,
            block_tables: Optional[Iterable[Sequence[int]]] = None,
            seq_lens: Optional[Sequence[int]] = None) -> None:
        """Verify the bookkeeping; raises ValueError on a violation.

        Always: free + allocated == capacity, and the same within each
        sequence-parallel shard, with no block in both, no duplicate free
        entries, every shard's scratch block out of circulation, ids in
        range, refcounts >= 1; each shard's pages contiguous, of its shape
        and on its device; under int8 both pages are ``QuantPages`` of int8
        data and f32 scales shaped as the data with the last axis 1. With
        ``block_tables`` (every running
        request's table): each allocated block appears in exactly refcount
        tables and no table names a free block. With ``seq_lens`` (parallel
        to the tables): each table covers its resident tokens and holds no
        more than ``blocks_for(seq_len + 1)`` blocks.
        """
        want_shape = (self.num_layers, self.blocks_per_shard,
                      self.num_kv_heads, self.block_size, self.head_dim)
        for s, (pk, pv) in enumerate(self.shard_pages()):
            for name, p in (("pages_k", pk), ("pages_v", pv)):
                data = p.data if isinstance(p, QuantPages) else p
                if tuple(data.shape) != want_shape \
                        or data.device != self.devices[s] \
                        or not data.is_contiguous():
                    raise ValueError(
                        f"shard {s} {name}: {tuple(data.shape)} on "
                        f"{data.device}; want contiguous {want_shape} on "
                        f"{self.devices[s]}")
        if self.kv_dtype == "int8":
            for name, p in [(n, p) for pk, pv in self.shard_pages()
                            for n, p in (("pages_k", pk), ("pages_v", pv))]:
                if not isinstance(p, QuantPages):
                    raise ValueError(
                        f"{name}: int8 pool holds {type(p).__name__}, not "
                        "QuantPages: pages without their scales")
                if p.data.dtype != torch.int8 \
                        or p.scale.dtype != torch.float32:
                    raise ValueError(
                        f"{name}: dtype drift: data {p.data.dtype} / scale "
                        f"{p.scale.dtype}, want int8 / float32")
                want = tuple(p.data.shape[:-1]) + (1,)
                if tuple(p.scale.shape) != want:
                    raise ValueError(
                        f"{name}: scale {tuple(p.scale.shape)} does not "
                        f"match pages {tuple(p.data.shape)} (want the last "
                        "axis collapsed to 1)")
        free_set = set(self._free)
        if len(free_set) != len(self._free):
            raise ValueError(f"duplicate blocks in free list: {self._free}")
        leaked = self._scratch & (free_set | self._ref.keys())
        if leaked:
            raise ValueError(f"scratch block {min(leaked)} entered "
                             "circulation")
        if free_set & self._ref.keys():
            raise ValueError(f"blocks both free and allocated: "
                             f"{free_set & self._ref.keys()}")
        if len(self._free) + len(self._ref) != self.capacity:
            raise ValueError(f"free ({len(self._free)}) + allocated "
                             f"({len(self._ref)}) != capacity "
                             f"({self.capacity})")
        bad = [b for b in free_set | self._ref.keys()
               if not 0 < b < self.num_blocks]
        for shard in range(self.sp):   # every shard accounted on its own
            held = sum(1 for b in self._ref if self.owner(b) == shard)
            if held + self._shard_free(shard) != self.blocks_per_shard - 1:
                raise ValueError(
                    f"shard {shard}: free ({self._shard_free(shard)}) + "
                    f"allocated ({held}) != {self.blocks_per_shard - 1}")
        if bad:
            raise ValueError(f"block ids out of range: {bad}")
        if any(r < 1 for r in self._ref.values()):
            raise ValueError(f"refcount < 1: {self._ref}")
        if block_tables is None:
            return
        block_tables = [list(t) for t in block_tables]
        if seq_lens is not None:
            for i, (table, n) in enumerate(zip(block_tables, seq_lens)):
                if n > len(table) * self.block_size:
                    raise ValueError(f"row {i}: {n} resident tokens exceed "
                                     f"{len(table)} blocks")
                if len(table) > self.blocks_for(n + 1):
                    raise ValueError(f"row {i}: stale tail — {len(table)} "
                                     f"blocks for {n} resident tokens")
        usage: Counter = Counter()
        for table in block_tables:
            usage.update(table)
        for b in self._scratch:
            usage.pop(b, None)
        stale = set(usage) & free_set
        if stale:
            raise ValueError(f"live tables reference free blocks: "
                             f"{sorted(stale)}")
        if usage != Counter(self._ref):
            raise ValueError(f"table/refcount mismatch: tables "
                             f"{dict(usage)} vs refcounts {self._ref}")


# -- the assembled-cache paths' gather and scatters ---------------------------


def _per_shard(pages) -> bool:
    return isinstance(pages, (list, tuple)) \
        and not isinstance(pages, QuantPages)


def _pages_device(pages) -> torch.device:
    return (pages.data if isinstance(pages, QuantPages) else pages).device


def gather_kv(pages_k, pages_v, block_tables, out_dtype=None):
    """Block tables -> contiguous ragged-batch caches.

    pages_*: (L, N, H, bs, Dh) tensors or ``QuantPages``; block_tables: (B,
    nb) int32. Returns two new (L, B, H, nb * bs, Dh) tensors: per layer
    the cache layout ``MultiHeadAttention.apply_cached`` reads. Positions
    past a row's length hold whatever their pages hold; the causal mask at
    each row's offset keeps them out of the softmax. ``QuantPages`` are
    dequantized at the gather, to ``out_dtype`` (default f32); plain pages
    keep their dtype.

    Under sequence parallelism ``pages_*`` and ``block_tables`` are lists
    over the shards (local tables, -1 where another shard owns the block).
    Each shard gathers the positions it owns and zeros its holes, and the
    shards' caches are summed in shard order on the first shard's device:
    every position has one owner, so the sum adds only zeros to it, which
    is the JAX package's psum over the context mesh.
    """
    if _per_shard(pages_k):
        lead = _pages_device(pages_k[0])
        total_k = total_v = None
        for pk, pv, tables in zip(pages_k, pages_v, block_tables):
            bs = (pk.data if isinstance(pk, QuantPages) else pk).shape[3]
            dead = (tables < 0).repeat_interleave(bs, dim=1)  # (B, nb*bs)
            dead = dead[None, :, None, :, None]
            k, v = gather_kv(pk, pv, tables.clamp_min(0), out_dtype)
            k = k.masked_fill(dead, 0).to(lead)
            v = v.masked_fill(dead, 0).to(lead)
            total_k = k if total_k is None else total_k + k
            total_v = v if total_v is None else total_v + v
        return total_k, total_v
    tables = block_tables.long()
    b, nb = tables.shape

    def gather(pages):
        if isinstance(pages, QuantPages):
            x = pages.data[:, tables].float() * pages.scale[:, tables]
            x = x.to(out_dtype or torch.float32)
        else:
            x = pages[:, tables]                  # (L, B, nb, H, bs, Dh)
        n_layers, _, _, h, bs, dh = x.shape
        return x.transpose(2, 3).reshape(n_layers, b, h, nb * bs, dh)

    return gather(pages_k), gather(pages_v)


def scatter_token(pages, block_tables, offsets, rows):
    """Write one new KV row per sequence at its decode position, all layers
    at once, in place.

    pages: (L, N, H, bs, Dh); block_tables: (B, nb); offsets: (B,) the
    position each row just wrote; rows: (L, B, H, Dh). Padded rows point
    their tables at SCRATCH, so their writes land in the scratch block, as
    do -1 holes. ``QuantPages`` quantize the rows here. Under sequence
    parallelism ``pages`` and ``block_tables`` are per-shard lists: each
    shard writes the rows it owns and sends the rest to its scratch row.
    Returns ``pages``.
    """
    if _per_shard(pages):
        for shard, tables in zip(pages, block_tables):
            dev = _pages_device(shard)
            scatter_token(shard, tables, offsets.to(dev), rows.to(dev))
        return pages
    if isinstance(pages, QuantPages):
        qrows, srows = quantize_kv_rows(rows)
        scatter_token(pages.data, block_tables, offsets, qrows)
        scatter_token(pages.scale, block_tables, offsets, srows)
        return pages
    bs = pages.shape[3]
    offsets = offsets.long()
    blk = block_tables.long().gather(1, (offsets // bs)[:, None])[:, 0]
    # the two advanced indices (blk, slot) around sliced axes put the batch
    # dim first: the target is (B, L, H, Dh)
    pages[:, blk.clamp_min(0), :, offsets % bs, :] = \
        rows.transpose(0, 1).to(pages.dtype)
    return pages


def scatter_chunk(pages, block_tables, starts, rows, q_lens):
    """Write a ragged chunk of new KV rows per sequence, all layers at
    once, in place.

    pages: (L, N, H, bs, Dh); block_tables: (B, nb); starts: (B,) the first
    position each row writes; rows: (L, B, Q, H, Dh); q_lens: (B,) live
    tokens per row. Row b's tokens q < q_lens[b] land at starts[b] + q;
    padding tokens and -1 holes go to SCRATCH, which is never allocated to
    a request. Which of several padding tokens lands last in a scratch
    slot is not defined; nothing reads them. ``QuantPages`` quantize the
    rows here. Under sequence parallelism ``pages`` and ``block_tables``
    are per-shard lists, as for ``scatter_token``. Returns ``pages``.
    """
    if _per_shard(pages):
        for shard, tables in zip(pages, block_tables):
            dev = _pages_device(shard)
            scatter_chunk(shard, tables, starts.to(dev), rows.to(dev),
                          q_lens.to(dev))
        return pages
    if isinstance(pages, QuantPages):
        qrows, srows = quantize_kv_rows(rows)
        scatter_chunk(pages.data, block_tables, starts, qrows, q_lens)
        scatter_chunk(pages.scale, block_tables, starts, srows, q_lens)
        return pages
    bs = pages.shape[3]
    qw = rows.shape[2]
    nbt = block_tables.shape[1]
    steps = torch.arange(qw, device=pages.device)
    pos = starts.long()[:, None] + steps                       # (B, Q)
    live = steps[None, :] < q_lens.long()[:, None]
    blk = block_tables.long().gather(1, (pos // bs).clamp(0, nbt - 1))
    blk = torch.where(live, blk, PagedKVPool.SCRATCH).clamp_min(0)
    # advanced (blk, slot) indices of (B, Q) lead the target: (B, Q, L, H,
    # Dh)
    pages[:, blk, :, pos % bs, :] = rows.permute(1, 2, 0, 3, 4).to(
        pages.dtype)
    return pages

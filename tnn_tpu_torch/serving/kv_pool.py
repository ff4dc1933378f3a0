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

TENSOR PARALLELISM (``tp > 1``, ``serving/tp.py``): the HEAD axis splits
over ``tp`` shards instead. ``pages_k`` / ``pages_v`` are lists with one
``(L, N, H_kv / tp, bs, Dh)`` tensor (or ``QuantPages``, whose scales
travel with their heads) per shard, on that shard's device, in shard
order. Every shard holds every block, so block ids, refcounts, the free
list and ``kv_bytes_per_token`` stay those of tp = 1, and a step hands
every shard the same table. ``copy_block``, ``reset_pages`` and the
export / adopt pair work on every shard; an export joins the head axis, so
its wire format equals tp = 1's, and an adopt splits it again.

The module's step-side helpers serve the assembled-cache ("standard" and
"fused") decode paths: ``gather_kv`` builds each row's contiguous cache
from its block table, and ``scatter_token`` / ``scatter_chunk`` write one
step's new rows back for all layers at once. Each takes one shard's pages
and table, or under SP the lists of per-shard pages and local tables.

Prefix caching (``serving.prefix_cache``): ``fork`` shares blocks between
tables by refcount. A block whose last reference drops while the cache
still indexes it (``evictable_filter``) parks in an evictable LRU instead
of the free list; it counts as allocatable, ``alloc`` reclaims the oldest
such blocks when the free list runs short (``reclaim_hook`` tells the cache
to forget them), and ``fork`` revives one a hit names. ``truncate`` drops a
table's tail (speculative decoding's rollback), and ``copy_blocks`` clones
whole pages (the copy-on-write of a full-cover hit). Under SP each shard
reclaims and revives its own blocks: a block never changes shard.

Host tier and KV handoff: ``demote_hook`` hears of reclaimed blocks before
``reclaim_hook`` (while the cache still names their keys), and the engine
copies their pages to the host with ``export_blocks`` (one batched copy a
shard); ``adopt_blocks`` writes host payloads back into allocated blocks
IN PLACE (``write_block``), never rebinding ``pages_k`` / ``pages_v``,
whose addresses the captured pdecode graphs hold.
"""
from __future__ import annotations

import math
import os
from collections import Counter, OrderedDict
from typing import Callable, Dict, Iterable, List, Optional, Sequence

import torch

import numpy as np

from ..ops.paged_attention import QuantPages, quantize_kv_rows
from .kv_tier import BF16_WIRE


class PoolExhausted(RuntimeError):
    """No free blocks: the scheduler preempts and retries."""


class PagedKVPool:
    SCRATCH = 0  # reserved block for padded/inactive batch rows

    def __init__(self, num_layers: int, num_kv_heads: int, head_dim: int,
                 num_blocks: int, block_size: int = 16,
                 dtype: torch.dtype = torch.float32, device="cuda", *,
                 kv_dtype: str = "f32", sp: int = 1, tp: int = 1,
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
        if tp < 1:
            raise ValueError(f"tp must be >= 1, got {tp}")
        if sp > 1 and tp > 1:
            raise ValueError("a pool splits its blocks (sp) or its heads "
                             "(tp), not both")
        if num_kv_heads % tp:
            raise ValueError(f"num_kv_heads {num_kv_heads} must divide "
                             f"evenly over tp {tp} shards")
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
        # tensor parallelism: shard s holds heads [s * H_l, (s + 1) * H_l)
        # of every block, H_l = num_kv_heads // tp
        self.tp = int(tp)
        self.heads_per_shard = self.num_kv_heads // self.tp
        n_shards = max(self.sp, self.tp)
        devices = list(devices) if devices is not None \
            else [device] * n_shards
        if len(devices) != n_shards:
            raise ValueError(f"{len(devices)} devices for {n_shards} shards")
        shape = (self.num_layers, self.blocks_per_shard,
                 self.heads_per_shard, self.block_size, self.head_dim)

        def fresh(dev):
            if kv_dtype == "int8":
                return QuantPages(
                    torch.zeros(shape, dtype=torch.int8, device=dev),
                    torch.zeros(shape[:-1] + (1,), dtype=torch.float32,
                                device=dev))
            return torch.zeros(shape, dtype=dtype, device=dev)

        # one contiguous page tensor (or bundle) per shard, on its device;
        # unsharded, the pool holds the tensors themselves
        pk = [fresh(d) for d in devices]
        pv = [fresh(d) for d in devices]
        self.devices = [(p.data if kv_dtype == "int8" else p).device
                        for p in pk]
        self.pages_k, self.pages_v = (pk, pv) if n_shards > 1 \
            else (pk[0], pv[0])
        # LIFO free list: freshly freed blocks are reused first; scratch
        # blocks never enter it
        self._free: List[int] = [b for b in range(self.num_blocks - 1, -1, -1)
                                 if b not in self._scratch]
        self._ref: Dict[int, int] = {}
        # evictable LRU (insertion order = reclaim order, oldest first):
        # zero-ref blocks whose content the prefix cache still indexes
        self._evictable: "OrderedDict[int, None]" = OrderedDict()
        # prefix-cache hooks, None with the cache off: free() parks a
        # zero-ref block iff evictable_filter(block); reclaim_hook(blocks)
        # hears of every evictable block recycled
        self.evictable_filter: Optional[Callable[[int], bool]] = None
        self.reclaim_hook: Optional[Callable[[List[int]], None]] = None
        # host-tier hook: hears of the blocks a reclaim recycles BEFORE
        # reclaim_hook unindexes them, while the pages still hold their KV;
        # never called from purge_evictable (the pages are untrusted there)
        self.demote_hook: Optional[Callable[[List[int]], None]] = None
        # chaos hook (a serving.faults.FaultPlan): alloc() consults it and
        # may raise an injected PoolExhausted before any state changes
        self.fault_plan = None
        # TNN_POOL_DEBUG=1: check_invariants after every bookkeeping
        # mutation (O(blocks) host work), off by default
        self.debug = os.environ.get("TNN_POOL_DEBUG", "") == "1"

    # -- bookkeeping ----------------------------------------------------------

    @property
    def capacity(self) -> int:
        """Allocatable blocks: all but one scratch block per shard."""
        return self.num_blocks - self.sp

    @property
    def num_free(self) -> int:
        return len(self._free)

    @property
    def num_evictable(self) -> int:
        """Zero-ref blocks parked for the prefix cache (reclaimable)."""
        return len(self._evictable)

    @property
    def num_allocatable(self) -> int:
        """Blocks an alloc can take now: free + evictable. Under sequence
        parallelism table position j's block must come from shard ``j %
        sp``, so the BOTTLENECK shard gates it: ``sp * min_s(avail_s)``,
        the longest run of table positions allocatable from any start. The
        scheduler reads only this, so admission follows the scarcest
        shard."""
        if self.sp == 1:
            return len(self._free) + len(self._evictable)
        return self.sp * min(self._shard_avail(s) for s in range(self.sp))

    @property
    def num_allocated(self) -> int:
        return self.capacity - len(self._free) - len(self._evictable)

    @property
    def occupancy(self) -> float:
        """Share of capacity live requests hold (evictable blocks count as
        available)."""
        return self.num_allocated / max(self.capacity, 1)

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

    @property
    def sharded(self) -> bool:
        """The pages are per-shard lists (sp > 1 or tp > 1)."""
        return self.sp > 1 or self.tp > 1

    def shard_pages(self):
        """[(pages_k, pages_v)] of each shard, in shard order."""
        if not self.sharded:
            return [(self.pages_k, self.pages_v)]
        return list(zip(self.pages_k, self.pages_v))

    def copy_block(self, src: int, dst: int) -> None:
        """Clone block ``src`` into ``dst`` in place (a copy-on-write): on
        the owning shard under SP (both ids must live there), on every
        shard's heads under TP."""
        if self.owner(src) != self.owner(dst):
            raise ValueError(f"blocks {src} and {dst} live on different "
                             "SP shards")
        s = self.owner(src)
        n = self.blocks_per_shard
        pairs = self.shard_pages()
        for pk, pv in (pairs if self.tp > 1 else [pairs[s]]):
            for pages in (pk, pv):
                copy_blocks(pages, [src - s * n], [dst - s * n])

    def _shard_avail(self, shard: int) -> int:
        """Free + evictable blocks of one shard."""
        return (sum(1 for b in self._free if self.owner(b) == shard)
                + sum(1 for b in self._evictable if self.owner(b) == shard))

    def _shard_need(self, n: int, start: int) -> List[int]:
        """Blocks each shard gives ``n`` table positions from ``start``."""
        need = [0] * self.sp
        for i in range(n):
            need[(start + i) % self.sp] += 1
        return need

    def can_alloc(self, n: int, start: int = 0) -> bool:
        if self.sp == 1:
            return n <= len(self._free) + len(self._evictable)
        return all(need <= self._shard_avail(s)
                   for s, need in enumerate(self._shard_need(n, start)))

    def is_evictable(self, block: int) -> bool:
        return block in self._evictable

    def _pick_free(self, shard: int) -> Optional[int]:
        """Pop the most recently freed block of ``shard`` (LIFO per
        shard), or None. No ``_debug_check`` here: the popped block is in
        no set until ``alloc`` gives it its reference, and a check between
        the two would see a block missing from the partition."""
        for i in range(len(self._free) - 1, -1, -1):
            if self.owner(self._free[i]) == shard:
                return self._free.pop(i)
        return None

    def _reclaim_shard(self, shard: int) -> None:
        """Reclaim the LRU-oldest evictable block of ``shard`` into the free
        list, telling ``demote_hook`` and then ``reclaim_hook``."""
        b = next(b for b in self._evictable if self.owner(b) == shard)
        del self._evictable[b]
        self._free.append(b)
        if self.demote_hook is not None:
            self.demote_hook([b])
        if self.reclaim_hook is not None:
            self.reclaim_hook([b])
        self._debug_check()

    def _reclaim(self, n: int, demote: bool = True) -> List[int]:
        """Move the ``n`` LRU-oldest evictable blocks to the free list and
        tell ``reclaim_hook``: their cached KV leaves the card. With
        ``demote`` and a ``demote_hook`` (the host tier), the hook hears of
        them first, while the cache still maps block -> key; whatever it
        does, the reclaim goes on alike."""
        taken = []
        for _ in range(n):
            b, _ = self._evictable.popitem(last=False)
            taken.append(b)
            self._free.append(b)
        if taken and demote and self.demote_hook is not None:
            self.demote_hook(taken)
        if taken and self.reclaim_hook is not None:
            self.reclaim_hook(taken)
        self._debug_check()
        return taken

    def alloc(self, n: int, start: int = 0) -> List[int]:
        """Take ``n`` blocks (refcount 1 each); raises PoolExhausted. When
        the free list runs short, LRU-oldest evictable blocks are reclaimed
        first, so cached pages are recycled before an allocation fails.

        ``start`` is the table position the first block will take: under
        sequence parallelism block i comes from shard ``(start + i) % sp``,
        so a sequence's pages spread round-robin over the shards. At sp = 1
        it is ignored. With ``fault_plan`` set, an injected ``PoolExhausted``
        may be raised before anything changes."""
        if self.sp == 1:
            if n > len(self._free) + len(self._evictable):
                raise PoolExhausted(
                    f"need {n} blocks, {len(self._free)} free + "
                    f"{len(self._evictable)} evictable "
                    f"(capacity {self.capacity})")
            if self.fault_plan is not None:
                # before any bookkeeping changes: an injected failure never
                # half-takes blocks, nor reclaims cached ones for nothing
                self.fault_plan.on_alloc(n, self.num_allocatable)
            if n > len(self._free):
                self._reclaim(n - len(self._free))
            blocks = [self._free.pop() for _ in range(n)]
            for b in blocks:
                self._ref[b] = 1
        else:
            for s, need in enumerate(self._shard_need(n, start)):
                have = self._shard_avail(s)
                if need > have:
                    raise PoolExhausted(
                        f"need {n} blocks from table position {start}, but "
                        f"shard {s} can cover only {have} of its {need} "
                        f"(capacity {self.capacity}, {self.sp} SP shards)")
            if self.fault_plan is not None:
                self.fault_plan.on_alloc(n, self.num_allocatable)
            blocks = []
            for i in range(n):
                s = (start + i) % self.sp
                b = self._pick_free(s)
                if b is None:
                    self._reclaim_shard(s)
                    b = self._pick_free(s)
                # referenced at once: a later pick's reclaim checks the
                # partition, which must hold every block picked before it
                self._ref[b] = 1
                blocks.append(b)
        self._debug_check()
        return blocks

    def fork(self, blocks: Sequence[int]) -> List[int]:
        """Share ``blocks`` with another table: one more reference each. An
        evictable block is revived to refcount 1 (a prefix hit on a block
        no live request holds)."""
        for b in blocks:
            if b in self._ref:
                self._ref[b] += 1
            elif b in self._evictable:
                del self._evictable[b]
                self._ref[b] = 1
            else:
                raise KeyError(f"block {b} is not allocated")
        self._debug_check()
        return list(blocks)

    def free(self, blocks: Sequence[int]) -> None:
        """Drop one reference per block. A block reaching zero returns to
        the free list, or parks in the evictable LRU while the prefix cache
        indexes it. Deepest first, as the JAX pool: a table's chain tail
        parks nearer the reclaim end than its parents."""
        for b in reversed(list(blocks)):
            r = self._ref.get(b)
            if r is None:
                raise KeyError(f"block {b} is not allocated (double free?)")
            if r == 1:
                del self._ref[b]
                if (self.evictable_filter is not None
                        and self.evictable_filter(b)):
                    self._evictable[b] = None    # newest = reclaimed last
                else:
                    self._free.append(b)
            else:
                self._ref[b] = r - 1
        self._debug_check()

    def _debug_check(self) -> None:
        """Under TNN_POOL_DEBUG=1, ``check_invariants`` after a
        bookkeeping mutation, so that a broken free / allocated /
        evictable partition raises at the mutation that broke it."""
        if self.debug:
            self.check_invariants()

    def truncate(self, block_table: Sequence[int],
                 num_tokens: int) -> List[int]:
        """Keep the blocks covering a table's first ``num_tokens`` positions
        and free the tail (speculative decoding's rollback of a rejected
        draft suffix). Returns the kept prefix as a new list."""
        keep = self.blocks_for(num_tokens) if num_tokens > 0 else 0
        if keep >= len(block_table):
            return list(block_table)
        self.free(block_table[keep:])
        return list(block_table[:keep])

    def padded_table(self, block_table: Sequence[int],
                     width: int) -> List[int]:
        """Right-pad a block table with SCRATCH to ``width``."""
        if len(block_table) > width:
            raise ValueError(f"block table of {len(block_table)} exceeds "
                             f"assembly width {width}")
        return list(block_table) + [self.SCRATCH] * (width - len(block_table))

    def reset_pages(self) -> None:
        """Zero every page, in place (captured step graphs hold the
        pages' addresses). The bookkeeping is untouched: the caller has
        released every block that held KV, and with a prefix cache must
        also ``purge_evictable()`` and clear the index."""
        for pages in (self.pages_k, self.pages_v):
            for shard in (pages if self.sharded else [pages]):
                for t in ((shard.data, shard.scale)
                          if isinstance(shard, QuantPages) else (shard,)):
                    t.zero_()

    def release_pages(self) -> None:
        """Replace every page tensor by an empty one on its device, so its
        memory goes back to the allocator (a retired replica). The pool
        serves no step afterwards."""
        def empty(p):
            if isinstance(p, QuantPages):
                return QuantPages(p.data.new_empty(0), p.scale.new_empty(0))
            return p.new_empty(0)

        if self.sharded:
            self.pages_k = [empty(p) for p in self.pages_k]
            self.pages_v = [empty(p) for p in self.pages_v]
        else:
            self.pages_k = empty(self.pages_k)
            self.pages_v = empty(self.pages_v)

    def purge_evictable(self) -> List[int]:
        """Reclaim every evictable block (the pages' content became
        untrustworthy), without demoting it."""
        return self._reclaim(len(self._evictable), demote=False)

    def pages_deleted(self) -> bool:
        """The JAX pool's check for pages donated into a step that died.
        The port writes its pages in place and never gives them away, so
        they are never deleted."""
        return False

    def _locate(self, block: int):
        """(pages_k, pages_v, local id) of a global block id."""
        s = self.owner(block)
        pk, pv = self.shard_pages()[s]
        return pk, pv, block - s * self.blocks_per_shard

    def export_blocks(self, blocks: Sequence[int]) -> List[tuple]:
        """Copy whole pages to the host, one leaf tuple per block: ``(k,
        v)``, or ``(k_data, k_scale, v_data, v_scale)`` under int8, each
        leaf (L, H_kv, bs, Dh) (scales (L, H_kv, bs, 1)) as numpy, bf16 as
        its raw bits (``kv_tier.BF16_WIRE``). The leaf order is what
        ``adopt_blocks`` writes and the host tier stores. Each shard's
        blocks leave the card in ONE copy, queued on the current stream
        after every step that wrote the pages, so the copy waits for them
        (the demote hook and the handoff export, never a step-path call)."""
        out: List[Optional[tuple]] = [None] * len(blocks)
        by_shard: Dict[int, List[int]] = {}
        for i, b in enumerate(blocks):
            by_shard.setdefault(self.owner(b), []).append(i)
        for s, idxs in by_shard.items():
            local = [blocks[i] - s * self.blocks_per_shard for i in idxs]
            pairs = self.shard_pages()
            heads = []        # the leaves of each head shard, in order
            for pk, pv in (pairs if self.tp > 1 else [pairs[s]]):
                heads.append((pk.data, pk.scale, pv.data, pv.scale)
                             if isinstance(pk, QuantPages) else (pk, pv))
            lead = heads[0][0].device
            # (n, L, H, bs, Dh) per leaf: each block's slice contiguous,
            # the TP shards' heads joined on the lead device
            parts = [torch.cat([t.index_select(1, torch.tensor(
                local, dtype=torch.long, device=t.device)).transpose(0, 1)
                .to(lead) for t in leaf], dim=2).contiguous()
                for leaf in zip(*heads)]
            flat = torch.cat([p.reshape(-1).view(torch.uint8)
                              for p in parts])
            host = flat.cpu().numpy()
            off = 0
            leaves = []
            for p in parts:
                nbytes = p.numel() * p.element_size()
                arr = host[off:off + nbytes].view(_np_dtype(p.dtype))
                leaves.append(arr.reshape(tuple(p.shape)))
                off += nbytes
            for j, i in enumerate(idxs):
                out[i] = tuple(leaf[j].copy() for leaf in leaves)
        return out

    def adopt_blocks(self, items: Sequence[tuple]) -> None:
        """Write payloads into already-allocated blocks, in place: the
        device half of a tier re-admission or a handoff adopt. ``items``
        holds ``(block_id, payload_k, payload_v)`` with the payloads as
        ``host_payload`` makes them (``QuantPages`` of slices under int8,
        so data and scales land together). Callers digest-verify wire
        payloads (``kv_tier.tier_digest``) before they come here."""
        for blk, payload_k, payload_v in items:
            if self.tp > 1:      # each shard takes its heads of the block
                hl = self.heads_per_shard
                for s, (pk, pv) in enumerate(self.shard_pages()):
                    write_block(pk, int(blk),
                                _head_slice(payload_k, s * hl, hl))
                    write_block(pv, int(blk),
                                _head_slice(payload_v, s * hl, hl))
                continue
            pk, pv, local = self._locate(int(blk))
            write_block(pk, local, payload_k)
            write_block(pv, local, payload_v)

    def host_payload(self, leaves: Sequence[np.ndarray], block: int):
        """Host leaves (``export_blocks``' form) -> the two payloads
        ``adopt_blocks`` writes, on the device of ``block``'s shard (the
        lead shard's under TP, with every head)."""
        dev = self.devices[self.owner(int(block))]

        def put(a):
            a = np.ascontiguousarray(a)
            if a.dtype.metadata and a.dtype.metadata.get("dtype") \
                    == "bfloat16":
                return torch.from_numpy(a.view(np.int16)).to(dev).view(
                    torch.bfloat16)
            return torch.from_numpy(a).to(dev)

        if len(leaves) == 4:
            return (QuantPages(put(leaves[0]), put(leaves[1])),
                    QuantPages(put(leaves[2]), put(leaves[3])))
        return put(leaves[0]), put(leaves[1])

    def wire_dtype_name(self) -> str:
        """The dtype name float page leaves carry (``kv_tier.
        leaf_dtype_name``): the pages' own, "bfloat16" for bf16."""
        return str(self.dtype).replace("torch.", "")

    def check_invariants(
            self,
            block_tables: Optional[Iterable[Sequence[int]]] = None,
            seq_lens: Optional[Sequence[int]] = None) -> None:
        """Verify the bookkeeping; raises ValueError on a violation.

        Always: free + allocated + evictable == capacity, and the same
        within each sequence-parallel shard, a strict partition (no block in
        two sets, an evictable block holds no reference), no duplicate free
        entries, every shard's scratch block out of circulation, ids in
        range, refcounts >= 1; each shard's pages contiguous, of its shape
        and on its device; under int8 both pages are ``QuantPages`` of int8
        data and f32 scales shaped as the data with the last axis 1. With
        ``block_tables`` (every running
        request's table): each allocated block appears in exactly refcount
        tables and no table names a free or evictable block. With
        ``seq_lens`` (parallel to the tables): each table covers its
        resident tokens and holds no more than ``blocks_for(seq_len + 1)``
        blocks, so a rejected draft suffix left untruncated shows as a
        stale tail.
        """
        want_shape = (self.num_layers, self.blocks_per_shard,
                      self.heads_per_shard, self.block_size, self.head_dim)
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
        evict_set = set(self._evictable)
        leaked = self._scratch & (free_set | self._ref.keys() | evict_set)
        if leaked:
            raise ValueError(f"scratch block {min(leaked)} entered "
                             "circulation")
        for name, both in (("free and allocated", free_set & self._ref.keys()),
                           ("evictable and allocated",
                            evict_set & self._ref.keys()),
                           ("evictable and free", evict_set & free_set)):
            if both:
                raise ValueError(f"blocks both {name}: {sorted(both)}")
        if len(self._free) + len(self._ref) + len(evict_set) != self.capacity:
            raise ValueError(f"free ({len(self._free)}) + allocated "
                             f"({len(self._ref)}) + evictable "
                             f"({len(evict_set)}) != capacity "
                             f"({self.capacity})")
        bad = [b for b in free_set | self._ref.keys() | evict_set
               if not 0 < b < self.num_blocks]
        for shard in range(self.sp):   # every shard accounted on its own
            held = sum(1 for b in self._ref if self.owner(b) == shard)
            if held + self._shard_avail(shard) != self.blocks_per_shard - 1:
                raise ValueError(
                    f"shard {shard}: free + evictable "
                    f"({self._shard_avail(shard)}) + allocated ({held}) != "
                    f"{self.blocks_per_shard - 1}")
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
        stale = set(usage) & (free_set | evict_set)
        if stale:
            raise ValueError(f"live tables reference evictable or free "
                             f"blocks (use-after-free): {sorted(stale)}")
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


def scatter_prefill(pages, blocks, kv):
    """Write one sequence's contiguous prefill cache into its blocks, all
    layers at once, in place (the whole-prompt prefill's write).

    pages: (L, N, H, bs, Dh); blocks: (nb,) int block ids; kv: (L, H, nb *
    bs, Dh). ``QuantPages`` quantize the rows here (``quantize_kv_rows``).
    A -1 block goes to the scratch row 0; under sequence parallelism
    ``pages`` and ``blocks`` are per-shard lists (local ids, -1 where
    another shard owns the block), so each shard keeps only its own
    blocks. A padded tail pointing at SCRATCH lands there too. Returns
    ``pages``."""
    if _per_shard(pages):
        for shard, local in zip(pages, blocks):
            dev = _pages_device(shard)
            scatter_prefill(shard, local.to(dev), kv.to(dev))
        return pages
    if isinstance(pages, QuantPages):
        qkv, skv = quantize_kv_rows(kv)
        scatter_prefill(pages.data, blocks, qkv)
        scatter_prefill(pages.scale, blocks, skv)
        return pages
    n_layers, _, h, bs, dh = pages.shape
    nb = blocks.shape[0]
    x = kv.reshape(n_layers, h, nb, bs, dh).transpose(1, 2)  # (L, nb, H, ...)
    pages[:, blocks.long().clamp_min(0)] = x.to(pages.dtype)
    return pages


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


def _np_dtype(dtype: torch.dtype) -> np.dtype:
    """numpy dtype of a page leaf; bf16 as raw bits (``BF16_WIRE``)."""
    if dtype == torch.bfloat16:
        return BF16_WIRE
    return torch.empty((), dtype=dtype).numpy().dtype


def _head_slice(payload, start: int, n: int):
    """Heads ``[start, start + n)`` of a (L, H, bs, Dh) block payload (or a
    ``QuantPages`` of them, scales with their heads)."""
    if isinstance(payload, QuantPages):
        return QuantPages(payload.data[:, start:start + n],
                          payload.scale[:, start:start + n])
    return payload[:, start:start + n]


def write_block(pages, block: int, payload):
    """Write one whole page at ``block`` across every layer, in place
    (the host tier's and the handoff's device half). pages: (L, N, H, bs,
    Dh) of one shard; block: an id local to it; payload: (L, H, bs, Dh).
    Under ``QuantPages`` the payload is a ``QuantPages`` of slices, so the
    int8 data and its scales land together and a readmitted block never
    dequantizes against stale scales."""
    if isinstance(pages, QuantPages):
        write_block(pages.data, block, payload.data)
        write_block(pages.scale, block, payload.scale)
        return pages
    pages[:, block].copy_(payload)
    return pages


def copy_blocks(pages, src, dst):
    """Copy whole pages ``src -> dst`` in place, across every layer (the
    device half of a copy-on-write clone). pages: (L, N, H, bs, Dh) of one
    shard; src, dst: (n,) block ids local to it. ``QuantPages`` copy their
    scales with the data, so a clone dequantizes as its source does."""
    if isinstance(pages, QuantPages):
        copy_blocks(pages.data, src, dst)
        copy_blocks(pages.scale, src, dst)
        return pages
    pages[:, dst] = pages[:, src]
    return pages

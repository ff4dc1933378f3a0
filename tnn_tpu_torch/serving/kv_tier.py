"""Host-RAM KV tier (``tnn_tpu.serving.kv_tier``): a bounded second-chance
buffer for evicted prefix KV.

Under pool pressure the paged pool reclaims LRU-oldest *evictable* blocks,
zero-ref pages whose content the prefix cache still indexes. Without a tier
that KV is gone and the next request with the same prefix prefills it
again. The pool's ``demote_hook`` hands the engine each reclaimed-but-
indexed block first; the engine copies its pages to host RAM
(``PagedKVPool.export_blocks``, one batched copy), and the tier stores them
under the block's chain key (``prefix_cache.chain_keys``), the content
address the device index uses.

Re-admission is verified: at demote time the tier records a blake2b-128
digest over ``chain || leaves``; ``verify_readmit`` recomputes it before it
releases the payload. A corrupt entry (the seeded ``tier.corrupt`` fault)
fails the check, is dropped, and the lookup degrades to an uncached miss.

Leaves are host numpy arrays: ``(k, v)`` for float pools, ``(k_data,
k_scale, v_data, v_scale)`` for int8 pools (about half the bytes). bf16
pages travel as raw 16 bits (``BF16_WIRE``), and the digest names them
"bfloat16", so the same bits hash as in the JAX package. The tier is
bounded (``max_bytes``): demoting evicts LRU-oldest entries to fit, and an
entry that cannot fit at all is plain eviction (``demote`` returns False).

Thread-safety: called only from the engine's worker (the serialization the
pool's bookkeeping relies on), so no lock.
"""
from __future__ import annotations

import hashlib
import time
from collections import OrderedDict
from typing import List, Optional, Tuple

import numpy as np


#: numpy has no bfloat16 without ``ml_dtypes``: bf16 pages travel as their
#: raw 16 bits in this dtype, whose metadata names what the bits are
BF16_WIRE = np.dtype(np.uint16, metadata={"dtype": "bfloat16"})


def leaf_dtype_name(arr: np.ndarray) -> str:
    """The dtype name a leaf's digest commits to: ``"bfloat16"`` for raw
    bf16 bits (``BF16_WIRE``), so the same bits give the JAX package's
    digest of an ``ml_dtypes`` bfloat16 array."""
    meta = arr.dtype.metadata
    return meta["dtype"] if meta and "dtype" in meta else str(arr.dtype)


def tier_digest(chain: bytes, leaves: Tuple[np.ndarray, ...]) -> bytes:
    """Integrity digest binding a demoted payload to its chain key: blake2b
    over the key plus every leaf's dtype name, shape and bytes. With dtype
    and shape in it, a truncated or re-shaped payload fails verification
    even if its raw bytes happen to prefix-match."""
    h = hashlib.blake2b(digest_size=16)
    h.update(chain)
    for leaf in leaves:
        arr = np.ascontiguousarray(leaf)
        h.update(leaf_dtype_name(leaf).encode())
        h.update(np.asarray(arr.shape, np.int64).tobytes())
        h.update(arr.reshape(-1).view(np.uint8))   # the bytes, uncopied
    return h.digest()


class _TierEntry:
    __slots__ = ("key", "leaves", "nbytes", "digest")

    def __init__(self, key: bytes, leaves: Tuple[np.ndarray, ...]):
        self.key = key
        self.leaves = leaves
        self.nbytes = int(sum(leaf.nbytes for leaf in leaves))
        self.digest = tier_digest(key, leaves)


class HostKVTier:
    """Bounded host-RAM LRU of demoted KV blocks, content-addressed by
    chain key and integrity-checked on the way back in.

    ``leaves`` is the per-block payload as a tuple of numpy arrays — the
    engine packs ``(k_slice, v_slice)`` for f32 pools and
    ``(k_data, k_scale, v_data, v_scale)`` for int8 pools; the tier never
    interprets them beyond hashing and byte accounting, so any pool dtype
    rides through unchanged.
    """

    def __init__(self, max_bytes: int, fault_plan=None):
        if max_bytes <= 0:
            raise ValueError(f"max_bytes must be > 0, got {max_bytes}")
        self.max_bytes = int(max_bytes)
        # chaos hook (serving.faults.FaultPlan): demote() consults
        # tier_demote_fail, verify_readmit() consults tier_slow_readmit
        # and tier_corrupt
        self.fault_plan = fault_plan
        # LRU: insertion order = eviction order (oldest demoted first)
        self._entries: "OrderedDict[bytes, _TierEntry]" = OrderedDict()
        self.bytes_used = 0
        # counters (surfaced through engine.stats() / the tier gauges)
        self.demotions = 0
        self.demote_failures = 0      # injected faults + oversize entries
        self.readmits = 0
        self.corrupt_dropped = 0
        self.evictions = 0            # tier-LRU entries displaced to fit

    # -- lookup ---------------------------------------------------------------

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, key: bytes) -> bool:
        return key in self._entries

    # -- demote (device -> host) ----------------------------------------------

    def demote(self, chain: bytes,
               leaves: Tuple[np.ndarray, ...]) -> bool:
        """Admit one evicted block's payload under its chain key.

        Returns False — and the caller proceeds with plain eviction — when
        the seeded ``tier.demote_fail`` fault fires or the entry alone
        exceeds ``max_bytes``. Otherwise LRU-oldest entries are displaced
        until the new entry fits. A key already present is replaced (the
        pool re-published the same prefix into a fresh block; newest
        content wins and the byte accounting stays exact).
        """
        if self.fault_plan is not None and self.fault_plan.tier_demote_fail():
            self.demote_failures += 1
            return False
        entry = _TierEntry(chain, tuple(np.asarray(x) for x in leaves))
        if entry.nbytes > self.max_bytes:
            self.demote_failures += 1
            return False
        old = self._entries.pop(chain, None)
        if old is not None:
            self.bytes_used -= old.nbytes
        while self.bytes_used + entry.nbytes > self.max_bytes:
            _, victim = self._entries.popitem(last=False)
            self.bytes_used -= victim.nbytes
            self.evictions += 1
        self._entries[chain] = entry
        self.bytes_used += entry.nbytes
        self.demotions += 1
        return True

    # -- readmit (host -> device) ---------------------------------------------

    def verify_readmit(self, chain: bytes) \
            -> Optional[Tuple[np.ndarray, ...]]:
        """Release one entry's payload for re-admission, integrity-checked.

        Recomputes the digest over the stored leaves and compares it to the
        digest recorded at demote time; a mismatch (corruption, a torn
        write, the seeded ``tier.corrupt`` fault) drops the entry and
        returns None — the caller treats it as an uncached miss. On success
        the entry leaves the tier (its content is about to become
        device-resident and re-indexed; it re-demotes on its next
        eviction). Returns the leaf tuple, or None on miss/corruption.
        """
        entry = self._entries.get(chain)
        if entry is None:
            return None
        if self.fault_plan is not None:
            if self.fault_plan.tier_slow_readmit():
                # a stalled host read (page-out, NUMA contention): the
                # readmit still succeeds, it just arrives late
                time.sleep(self.fault_plan.tier_slow_readmit_s)
            if self.fault_plan.tier_corrupt():
                # flip one byte of a COPY of the first leaf so the digest
                # check below genuinely catches real corruption — the
                # fault plants damage, the verifier finds it
                leaves = tuple(np.array(x, copy=True) for x in entry.leaves)
                flat = leaves[0].reshape(-1).view(np.uint8)
                flat[0] ^= 0xFF
                entry = _TierEntry(entry.key, leaves)
                entry.digest = self._entries[chain].digest
        if tier_digest(chain, entry.leaves) != entry.digest:
            stored = self._entries.pop(chain, None)
            if stored is not None:
                self.bytes_used -= stored.nbytes
            self.corrupt_dropped += 1
            return None
        self._entries.pop(chain)
        self.bytes_used -= entry.nbytes
        self.readmits += 1
        return entry.leaves

    def peek(self, chain: bytes) -> Optional[Tuple[np.ndarray, ...]]:
        """Non-destructively read one entry's payload, integrity-checked —
        the cross-replica EXPORT path, where the tier doubles as a staging
        buffer: a demoted block can ship to another replica without being
        consumed locally (the entry stays resident for future local
        readmits). A digest mismatch drops the entry and returns None,
        exactly like :meth:`verify_readmit`, so a corrupt staged block can
        never leave this host. No chaos consult: the wire faults
        (``handoff.corrupt`` / ``handoff.slow``) fire on the RECEIVER,
        where degradation to recompute-resume is decided."""
        entry = self._entries.get(chain)
        if entry is None:
            return None
        if tier_digest(chain, entry.leaves) != entry.digest:
            self._entries.pop(chain, None)
            self.bytes_used -= entry.nbytes
            self.corrupt_dropped += 1
            return None
        return entry.leaves

    # -- invalidation ---------------------------------------------------------

    def clear(self) -> None:
        """Drop every entry — the device pages the tier's content derived
        from became untrustworthy (crash recovery re-zeroes the pool), so
        conservatively nothing demoted before the crash may re-admit."""
        self._entries.clear()
        self.bytes_used = 0

    # -- introspection --------------------------------------------------------

    def stats(self) -> dict:
        return {
            "tier_blocks": len(self._entries),
            "tier_bytes": self.bytes_used,
            "tier_max_bytes": self.max_bytes,
            "tier_demotions": self.demotions,
            "tier_demote_failures": self.demote_failures,
            "tier_readmits": self.readmits,
            "tier_corrupt_dropped": self.corrupt_dropped,
            "tier_evictions": self.evictions,
        }

    def check_invariants(self) -> None:
        """Byte accounting must match the entries exactly and respect the
        bound; raises ValueError on violation (leak detector for tests)."""
        actual = sum(e.nbytes for e in self._entries.values())
        if actual != self.bytes_used:
            raise ValueError(
                f"tier byte accounting drifted: tracked {self.bytes_used}, "
                f"actual {actual}")
        if self.bytes_used > self.max_bytes:
            raise ValueError(
                f"tier over budget: {self.bytes_used} > {self.max_bytes}")

    def keys(self) -> List[bytes]:
        """Chain keys currently resident (LRU order, oldest first)."""
        return list(self._entries.keys())

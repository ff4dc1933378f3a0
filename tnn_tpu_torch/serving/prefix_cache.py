"""Automatic prefix caching (``tnn_tpu.serving.prefix_cache``): a
content-addressed index of full KV blocks.

Requests that share a system prompt prefill the same tokens, and the KV at
position ``p`` depends only on tokens ``[0, p]``. Given a new prompt, the
index finds the pool blocks that already hold its prefix's KV; the engine
forks them into the request's table and chunk-prefills only the tail.

Keys form a rolling hash chain at full-block granularity::

    key(block 0) = H(ROOT_KEY   || tokens[0 : bs])
    key(block i) = H(key(i - 1) || tokens[i*bs : (i+1)*bs])

so block ``i``'s key commits to the whole prefix. ``H`` is blake2b-128 over
the int32 token bytes, byte for byte the JAX package's keys, so the two
packages (and replicas of either) address the same content alike. Only
FULL blocks are indexed: once prefill has written all ``block_size``
positions of a block its content is immutable.

The index holds no reference of its own. When the last holder frees an
indexed block, ``PagedKVPool.free`` parks it in the pool's evictable LRU
(``evictable_filter`` = :meth:`PrefixCache.contains_block`); when the pool
reclaims it under pressure, ``reclaim_hook`` = :meth:`PrefixCache.
drop_blocks` unindexes it. The cache never shrinks the pool's capacity.

Under sequence parallelism block ``i`` of a chain was allocated for table
position ``i`` and so already lives on that position's owner shard: a hit
forks blocks that sit on the right shards. The engine's copy-on-write
clone is allocated on its source's shard.
"""
from __future__ import annotations

import hashlib
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

#: chain seed for block 0
ROOT_KEY = b"tnn-prefix-root"


def block_key(prev_key: bytes, tokens: np.ndarray) -> bytes:
    """One link of the chain: commits to ``prev_key`` and this block's
    tokens."""
    h = hashlib.blake2b(digest_size=16)
    h.update(prev_key)
    h.update(np.ascontiguousarray(tokens, np.int32).tobytes())
    return h.digest()


def chain_keys(tokens: Sequence[int], block_size: int) -> List[bytes]:
    """Chain keys of every FULL block of ``tokens`` (a partial tail has no
    key until it fills)."""
    toks = np.asarray(tokens, np.int32).reshape(-1)
    keys, key = [], ROOT_KEY
    for i in range(len(toks) // block_size):
        key = block_key(key, toks[i * block_size:(i + 1) * block_size])
        keys.append(key)
    return keys


class PrefixCache:
    """Content-addressed full-block index over one ``PagedKVPool``: host
    bookkeeping only, it never touches pages. ``min_hit_blocks`` ignores
    matches shorter than that many blocks."""

    def __init__(self, block_size: int, min_hit_blocks: int = 1):
        if block_size < 1:
            raise ValueError(f"block_size must be >= 1, got {block_size}")
        if min_hit_blocks < 1:
            raise ValueError(
                f"min_hit_blocks must be >= 1, got {min_hit_blocks}")
        self.block_size = int(block_size)
        self.min_hit_blocks = int(min_hit_blocks)
        self._index: Dict[bytes, int] = {}     # chain key -> pool block id
        self._key_of: Dict[int, bytes] = {}    # pool block id -> chain key

    def __len__(self) -> int:
        return len(self._index)

    def contains_block(self, block: int) -> bool:
        """Is this pool block indexed? (The pool's ``evictable_filter``.)"""
        return block in self._key_of

    def contains_key(self, key: bytes) -> bool:
        """Is this chain key device-resident? (The host tier's readmit walk
        skips keys the index already covers.)"""
        return key in self._index

    def key_of(self, block: int) -> Optional[bytes]:
        """The chain key a pool block is indexed under, or None. The pool's
        ``demote_hook`` runs before ``reclaim_hook``, so at demote time this
        still names every reclaimed block."""
        return self._key_of.get(block)

    def block_of(self, key: bytes) -> Optional[int]:
        """The pool block a chain key is indexed at, or None (the export
        half of a cross-replica handoff reads pages by key)."""
        return self._index.get(key)

    def keys(self) -> List[bytes]:
        """Every device-resident chain key (the fleet directory's view of
        what this replica can export)."""
        return list(self._index.keys())

    def chain_keys(self, tokens: Sequence[int]) -> List[bytes]:
        """Chain keys of every FULL block of ``tokens``."""
        return chain_keys(tokens, self.block_size)

    def probe(self, tokens: Sequence[int]) -> Tuple[List[int], int, bool]:
        """Longest cached prefix of ``tokens`` at full-block granularity:
        ``(blocks, cached_len, cow)``.

        ``blocks`` are the matched chain's pool blocks in table order (empty
        below ``min_hit_blocks``); ``cached_len`` the positions they cover,
        capped at ``len(tokens) - 1`` because a fully cached prompt still
        recomputes its last token for the first-token logits; ``cow`` is
        True when that cap applied: the recomputed token writes INSIDE
        ``blocks[-1]``, which the engine must clone first. Read-only."""
        toks = np.asarray(tokens, np.int32).reshape(-1)
        total = len(toks)
        bs = self.block_size
        blocks: List[int] = []
        key = ROOT_KEY
        for i in range(total // bs):
            key = block_key(key, toks[i * bs:(i + 1) * bs])
            b = self._index.get(key)
            if b is None:
                break
            blocks.append(b)
        if len(blocks) < self.min_hit_blocks:
            return [], 0, False
        cached = len(blocks) * bs
        cow = cached >= total
        if cow:
            cached = total - 1
        return blocks, cached, cow

    def publish(self, tokens: Sequence[int], block_table: Sequence[int],
                cached_len: int) -> int:
        """Index every full block among the first ``cached_len`` resident
        positions of ``tokens`` (the request's resume sequence) under its
        table. First publisher wins: an indexed key keeps its block, and a
        block already serving another chain is skipped. Returns the number
        of newly indexed blocks."""
        toks = np.asarray(tokens, np.int32).reshape(-1)
        bs = self.block_size
        added = 0
        key = ROOT_KEY
        for i in range(min(cached_len, len(toks)) // bs):
            key = block_key(key, toks[i * bs:(i + 1) * bs])
            if key in self._index:
                continue
            blk = int(block_table[i])
            if blk in self._key_of:
                continue
            self._index[key] = blk
            self._key_of[blk] = key
            added += 1
        return added

    def adopt(self, key: bytes, block: int) -> bool:
        """Index one block directly under a known chain key (a block whose
        content arrived from elsewhere). Same first-publisher-wins rule as
        :meth:`publish`; returns False when the key or the block is
        taken."""
        if key in self._index or block in self._key_of:
            return False
        self._index[key] = block
        self._key_of[block] = key
        return True

    def drop_blocks(self, blocks: Iterable[int]) -> None:
        """Unindex reclaimed blocks (the pool's ``reclaim_hook``); unknown
        ids are ignored."""
        for b in blocks:
            key = self._key_of.pop(b, None)
            if key is not None:
                self._index.pop(key, None)

    def clear(self) -> None:
        """Drop the whole index (the pages' content became invalid)."""
        self._index.clear()
        self._key_of.clear()

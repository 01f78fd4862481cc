"""Paged KV-cache block allocator (host side) for the PyTorch port.

A copy of the reference's ``core/paging.py`` free-list half: the pool
geometry (``PagingConfig``), the refcounted LIFO ``BlockAllocator``, the
occupancy snapshot (``FragmentationStats``) and ``blocks_for_tokens``.
Pure Python, no torch.  The prefix-sharing trie (``PrefixCache``) is
ported with the prefix cache (ROADMAP.md Queue 1 item 9).

Block 0 is the **null block**: never handed out, it absorbs the writes
of idle slots and dead chunk lanes inside the fused step and backs
unallocated block-table entries, so the device step needs no host
intervention to stay safe.
"""
from __future__ import annotations

import dataclasses


NULL_BLOCK = 0


def blocks_for_tokens(num_tokens: int, block_size: int) -> int:
    """Blocks needed to hold ``num_tokens`` cache positions."""
    return max(-(-num_tokens // block_size), 0)


@dataclasses.dataclass(frozen=True)
class PagingConfig:
    """Pool geometry (the 'synthesis parameters' of the KV memory).

    ``num_blocks`` counts *usable* blocks; the null block is allocated
    on top of it, so the pool arrays have ``num_blocks + 1`` rows.
    """

    block_size: int = 16
    num_blocks: int = 0

    def __post_init__(self):
        if self.block_size <= 0:
            raise ValueError(f"block_size must be positive, got {self.block_size}")
        if self.num_blocks <= 0:
            raise ValueError(f"num_blocks must be positive, got {self.num_blocks}")

    @property
    def pool_blocks(self) -> int:
        """Physical rows in the pool arrays (usable blocks + null block)."""
        return self.num_blocks + 1


@dataclasses.dataclass(frozen=True)
class FragmentationStats:
    """Pool occupancy + internal fragmentation snapshot.

    With prefix caching on, ``used_blocks`` counts *physical* residency:
    a block mapped by three requests counts once (it is ``shared``), and
    a block kept only by the prefix trie at refcount zero still occupies
    the pool (``cached``) until LRU eviction reclaims it.
    """

    total_blocks: int
    free_blocks: int
    used_blocks: int
    # tokens actually resident vs token capacity of the allocated blocks:
    # the gap is internal fragmentation (tail of each slot's last block)
    used_tokens: int
    capacity_tokens: int
    # blocks mapped by >1 request (refcount >= 2)
    shared_blocks: int = 0
    # unreferenced blocks parked in the prefix trie (refcount == 0,
    # not on the free list) — reclaimable by LRU eviction
    cached_blocks: int = 0

    @property
    def utilization(self) -> float:
        """Fraction of the pool's usable blocks currently allocated."""
        return self.used_blocks / max(self.total_blocks, 1)

    @property
    def internal_fragmentation(self) -> float:
        """Wasted fraction *inside* allocated blocks (0 when empty)."""
        if self.capacity_tokens == 0:
            return 0.0
        return 1.0 - self.used_tokens / self.capacity_tokens


class BlockAllocator:
    """Free-list allocator over the paged KV pool (host side).

    LIFO free list: a just-freed block is the next handed out, which
    keeps the hot region of the pool small (HBM page locality).
    """

    def __init__(self, config: PagingConfig):
        self.config = config
        # block 0 is the null block and never enters the free list
        self._free: list[int] = list(range(config.pool_blocks - 1, 0, -1))
        # persistent mirror of _free so the double-free check in free()
        # is O(len(blocks)), not O(pool) per call
        self._free_set: set[int] = set(self._free)
        # per-block reference counts; free blocks and the null block sit
        # at 0, alloc hands blocks out at 1, prefix sharing increfs
        self._refs: list[int] = [0] * config.pool_blocks
        self._used_tokens = 0  # engine-reported resident tokens

    @property
    def num_free(self) -> int:
        return len(self._free)

    @property
    def num_used(self) -> int:
        return self.config.num_blocks - len(self._free)

    def can_alloc(self, n: int) -> bool:
        return n <= len(self._free)

    def alloc(self, n: int) -> list[int] | None:
        """Pop ``n`` blocks at refcount 1, or None (and no change) if
        unavailable."""
        if n < 0:
            raise ValueError(f"cannot allocate {n} blocks")
        if n > len(self._free):
            return None
        taken = self._free[len(self._free) - n:]
        del self._free[len(self._free) - n:]
        for b in taken:
            self._free_set.discard(b)
            self._refs[b] = 1
        return taken[::-1]

    def ref(self, block: int) -> int:
        """Current reference count of ``block``."""
        return self._refs[block]

    def incref(self, blocks: list[int]) -> None:
        """Map already-resident blocks into one more request."""
        for b in blocks:
            if not 0 < b < self.config.pool_blocks:
                raise ValueError(f"block id {b} outside pool")
            if b in self._free_set:
                raise ValueError(f"incref of free block {b}")
            self._refs[b] += 1

    def decref(self, blocks: list[int]) -> list[int]:
        """Drop one reference per block; returns the blocks that hit
        refcount zero (in input order).  Does NOT free them — the caller
        routes zeros through the prefix cache's ``park`` (trie-resident
        blocks stay for reuse) and ``free``s the remainder."""
        zeros: list[int] = []
        for b in blocks:
            if not 0 < b < self.config.pool_blocks:
                raise ValueError(f"block id {b} outside pool")
            if self._refs[b] <= 0:
                raise ValueError(f"decref of unreferenced block {b}")
            self._refs[b] -= 1
            if self._refs[b] == 0:
                zeros.append(b)
        return zeros

    def truncate(self, blocks: list[int], keep: int) -> \
            tuple[list[int], list[int]]:
        """Block-tail truncate — the speculative-rollback release.

        Drops this request's reference on ``blocks[keep:]`` and returns
        ``(kept, zeros)``: the retained head and the tail blocks whose
        refcount hit zero, in tail order.  Like :meth:`decref`, nothing
        is freed here — the caller routes ``zeros`` through
        ``PrefixCache.park`` (a trie-owned tail block parks, never
        frees) and ``free``s the remainder.  A tail block another
        request still maps just loses one reference and stays resident.
        """
        if keep < 0:
            raise ValueError(f"cannot keep {keep} blocks")
        if keep >= len(blocks):
            return list(blocks), []
        return list(blocks[:keep]), self.decref(blocks[keep:])

    def free(self, blocks: list[int]) -> None:
        """Return blocks to the free list.  Accepts refcount <= 1 (the
        sole owner may free directly, skipping decref); freeing a block
        other requests still map is an error."""
        for b in blocks:
            if not 0 < b < self.config.pool_blocks:
                raise ValueError(f"block id {b} outside pool")
            if b in self._free_set:
                raise ValueError(f"double free of block {b}")
            if self._refs[b] > 1:
                raise ValueError(
                    f"freeing block {b} with refcount {self._refs[b]} "
                    "(still mapped by another request — decref instead)")
            self._refs[b] = 0
            self._free_set.add(b)
        self._free.extend(reversed(blocks))

    def set_used_tokens(self, n: int) -> None:
        """Engine hook: tokens currently resident across all slots."""
        self._used_tokens = n

    def stats(self) -> FragmentationStats:
        cfg = self.config
        used = self.num_used
        shared = sum(1 for r in self._refs if r >= 2)
        cached = sum(1 for b in range(1, cfg.pool_blocks)
                     if self._refs[b] == 0 and b not in self._free_set)
        return FragmentationStats(
            total_blocks=cfg.num_blocks,
            free_blocks=self.num_free,
            used_blocks=used,
            used_tokens=self._used_tokens,
            capacity_tokens=used * cfg.block_size,
            shared_blocks=shared,
            cached_blocks=cached)

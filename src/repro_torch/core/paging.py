"""Paged KV-cache block allocator and prefix trie (host side) for the
PyTorch port.

A copy of the reference's ``core/paging.py``: the pool geometry
(``PagingConfig``), the refcounted LIFO ``BlockAllocator``, the occupancy
snapshot (``FragmentationStats``), ``blocks_for_tokens``, and the
prefix-sharing radix trie (``PrefixCache``, with ``PrefixHit``) whose
nodes each own one pool block of ``block_size`` prompt tokens; blocks at
refcount zero stay parked in the trie as an LRU eviction tier.  Pure
Python, no torch.

Block 0 is the **null block**: never handed out, it absorbs the writes
of idle slots and dead chunk lanes inside the fused step and backs
unallocated block-table entries, so the device step needs no host
intervention to stay safe.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Hashable


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


class _TrieNode:
    """One block-granule of cached prompt: ``block_size`` tokens and the
    physical block holding their KV."""

    __slots__ = ("chain", "tokens", "block", "parent", "children", "tick")

    def __init__(self, chain: int, tokens: tuple[int, ...], block: int,
                 parent: "Any"):
        self.chain = chain          # rolling hash up to and incl. this node
        self.tokens = tokens        # verified on every walk
        self.block = block
        self.parent = parent        # _TrieNode | namespace-root sentinel
        self.children: dict[int, _TrieNode] = {}
        self.tick = 0               # LRU stamp while parked


class _Root:
    """Per-namespace virtual root (no block of its own)."""

    __slots__ = ("chain", "children")

    def __init__(self, namespace: Hashable):
        self.chain = hash(("prefix-cache-ns", namespace))
        self.children: dict[int, _TrieNode] = {}


@dataclasses.dataclass
class PrefixHit:
    """Result of a trie lookup: the cached span a request may map.

    ``blocks`` are whole cached blocks (``len(blocks) * block_size``
    tokens reusable as-is); ``fork_block``/``fork_tokens`` describe a
    trailing partial match whose first ``fork_tokens`` rows must be
    copy-on-write forked into a private block before the request may
    write the remainder.
    """

    blocks: list[int]
    tokens: int
    fork_block: int | None = None
    fork_tokens: int = 0
    nodes: list = dataclasses.field(default_factory=list)
    fork_node: Any = None

    @property
    def cached_tokens(self) -> int:
        return self.tokens + self.fork_tokens


class PrefixCache:
    """Radix trie over token-block hashes + LRU tier of parked blocks.

    Pure host-side bookkeeping, same contract as the allocator: no
    torch, no device access.  The engine owns when to ``lookup``/``acquire``
    (admission), ``insert`` (prefill completion), ``park`` (release
    decref hit zero) and ``evict`` (pool ran dry).
    """

    def __init__(self, allocator: BlockAllocator):
        self.allocator = allocator
        self.block_size = allocator.config.block_size
        self._roots: dict[Hashable, _Root] = {}
        self._node_of_block: dict[int, _TrieNode] = {}
        self._parked: dict[int, _TrieNode] = {}   # block -> node, ref==0
        self._tick = 0
        self.evictions = 0

    # -- introspection -------------------------------------------------
    @property
    def num_nodes(self) -> int:
        return len(self._node_of_block)

    @property
    def num_parked(self) -> int:
        return len(self._parked)

    def owns(self, block: int) -> bool:
        return block in self._node_of_block

    def _next_tick(self) -> int:
        self._tick += 1
        return self._tick

    def _root(self, namespace: Hashable) -> _Root:
        root = self._roots.get(namespace)
        if root is None:
            root = self._roots[namespace] = _Root(namespace)
        return root

    @staticmethod
    def _key(chain: int, tokens: tuple[int, ...]) -> int:
        return hash((chain, tokens))

    # -- admission side ------------------------------------------------
    def lookup(self, namespace: Hashable, tokens: list[int],
               limit: int | None = None) -> PrefixHit:
        """Longest cached prefix of ``tokens`` (capped at ``limit``).

        Walks whole-block children first, then scans the final node's
        children for the longest partial token match (the CoW fork
        source).  Never mutates refcounts — pair with :meth:`acquire`.
        """
        bs = self.block_size
        limit = len(tokens) if limit is None else min(limit, len(tokens))
        node: Any = self._root(namespace)
        hit = PrefixHit(blocks=[], tokens=0)
        i = 0
        while i + bs <= limit:
            chunk = tuple(tokens[i:i + bs])
            child = node.children.get(self._key(node.chain, chunk))
            if child is None or child.tokens != chunk:
                break
            hit.blocks.append(child.block)
            hit.nodes.append(child)
            node = child
            i += bs
        hit.tokens = i
        # partial tail: longest common prefix with any child, >= 1 token
        rem = limit - i
        if rem > 0:
            best, best_len = None, 0
            for child in node.children.values():
                k = 0
                for a, b in zip(child.tokens, tokens[i:i + rem]):
                    if a != b:
                        break
                    k += 1
                if k > best_len:
                    best, best_len = child, k
            if best is not None and best_len >= 1:
                hit.fork_block = best.block
                hit.fork_tokens = best_len
                hit.fork_node = best
        return hit

    def acquire(self, hit: PrefixHit) -> None:
        """Pin a hit before any allocation that could evict: incref all
        matched blocks (the fork source too — it must survive until the
        CoW copy lands) and unpark their nodes from the LRU tier."""
        blocks = list(hit.blocks)
        if hit.fork_block is not None:
            blocks.append(hit.fork_block)
        self.allocator.incref(blocks)
        tick = self._next_tick()
        for node in [*hit.nodes, *([hit.fork_node] if hit.fork_node else [])]:
            node.tick = tick
            self._parked.pop(node.block, None)

    def release(self, hit: PrefixHit) -> None:
        """Roll back an :meth:`acquire` (admission failed mid-way)."""
        blocks = list(hit.blocks)
        if hit.fork_block is not None:
            blocks.append(hit.fork_block)
        self.park(self.allocator.decref(blocks))

    def drop_fork_source(self, hit: PrefixHit) -> None:
        """Release just the fork source once its rows are copied."""
        if hit.fork_block is not None:
            self.park(self.allocator.decref([hit.fork_block]))

    # -- registration / release side -----------------------------------
    def insert(self, namespace: Hashable, tokens: list[int],
               blocks: list[int]) -> int:
        """Register a prefilled prompt's whole blocks: ``blocks[j]``
        holds KV for ``tokens[j*bs:(j+1)*bs]``.  An existing node always
        wins (its KV is identical by construction) and the caller's
        duplicate block simply stays slot-private; new nodes take
        ownership of the caller's block (which keeps its current
        refcount — the registering slot still maps it).  Returns the
        number of newly registered blocks."""
        bs = self.block_size
        node: Any = self._root(namespace)
        added = 0
        for j, block in enumerate(blocks):
            chunk = tuple(tokens[j * bs:(j + 1) * bs])
            if len(chunk) != bs:
                break
            key = self._key(node.chain, chunk)
            child = node.children.get(key)
            if child is not None:
                if child.tokens != chunk:
                    break  # hash collision: skip registration, never alias
                node = child
                continue
            if block in self._node_of_block:
                break  # block already registered under another path
            child = _TrieNode(self._key(node.chain, chunk), chunk, block, node)
            node.children[key] = child
            self._node_of_block[block] = child
            node = child
            added += 1
        return added

    def park(self, blocks: list[int]) -> list[int]:
        """Route decref-to-zero blocks: trie-owned ones stay resident as
        parked LRU entries; returns the rest for ``allocator.free``."""
        remainder: list[int] = []
        tick = self._next_tick()
        for b in blocks:
            node = self._node_of_block.get(b)
            if node is None:
                remainder.append(b)
            else:
                node.tick = tick
                self._parked[b] = node
        return remainder

    # -- eviction ------------------------------------------------------
    def evict(self, n: int) -> int:
        """Free up to ``n`` parked blocks, least recently used first,
        leaves before parents (a node with children anchors its
        subtree's chain and is skipped until they go).  May free fewer
        than ``n``; the caller falls back to preemption."""
        freed = 0
        while freed < n:
            victims = sorted(
                (node for node in self._parked.values()
                 if not node.children),
                key=lambda nd: nd.tick)
            if not victims:
                break
            for node in victims:
                if freed >= n:
                    break
                self._unlink(node)
                self.allocator.free([node.block])
                freed += 1
                self.evictions += 1
        return freed

    def _unlink(self, node: _TrieNode) -> None:
        parent = node.parent
        key = self._key(parent.chain, node.tokens)
        if parent.children.get(key) is node:
            del parent.children[key]
        self._parked.pop(node.block, None)
        self._node_of_block.pop(node.block, None)

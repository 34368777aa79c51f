"""Host-side prefix cache — port of ``repro/serving/prefix.py``: a trie of
slab-aligned token blocks (DESIGN.md §10).

Serving fleets share long prompt prefixes (system prompts, few-shot
templates, multi-turn history).  The slab arena already gives every sequence
an *indirect* page table of slab ids, so two sequences with a common prefix
can point at the same physical slabs at zero kernel cost — sharing is pure
page-table aliasing.  This module is the admission-time index that finds
those slabs:

* **Keying** — the trie descends one node per full ``slab_tokens``-sized
  block of the prompt; only *full* blocks are cached (a partially-filled
  slab is still being written by its owner, so it can never be safely
  shared).  Each edge is keyed by a **truncated hash** of the block's
  tokens (``hash_bits`` of a blake2b digest) for O(1) child lookup, with
  the block's exact tokens stored on the node.
* **Collision safety** — a hash hit is never trusted: every candidate
  node's stored tokens are compared to the query block before descending,
  so two blocks that collide in the truncated hash can coexist (they hang
  off the same edge key) and a lookup can never alias the wrong slab.
* **Reference counting** — the trie holds exactly one
  :meth:`~repro_torch.pool.planner.SlabAllocator.addref` reference per cached
  node.  A match additionally pins the returned slabs (the caller takes
  page-table references), so a cached slab's refcount is always
  ``1 (trie) + #page tables aliasing it``.
* **Eviction** — under pool pressure (:meth:`evict`), least-recently-used
  *leaf* nodes whose slab refcount is 1 (held only by the trie) are
  released back to the free list.  Evicting leaves first preserves the
  prefix property: a cached block is only reachable through cached
  ancestors, so the trie never serves a suffix without its prefix.
"""
from __future__ import annotations

import collections
import hashlib
from typing import Iterable, Sequence

import numpy as np

from repro_torch.obs import ServingTimeline

__all__ = ["PrefixCache", "block_hash"]


def block_hash(tokens: Sequence[int], bits: int) -> int:
    """Deterministic truncated hash of a token block (``bits`` low bits of
    a blake2b digest).  Process-stable, unlike Python's salted ``hash``."""
    digest = hashlib.blake2b(
        np.asarray(tokens, np.int64).tobytes(), digest_size=8
    ).digest()
    return int.from_bytes(digest, "little") & ((1 << bits) - 1)


class _Node:
    __slots__ = ("tokens", "slab", "key", "parent", "children")

    def __init__(self, tokens: tuple, slab: int, key: int, parent):
        self.tokens = tokens  # the block's exact tokens (collision guard)
        self.slab = slab  # pool slab id holding this block's K/V
        self.key = key  # truncated hash — the edge key under parent
        self.parent = parent
        self.children: dict[int, list[_Node]] = {}


class PrefixCache:
    """Trie of full-slab prompt prefixes → slab ids, over one allocator."""

    def __init__(
        self,
        alloc,
        *,
        slab_tokens: int,
        hash_bits: int = 24,
        obs: ServingTimeline | None = None,
    ):
        if slab_tokens < 1 or hash_bits < 1:
            raise ValueError(f"need positive slab_tokens/hash_bits, got "
                             f"{slab_tokens}/{hash_bits}")
        self.alloc = alloc
        self.T = slab_tokens
        self.hash_bits = hash_bits
        self.obs = obs
        self.root = _Node((), -1, -1, None)
        # LRU order over cached nodes: oldest first, touch = move_to_end.
        self._lru: collections.OrderedDict[_Node, None] = collections.OrderedDict()

    def __len__(self) -> int:
        return len(self._lru)

    # ---- internals -------------------------------------------------------
    def _blocks(self, tokens: Sequence[int]) -> Iterable[tuple]:
        for j in range(len(tokens) // self.T):
            yield tuple(tokens[j * self.T : (j + 1) * self.T])

    def _find(self, node: _Node, block: tuple) -> _Node | None:
        for cand in node.children.get(block_hash(block, self.hash_bits), ()):
            if cand.tokens == block:  # verify: never trust the hash alone
                return cand
        return None

    def _touch(self, node: _Node) -> None:
        self._lru[node] = None
        self._lru.move_to_end(node)

    def _remove(self, node: _Node) -> None:
        siblings = node.parent.children[node.key]
        siblings.remove(node)
        if not siblings:
            del node.parent.children[node.key]
        del self._lru[node]

    # ---- queries ---------------------------------------------------------
    def cached_slabs(self) -> list[int]:
        """Every slab id the trie currently holds a reference on."""
        return [n.slab for n in self._lru]

    # ---- the admission path ----------------------------------------------
    def match(self, tokens: Sequence[int]) -> tuple[int, np.ndarray]:
        """Longest cached full-slab prefix of ``tokens`` → (blocks, ids).

        Pure lookup: the caller pins the returned slabs (``alloc.addref``)
        before anything that could evict runs.  Matched nodes are touched
        to the MRU end, so concurrent pressure evicts cold entries first.
        """
        node, ids = self.root, []
        for block in self._blocks(tokens):
            child = self._find(node, block)
            if child is None:
                break
            ids.append(child.slab)
            self._touch(child)
            node = child
        return len(ids), np.asarray(ids, np.int32)

    def publish(self, tokens: Sequence[int], page_ids: Sequence[int]) -> int:
        """Cache every full-slab block of a completed prompt → new nodes.

        ``page_ids`` is the sequence's page table (slab id per page); block
        ``j`` lives in slab ``page_ids[j]``.  New nodes take one trie
        reference on their slab; blocks already cached keep the existing
        slab (the duplicate stays with its owner and is released normally).
        """
        node, new = self.root, 0
        for j, block in enumerate(self._blocks(tokens)):
            child = self._find(node, block)
            if child is None:
                slab = int(page_ids[j])
                self.alloc.addref(np.asarray([slab], np.int32))
                child = _Node(block, slab, block_hash(block, self.hash_bits), node)
                node.children.setdefault(child.key, []).append(child)
                new += 1
            self._touch(child)
            node = child
        if new and self.obs is not None:
            self.obs.event("prefix_publish", blocks=new, cached=len(self._lru))
        return new

    def evict(self, want: int) -> np.ndarray:
        """Free up to ``want`` LRU unreferenced cached slabs → freed ids.

        Only leaves whose slab refcount is 1 (the trie's own reference) are
        evictable: interior nodes anchor cached suffixes, and a slab some
        page table still aliases must survive.  Cascades — a parent whose
        last child was evicted becomes a leaf and is considered on the next
        pass.
        """
        freed: list[int] = []
        while len(freed) < want:
            victim = None
            for node in self._lru:  # oldest first
                if not node.children and int(self.alloc.refcount[node.slab]) == 1:
                    victim = node
                    break
            if victim is None:
                break
            self._remove(victim)
            freed.extend(
                int(s)
                for s in self.alloc.release(np.asarray([victim.slab], np.int32))
            )
        if freed and self.obs is not None:
            self.obs.registry.counter(
                "serve.prefix_evicted", "cached slabs evicted under pool pressure"
            ).inc(len(freed))
            self.obs.event("prefix_evict", slabs=len(freed), cached=len(self._lru))
        return np.asarray(freed, np.int32)

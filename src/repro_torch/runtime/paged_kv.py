"""Paged KV-cache bookkeeping: page pool, prefix cache, chunk schedule.

Counterpart of ``repro.runtime.paged_kv`` (numpy and plain Python, as
there; the port keeps its own copy and imports nothing of ``repro``).
The engine's slot caches become rows of an int32 **block table** over a
global **page pool** of fixed-size pages:

  * :class:`PageAllocator`: refcounted free list; physical page 0 is the
    *trash page* (dead-slot decode writes and empty block entries land
    there, every read through it is masked), never handed out or freed.
  * :class:`PrefixCache`: a trie over full prompt pages keyed on (parent,
    exact block tokens), so requests that share a prompt prefix map the
    same physical pages; leaf-first LRU eviction that never frees a page
    a live slot still holds.
  * a **chunk schedule** (:func:`chunk_plan`) that feeds long prompts
    through power-of-two chunk widths, one chunk per engine step.
  * :class:`PagedKV`: per-engine block-table rows, reservations, prefix
    hits and behind-window page release, mirrored on the host so
    admission and retirement never read the device.

The device side (gather, scatter, paged attention) lives in
``nn/attention.py``, ``kernels/paged_attn.py``, ``models/lm.py`` and
``models/encdec.py``. An encdec engine builds its ``PagedKV`` without a
prefix cache: its K/V depends on each request's frames, not only on
its tokens.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

TRASH_PAGE = 0  # reserved physical page: masked reads, garbage writes


def next_pow2(n: int) -> int:
    n = max(1, int(n))
    return 1 << (n - 1).bit_length()


def prefill_buckets(max_chunk: int, min_bucket: int = 16) -> Tuple[int, ...]:
    """The closed set of chunk widths the engine will ever run."""
    if max_chunk & (max_chunk - 1):
        raise ValueError(f"max_chunk must be a power of two, got {max_chunk}")
    b, out = min(min_bucket, max_chunk), []
    while b <= max_chunk:
        out.append(b)
        b *= 2
    return tuple(out)


def chunk_plan(length: int, start: int, max_chunk: int,
               min_bucket: int = 16) -> List[Tuple[int, int, int]]:
    """Split prompt positions [start, length) into bucketed chunks.

    Returns [(start, width, n_real), ...]: full ``max_chunk`` chunks
    followed by at most one padded chunk whose width is the smallest
    bucket covering the remainder. The workspace is sized
    ``>= 2 * next_pow2(max_len)`` (see ``workspace_len``) so
    ``start + width`` always fits even when the padded tail overhangs.
    """
    plan = []
    while length - start >= max_chunk:
        plan.append((start, max_chunk, max_chunk))
        start += max_chunk
    rem = length - start
    if rem > 0:
        plan.append((start, next_pow2(max(rem, min_bucket)), rem))
    return plan


def workspace_len(max_len: int, n_blocks: int, page_size: int) -> int:
    """Width of the fp prefill workspace.

    Must cover (a) the gathered pool width ``n_blocks * page_size`` so a
    prefix-hit hydrate fits, and (b) any ``start + chunk_width`` the
    schedule can produce. The padded tail chunk satisfies
    ``start + width <= length + rem <= 2 * max_len``, so doubling the
    pow2 envelope is always safe.
    """
    return max(n_blocks * page_size, 2 * next_pow2(max_len))


def kv_bytes_per_token(cfg) -> int:
    """KV bytes one token occupies across all attention layers."""
    itemsize = torch.empty((), dtype=cfg.dtype).element_size()
    per = 2 * cfg.n_kv_heads * cfg.resolved_head_dim
    if cfg.kv_cache_bits == 8 and cfg.family != "encdec":
        # int8 payload + bf16 per-entry scale (one scale per (token, head))
        return (per + 2 * cfg.n_kv_heads * 2) * cfg.n_layers
    return per * itemsize * cfg.n_layers


class PageAllocator:
    """Refcounted free-list allocator over ``n_pages`` physical pages.

    Page 0 is the trash page: permanently pinned, never handed out,
    never freed. ``alloc`` is all-or-nothing (returns None on
    shortfall) so a request can never hold a partial reservation.
    """

    def __init__(self, n_pages: int):
        if n_pages < 2:
            raise ValueError("need at least 2 pages (page 0 is reserved)")
        self.n_pages = int(n_pages)
        self.refs = np.zeros(self.n_pages, np.int32)
        self.refs[TRASH_PAGE] = 1  # pinned forever
        self._free: List[int] = list(range(self.n_pages - 1, 0, -1))

    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def pages_in_use(self) -> int:
        return (self.n_pages - 1) - len(self._free)

    def alloc(self, n: int) -> Optional[List[int]]:
        if n < 0:
            raise ValueError("alloc(n) needs n >= 0")
        if n > len(self._free):
            return None
        pages = [self._free.pop() for _ in range(n)]
        for p in pages:
            assert self.refs[p] == 0, f"free-list page {p} had refs"
            self.refs[p] = 1
        return pages

    def retain(self, page: int) -> None:
        if page == TRASH_PAGE:
            return
        assert self.refs[page] > 0, f"retain of unreferenced page {page}"
        self.refs[page] += 1

    def release(self, page: int) -> bool:
        """Drop one reference; returns True when the page went back to
        the pool (last holder released)."""
        if page == TRASH_PAGE:
            return False
        assert self.refs[page] > 0, f"double free of page {page}"
        self.refs[page] -= 1
        if self.refs[page] == 0:
            self._free.append(page)
            return True
        return False

    def fork_page(self, page: int) -> Optional[int]:
        """Copy-on-write: a writer that shares ``page`` gets a private
        page id to copy into (caller performs the device copy), and the
        shared original loses one ref. If the caller is already the sole
        holder the same page is returned (no copy needed)."""
        if page == TRASH_PAGE:
            raise ValueError("cannot fork the trash page")
        assert self.refs[page] > 0
        if self.refs[page] == 1:
            return page
        got = self.alloc(1)
        if got is None:
            return None
        self.release(page)
        return got[0]

    def check(self) -> None:
        """Invariant sweep (used by property tests)."""
        free = set(self._free)
        assert len(free) == len(self._free), "free list holds duplicates"
        assert TRASH_PAGE not in free
        for p in range(1, self.n_pages):
            # a page is free iff nobody holds a reference to it
            assert (p in free) == (self.refs[p] == 0), \
                f"page {p}: refs={self.refs[p]} free={p in free}"
        n_owned = sum(1 for p in range(1, self.n_pages) if self.refs[p] > 0)
        assert n_owned + len(free) == self.n_pages - 1


@dataclasses.dataclass
class _TrieNode:
    key: Tuple          # (parent id, block-token tuple) — exact, no hash risk
    page: int
    parent: Optional["_TrieNode"]
    n_children: int = 0
    stamp: int = 0      # LRU clock


class PrefixCache:
    """Hash-chain trie mapping full prompt pages to physical page ids.

    A node at depth ``i`` represents prompt tokens
    ``[i*page_size, (i+1)*page_size)`` *given* its parent chain — the
    trie key stores the exact block tokens, so equal chains are shared
    and distinct chains can never collide. The cache owns one reference
    per cached page; slots that hit add their own. Eviction is
    leaf-first LRU: interior nodes with live children are untouchable,
    and a freed node only returns its page to the pool when no slot
    still holds it (refcount > 1 just drops the cache's share).
    """

    def __init__(self, alloc: PageAllocator, page_size: int):
        self.alloc = alloc
        self.page_size = int(page_size)
        self._nodes: Dict[Tuple, _TrieNode] = {}
        self._clock = 0
        self.hits = 0        # pages served from cache
        self.queries = 0     # pages looked up
        self.insertions = 0
        self.evictions = 0

    def __len__(self) -> int:
        return len(self._nodes)

    def _tick(self) -> int:
        self._clock += 1
        return self._clock

    def match(self, tokens: Sequence[int]) -> List[int]:
        """Longest cached page chain for ``tokens``; caller must cap the
        hit so the last prompt token is always recomputed. Retains one
        ref per returned page on the caller's behalf and bumps LRU."""
        tokens = [int(t) for t in tokens]
        n_full = len(tokens) // self.page_size
        pages, parent_id = [], None
        for i in range(n_full):
            blk = tuple(tokens[i * self.page_size:(i + 1) * self.page_size])
            self.queries += 1
            node = self._nodes.get((parent_id, blk))
            if node is None:
                break
            self.hits += 1
            node.stamp = self._tick()
            self.alloc.retain(node.page)
            pages.append(node.page)
            parent_id = id(node)
        return pages

    def probe(self, tokens: Sequence[int]) -> int:
        """Length (in pages) of the cached chain ``match`` would return,
        with NO side effects: no refcounts taken, no LRU bump, no
        hit/query accounting. Admission planning (prefill packing) uses
        this to size a group before committing any reservation."""
        tokens = [int(t) for t in tokens]
        n_full = len(tokens) // self.page_size
        n, parent_id = 0, None
        for i in range(n_full):
            blk = tuple(tokens[i * self.page_size:(i + 1) * self.page_size])
            node = self._nodes.get((parent_id, blk))
            if node is None:
                break
            n += 1
            parent_id = id(node)
        return n

    def insert(self, tokens: Sequence[int], pages: Sequence[int]) -> None:
        """Cache ``pages[i]`` as the page for full prompt block ``i``.

        Only full pages are cached (the tail block of a prompt keeps
        growing during decode, so it is never shareable). The cache
        retains each newly-cached page."""
        tokens = [int(t) for t in tokens]
        n_full = min(len(tokens) // self.page_size, len(pages))
        parent, parent_id = None, None
        for i in range(n_full):
            blk = tuple(tokens[i * self.page_size:(i + 1) * self.page_size])
            key = (parent_id, blk)
            node = self._nodes.get(key)
            if node is None:
                node = _TrieNode(key=key, page=int(pages[i]), parent=parent,
                                 stamp=self._tick())
                self._nodes[key] = node
                self.alloc.retain(node.page)
                if parent is not None:
                    parent.n_children += 1
                self.insertions += 1
            else:
                node.stamp = self._tick()
            parent, parent_id = node, id(node)

    def evict(self, n_pages_needed: int) -> int:
        """Drop LRU leaves until the allocator can cover
        ``n_pages_needed`` frees-worth of demand (or the trie is empty).
        Returns the number of nodes evicted. Dropping a node releases
        the cache's ref — the page only reaches the free list when no
        slot still references it, so eviction can never free live data.
        """
        evicted = 0
        while self.alloc.n_free < n_pages_needed and self._nodes:
            leaf = min((n for n in self._nodes.values() if n.n_children == 0),
                       key=lambda n: n.stamp, default=None)
            if leaf is None:  # cycle-free trie always has a leaf; be safe
                break
            del self._nodes[leaf.key]
            if leaf.parent is not None:
                leaf.parent.n_children -= 1
            self.alloc.release(leaf.page)
            evicted += 1
        self.evictions += evicted
        return evicted

    def clear(self) -> None:
        for node in self._nodes.values():
            self.alloc.release(node.page)
        self._nodes.clear()

    @property
    def hit_rate(self) -> float:
        return self.hits / self.queries if self.queries else 0.0


class PagedKV:
    """Per-engine paged-KV bookkeeping: block-table rows, reservations,
    prefix-cache integration and behind-window page release.

    Device state (the pool itself, the int32 block table, per-slot
    lengths) lives in the engine's cache pytree; this object mirrors the
    block table on the host so admission/retire never sync the device.
    """

    def __init__(self, n_pages: int, page_size: int, n_blocks: int,
                 capacity: int, *, prefix_cache: bool = True):
        if page_size & (page_size - 1):
            raise ValueError(f"page_size must be a power of two, got "
                             f"{page_size}")
        self.page_size = int(page_size)
        self.n_blocks = int(n_blocks)
        self.alloc = PageAllocator(n_pages)
        self.prefix = PrefixCache(self.alloc, page_size) if prefix_cache \
            else None
        # per-slot: list of owned page ids (logical block order), prompt
        # hit length in tokens, host-tracked live length
        self.rows: List[Optional[List[int]]] = [None] * capacity
        self.hit_tokens: List[int] = [0] * capacity
        self.lens: List[int] = [0] * capacity
        self.pages_peak = 0

    def n_pages_for(self, total_tokens: int) -> int:
        return -(-int(total_tokens) // self.page_size)

    def peek(self, tokens: Sequence[int]) -> int:
        """Prospective prefix-hit length in TOKENS for ``tokens``,
        without reserving anything — the same cap ``admit`` applies (the
        page holding the last prompt token is never hit, so its logits
        are recomputed). Pure: repeated peeks don't perturb LRU order or
        hit-rate stats."""
        if self.prefix is None or tokens is None:
            return 0
        n = self.prefix.probe(tokens)
        return min(n, (len(tokens) - 1) // self.page_size) * self.page_size

    def admit(self, slot: int, tokens: Sequence[int], total_tokens: int):
        """Reserve pages for a request (prompt + budgeted new tokens).

        Returns ``(row, n_hit_tokens)`` or None when the pool cannot
        cover the reservation even after evicting cold prefixes. ``row``
        is the full (n_blocks,) int32 block row (unused tail = trash).
        """
        assert self.rows[slot] is None, f"slot {slot} already owns pages"
        n_need = self.n_pages_for(total_tokens)
        if n_need > self.n_blocks:
            raise ValueError(f"request needs {n_need} pages > block table "
                             f"width {self.n_blocks}")
        hit: List[int] = []
        if self.prefix is not None and tokens is not None:
            hit = self.prefix.match(tokens)
            # the last prompt token must be recomputed (its logits seed
            # sampling), so never hit the page containing it
            cap = (len(tokens) - 1) // self.page_size
            while len(hit) > cap:
                self.alloc.release(hit.pop())
        n_new = n_need - len(hit)
        if self.alloc.n_free < n_new and self.prefix is not None:
            self.prefix.evict(n_new)
        fresh = self.alloc.alloc(n_new)
        if fresh is None:
            for p in hit:
                self.alloc.release(p)
            return None
        pages = hit + fresh
        self.rows[slot] = pages
        self.hit_tokens[slot] = len(hit) * self.page_size
        self.lens[slot] = 0
        row = np.zeros(self.n_blocks, np.int32)
        row[:len(pages)] = pages
        self.pages_peak = max(self.pages_peak, self.alloc.pages_in_use)
        return row, self.hit_tokens[slot]

    def insert_prefix(self, slot: int, tokens: Sequence[int]) -> None:
        """After prefill completes, publish the slot's full prompt pages
        into the prefix cache (decode tokens are never published)."""
        if self.prefix is None or self.rows[slot] is None:
            return
        self.prefix.insert(tokens, self.rows[slot])

    def release_slot(self, slot: int) -> None:
        row = self.rows[slot]
        if row is None:
            return
        for p in row:
            self.alloc.release(p)
        self.rows[slot] = None
        self.hit_tokens[slot] = 0
        self.lens[slot] = 0

    def release_behind_window(self, slot: int,
                              window: int) -> List[int]:
        """Free pages that have slid fully behind the attention window.

        Returns the logical block indices freed so the engine can zero
        the device block row (future reads are masked anyway; zeroing
        routes dead-slot decode writes to the trash page). Block ``j``
        is dead once ``(j+1)*page_size <= len - window``.
        """
        row = self.rows[slot]
        if row is None or window is None:
            return []
        dead_before = self.lens[slot] - window
        freed = []
        for j, p in enumerate(row):
            if p == TRASH_PAGE:
                continue
            if (j + 1) * self.page_size <= dead_before:
                self.alloc.release(p)
                row[j] = TRASH_PAGE
                freed.append(j)
        return freed

    def stats(self) -> Dict[str, float]:
        out = {
            "kv_pages": self.alloc.n_pages,
            "page_size": self.page_size,
            "pages_in_use": self.alloc.pages_in_use,
            "pages_peak": self.pages_peak,
        }
        if self.prefix is not None:
            out.update(prefix_nodes=len(self.prefix),
                       prefix_hits=self.prefix.hits,
                       prefix_queries=self.prefix.queries,
                       prefix_hit_rate=self.prefix.hit_rate,
                       prefix_evictions=self.prefix.evictions)
        return out

"""Host-side page allocator + hash-based prefix cache for the paged KV pool
(``repro.serving.paged`` counterpart; numpy only, a copy kept by the port
so that it imports nothing of the JAX package).

The device side of the paged cache is a shared pool of fixed-size KV pages
(`transformer.init_paged_cache`: attention leaves are ``(num_pages+1,
page_size, ...)`` with row 0 reserved as the TRASH page that masked writes
and unmapped page-table entries point at).  This module owns everything the
device never sees: which pages are free, which slot references which pages,
how many requests share a page, and which token prefixes are already
resident.

`PagePool` is a refcounted allocator with content-addressed reuse:

  * ``alloc(n)`` hands out ``n`` fresh pages, evicting least-recently-used
    CACHED pages (refcount 0 but content still valid and hash-indexed) when
    the free list runs dry.
  * ``register(page, key)`` publishes a page's content under a token-prefix
    key once the page is fully written; ``match(prompt)`` walks the longest
    chain of already-resident prefix pages for a new prompt and increfs the
    hits — the caller prefills only the unique suffix.
  * keys are EXACT token bytes (no lossy hashing): ``("f", tokens[:k*ps])``
    for the k-th full page of a prefix, ``("p", tokens)`` for a partial
    tail page holding the end of a full prompt.
  * copy-on-write: full prefix pages are only ever read by sharers (decode
    writes land at positions >= prompt_len, i.e. in later pages), so they
    are shared in place.  A matched PARTIAL tail page will be written by
    the new request's own recompute/decode, so `match` returns it as
    ``cow_src`` — the caller device-copies it into a freshly allocated page
    and drops the pin (`release_cow`).

A retired request decrefs its pages; hashed pages park in the LRU cache
(still allocated, still matchable) instead of returning to the free list,
which is what makes a shared system prompt survive across requests that
never overlap in time.
"""
from __future__ import annotations

from collections import OrderedDict, deque
from typing import Dict, List, Optional, Tuple

import numpy as np

TRASH_PAGE = 0  # device row 0: masked writes + unmapped table entries


class PagePool:
    """Refcounted page allocator with prefix-cache reuse (see module doc).

    Page ids run ``1..num_pages`` (0 is the device trash row).  ``in_use``
    counts pages with refcount >= 1 — the peak of that is the paged
    engine's peak KV footprint."""

    def __init__(self, num_pages: int, page_size: int):
        if num_pages < 1 or page_size < 1:
            raise ValueError(f"need num_pages/page_size >= 1, got "
                             f"{num_pages}/{page_size}")
        self.num_pages = int(num_pages)
        self.page_size = int(page_size)
        self.free: deque = deque(range(1, self.num_pages + 1))
        self.ref = np.zeros(self.num_pages + 1, np.int32)
        self.by_hash: Dict[tuple, int] = {}       # content key -> page id
        self.keys_of: Dict[int, List[tuple]] = {}  # page id -> its keys
        self.lru: "OrderedDict[int, None]" = OrderedDict()  # cached, ref 0
        self.in_use = 0
        self.stats = {"lookups": 0, "hit_requests": 0, "hit_tokens": 0,
                      "hit_pages": 0, "cow_copies": 0, "evictions": 0,
                      "peak_pages": 0}

    # ---- capacity ---------------------------------------------------------

    def available(self) -> int:
        """Pages allocatable right now (free + evictable cached)."""
        return len(self.free) + len(self.lru)

    def pages_for(self, tokens: int) -> int:
        return -(-int(tokens) // self.page_size)

    # ---- refcounting ------------------------------------------------------

    def _claim(self, page: int) -> None:
        if self.ref[page] == 0:
            self.lru.pop(page, None)
            self.in_use += 1
            self.stats["peak_pages"] = max(self.stats["peak_pages"],
                                           self.in_use)
        self.ref[page] += 1

    def incref(self, page: int) -> None:
        self._claim(page)

    def decref(self, page: int) -> None:
        if self.ref[page] <= 0:
            raise RuntimeError(f"decref of unreferenced page {page}")
        self.ref[page] -= 1
        if self.ref[page] == 0:
            self.in_use -= 1
            if page in self.keys_of:      # content stays matchable (cached)
                self.lru[page] = None
            else:
                self.free.append(page)

    # ---- allocation -------------------------------------------------------

    def _evict_one(self) -> int:
        page, _ = self.lru.popitem(last=False)           # least recently used
        for key in self.keys_of.pop(page, []):
            if self.by_hash.get(key) == page:
                del self.by_hash[key]
        self.stats["evictions"] += 1
        return page

    def alloc(self, n: int) -> List[int]:
        """``n`` fresh pages with refcount 1; raises RuntimeError when the
        pool cannot supply them (callers gate admission on `available`)."""
        if n > self.available():
            raise RuntimeError(
                f"page pool exhausted: need {n}, have {self.available()} "
                f"({self.in_use}/{self.num_pages} in use)")
        out = []
        for _ in range(n):
            page = self.free.popleft() if self.free else self._evict_one()
            self.ref[page] = 0
            self._claim(page)
            out.append(page)
        return out

    # ---- prefix cache -----------------------------------------------------

    def register(self, page: int, key: tuple) -> None:
        """Publish ``page``'s content under ``key`` (first writer wins —
        re-registering resident content is a no-op)."""
        if key in self.by_hash:
            return
        self.by_hash[key] = page
        self.keys_of.setdefault(page, []).append(key)

    def prompt_keys(self, prompt: np.ndarray) -> List[Tuple[tuple, int]]:
        """``[(key, end_position), ...]`` for every page of ``prompt`` that
        is fully determined by the prompt itself: each full page, plus the
        partial tail page when the prompt is not page-aligned."""
        ps = self.page_size
        plen = len(prompt)
        keys = [(("f", prompt[:(i + 1) * ps].tobytes()), (i + 1) * ps)
                for i in range(plen // ps)]
        if plen % ps:
            keys.append((("p", prompt.tobytes()), plen))
        return keys

    def match(self, prompt: np.ndarray
              ) -> Tuple[int, List[int], Optional[int]]:
        """Longest resident prefix of ``prompt``.

        Returns ``(hit_len, shared_pages, cow_src)``: ``hit_len`` tokens of
        KV (capped at ``prompt_len - 1`` so at least one token is always
        recomputed to produce first-token logits) are already resident —
        ``shared_pages`` are the fully covered pages (increfed here), and
        ``cow_src`` (increfed: pinned against eviction until the caller's
        `release_cow`) is the page holding the partially covered tail, to
        be device-copied into a page the new request owns."""
        ps = self.page_size
        plen = len(prompt)
        self.stats["lookups"] += 1
        chain: List[int] = []
        while (len(chain) + 1) * ps <= plen:
            page = self.by_hash.get(
                ("f", prompt[:(len(chain) + 1) * ps].tobytes()))
            if page is None:
                break
            chain.append(page)
        matched = len(chain) * ps
        partial = None
        if matched < plen:
            partial = self.by_hash.get(("p", prompt.tobytes()))
            if partial is not None:
                matched = plen
        hit_len = min(matched, plen - 1)
        shared = chain[:hit_len // ps]
        cow_src = None
        if hit_len % ps:
            q = hit_len // ps
            cow_src = chain[q] if q < len(chain) else partial
        for page in shared:
            self._claim(page)
        if cow_src is not None:
            self._claim(cow_src)
            self.stats["cow_copies"] += 1
        if hit_len > 0:
            self.stats["hit_requests"] += 1
            self.stats["hit_tokens"] += hit_len
            self.stats["hit_pages"] += len(shared)
        return hit_len, shared, cow_src

    def release_cow(self, page: int) -> None:
        """Drop the pin `match` took on a copy-on-write source page."""
        self.decref(page)

    def release(self, pages: List[int]) -> None:
        """Retire a request's page list (shared prefix pages survive in the
        LRU cache; unhashed pages return to the free list)."""
        for page in pages:
            self.decref(page)

    def purge(self, pages: List[int]) -> None:
        """Unpublish ``pages`` from the prefix cache (fault containment: a
        corrupted page must never be matched by a later prompt, and must
        return to the FREE list — not the LRU — once its refcount drops).
        Safe on pages that were never hashed; does not touch refcounts, so
        call it before `release`."""
        for page in pages:
            for key in self.keys_of.pop(page, []):
                if self.by_hash.get(key) == page:
                    del self.by_hash[key]
            if self.ref[page] == 0 and page in self.lru:
                del self.lru[page]
                self.free.append(page)

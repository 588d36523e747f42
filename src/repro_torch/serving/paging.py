"""Host-side paging core for the paged KV cache: a fixed-size page pool
with a free-list allocator, refcounted pages, and a hash-keyed prefix
store for cross-request prompt sharing.

Pure host bookkeeping — no jax — mirroring ``scheduler.py``'s design so
the whole subsystem is unit-testable without a model
(tests/test_paging.py).  Device-side layout lives in
``serving/cache.py`` / ``models/attention.py::PagedKVCache``; this
module only decides WHICH pages each slot gets.

Layout contract
---------------
* Page 0 is the reserved TRASH page: it is never allocated, and every
  device-side write whose target is masked off (inactive decode rows,
  padded prefill positions past the allocated range) is redirected to
  it.  Its contents are garbage by design and never feed a kept token.
* A request is admitted with a worst-case reservation: enough pages to
  hold ``prompt (+conditioning) + max_new_tokens`` tokens.  Admission
  either gets all its pages or none — a request that cannot be served
  waits in the queue (backpressure) instead of crashing mid-decode.
* Prefix sharing is full-page, hash-chained: page i of a prompt is
  shareable iff every token of pages 0..i matches (the chain hash).
  Shared pages are read-only; reuse is capped at ``prompt_len - 1``
  tokens so the last prompt position is always recomputed (its logits
  produce the first generated token).  When that cap lands INSIDE a
  matched page, the page is copy-on-extended: the engine copies it to a
  fresh private page which the resumed prefill then writes.
"""
from __future__ import annotations

import hashlib
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

TRASH_PAGE = 0


def page_hashes(tokens: np.ndarray, page_size: int) -> List[bytes]:
    """Chain hashes of the FULL pages of a (T,) int token prompt.

    hash_i covers tokens[0 : (i+1)*page_size] — a page matches only if
    every earlier page matched too, so a single differing token anywhere
    in the prefix changes every later hash (near-miss test coverage).
    """
    toks = np.ascontiguousarray(np.asarray(tokens, np.int32).reshape(-1))
    h = b"repro-paged-kv-root"
    out = []
    for i in range(toks.shape[0] // page_size):
        h = hashlib.sha1(h + toks[i * page_size:(i + 1) * page_size]
                         .tobytes()).digest()
        out.append(h)
    return out


class PageAllocator:
    """Free-list allocator over ``num_pages`` pages with refcounts.

    Page 0 (TRASH_PAGE) is reserved; ``usable`` pages = num_pages - 1.
    ``alloc(n)`` is all-or-nothing (returns None when short); sharing
    uses ``retain``/``release`` — a page returns to the free list only
    when its last reference drops.
    """

    def __init__(self, num_pages: int):
        if num_pages < 2:
            raise ValueError("need >= 2 pages (page 0 is the trash page)")
        self.num_pages = num_pages
        # pop() from the end -> ascending page ids, deterministic
        self._free = list(range(num_pages - 1, 0, -1))
        self._ref: Dict[int, int] = {}

    @property
    def usable(self) -> int:
        return self.num_pages - 1

    @property
    def num_free(self) -> int:
        return len(self._free)

    def refcount(self, page: int) -> int:
        return self._ref.get(page, 0)

    def alloc(self, n: int) -> Optional[List[int]]:
        if n > len(self._free):
            return None
        pages = [self._free.pop() for _ in range(n)]
        for p in pages:
            self._ref[p] = 1
        return pages

    def retain(self, page: int) -> None:
        assert self._ref.get(page, 0) > 0, f"retain of free page {page}"
        self._ref[page] += 1

    def release(self, page: int) -> bool:
        """Drop one reference; returns True when the page was freed."""
        assert self._ref.get(page, 0) > 0, f"release of free page {page}"
        self._ref[page] -= 1
        if self._ref[page] == 0:
            del self._ref[page]
            self._free.append(page)
            return True
        return False


class PrefixStore:
    """chain-hash -> page id map of cached full prompt pages, LRU.

    The store holds one reference on every page it advertises, so a
    cached prefix outlives the request that produced it.  Under pool
    pressure the allocator evicts store entries oldest-first
    (``evict_lru``) — dropping the store's claim; the page itself is
    freed once no active slot uses it either.
    """

    def __init__(self):
        self._entries: "OrderedDict[bytes, int]" = OrderedDict()

    def __len__(self) -> int:
        return len(self._entries)

    def match(self, hashes: List[bytes]) -> List[int]:
        """Longest chain of cached pages for these hashes (LRU-bumped)."""
        pages = []
        for h in hashes:
            pid = self._entries.get(h)
            if pid is None:
                break
            self._entries.move_to_end(h)
            pages.append(pid)
        return pages

    def insert(self, h: bytes, page: int, alloc: PageAllocator) -> bool:
        """Advertise ``page`` under ``h``; retains it.  Keeps an existing
        entry (first writer wins) — returns False then."""
        if h in self._entries:
            self._entries.move_to_end(h)
            return False
        self._entries[h] = page
        alloc.retain(page)
        return True

    def evict_lru(self, alloc: PageAllocator) -> bool:
        """Drop the oldest cached entry (returns False when empty)."""
        if not self._entries:
            return False
        _, pid = self._entries.popitem(last=False)
        alloc.release(pid)
        return True


@dataclass
class AdmitPlan:
    """Everything the engine needs to wire one admitted request."""
    pages: List[int]                       # logical page order, len = n_pages
    reuse_len: int = 0                     # prompt tokens skipped (prefix hit)
    num_shared: int = 0                    # leading entries of pages shared
    cow: Optional[Tuple[int, int]] = None  # (dst_page, src_page) device copy
    hashes: List[bytes] = field(default_factory=list)


class PagePool:
    """Allocator + prefix store + per-request plans: the admission-time
    brain of the paged cache.  ``admit`` -> plan or None (backpressure);
    ``finalize_prompt`` publishes a fully-prefilled prompt's pages;
    ``release`` returns a finished request's references.
    """

    def __init__(self, num_pages: int, page_size: int, share: bool = True):
        if page_size < 1:
            raise ValueError("page_size must be >= 1")
        self.page_size = page_size
        self.alloc = PageAllocator(num_pages)
        self.store: Optional[PrefixStore] = PrefixStore() if share else None
        self.stats = {"prefix_hit_tokens": 0, "prefix_prompt_tokens": 0,
                      "cow_copies": 0, "store_evictions": 0}

    # -- admission ----------------------------------------------------
    def pages_needed(self, need_tokens: int) -> int:
        ps = self.page_size
        return max(1, -(-need_tokens // ps))

    def _alloc_evicting(self, n: int) -> Optional[List[int]]:
        while self.alloc.num_free < n:
            if self.store is None or not self.store.evict_lru(self.alloc):
                return None
            self.stats["store_evictions"] += 1
        return self.alloc.alloc(n)

    def admit(self, prompt_tokens: Optional[np.ndarray], prompt_len: int,
              need_tokens: int) -> Optional[AdmitPlan]:
        """Reserve pages for ``need_tokens`` cache entries.

        ``prompt_tokens`` (the (T,) token ids, or None for families whose
        prompt KV depends on per-request conditioning) enables prefix
        matching over ``prompt_len`` leading cache positions.  Returns
        None — with NO side effects — when the pool cannot satisfy the
        reservation even after evicting the prefix store.
        """
        ps = self.page_size
        n_pages = self.pages_needed(need_tokens)

        hashes: List[bytes] = []
        matched: List[int] = []
        if self.store is not None and prompt_tokens is not None:
            hashes = page_hashes(prompt_tokens, ps)
            matched = self.store.match(hashes)
        # never reuse the full prompt: the last position must be
        # recomputed so its logits produce the first generated token
        reuse = min(len(matched) * ps, max(prompt_len - 1, 0))
        num_shared = reuse // ps
        cow_src = matched[num_shared] if len(matched) > num_shared else None

        for p in matched[:num_shared]:
            self.alloc.retain(p)
        fresh = self._alloc_evicting(n_pages - num_shared)
        if fresh is None:
            for p in matched[:num_shared]:           # rollback, no effects
                self.alloc.release(p)
            return None

        cow = None
        if cow_src is not None and reuse % ps:
            # partial reuse of a matched page: copy it to the first
            # fresh page, which the resumed prefill then extends
            cow = (fresh[0], cow_src)
            self.stats["cow_copies"] += 1
        else:
            reuse = num_shared * ps                  # page-aligned resume

        self.stats["prefix_hit_tokens"] += reuse
        self.stats["prefix_prompt_tokens"] += prompt_len
        return AdmitPlan(pages=matched[:num_shared] + fresh,
                         reuse_len=reuse, num_shared=num_shared,
                         cow=cow, hashes=hashes)

    # -- lifecycle ----------------------------------------------------
    def finalize_prompt(self, plan: AdmitPlan, prompt_len: int) -> int:
        """Publish the request's FULL prompt pages into the prefix store
        (pages still receiving decode writes — the partial tail — stay
        private).  Returns how many pages were newly inserted."""
        if self.store is None or not plan.hashes:
            return 0
        n_full = min(prompt_len // self.page_size, len(plan.hashes))
        inserted = 0
        for i in range(n_full):
            inserted += bool(self.store.insert(plan.hashes[i],
                                               plan.pages[i], self.alloc))
        return inserted

    def release(self, plan: AdmitPlan) -> None:
        for p in plan.pages:
            self.alloc.release(p)

    def prefix_hit_rate(self) -> float:
        tot = self.stats["prefix_prompt_tokens"]
        return self.stats["prefix_hit_tokens"] / tot if tot else 0.0

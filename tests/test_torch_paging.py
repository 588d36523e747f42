"""The port's host-side paging core and scheduler
(``repro_torch/serving/paging.py``, ``serving/scheduler.py``) held to the
reference's contracts (``tests/test_paging.py``): allocator refcounts,
chain-hash prefix matching, admission backpressure, copy-on-extend plans,
store eviction and the scheduler's deterministic (arrival, uid)
admission order.  Then one scripted serving loop — admits, prefix hits,
publishes, decode chunks, frees and page backpressure — runs through
both packages' ``PagePool`` / ``PrefixStore`` / ``Scheduler`` and must
give equal plans, page tables, refcounts and admission orders at every
step.  No model, no device: pure bookkeeping."""
import numpy as np
import pytest

from repro.serving import Request as RefRequest
from repro.serving import Scheduler as RefScheduler
from repro.serving.paging import PagePool as RefPagePool
from repro_torch.serving import Request, Scheduler
from repro_torch.serving.paging import (TRASH_PAGE, PageAllocator, PagePool,
                                        PrefixStore, page_hashes)


# ------------------------------------------------------------------
# allocator
# ------------------------------------------------------------------

def test_allocator_round_trip():
    a = PageAllocator(5)                       # pages 1..4 usable
    assert a.usable == 4 and a.num_free == 4
    pages = a.alloc(3)
    assert pages == [1, 2, 3]                  # deterministic ascending
    assert TRASH_PAGE not in pages             # page 0 never allocated
    assert a.num_free == 1
    for p in pages:
        assert a.release(p)                    # refcount 1 -> freed
    assert a.num_free == 4
    assert sorted(a.alloc(4)) == [1, 2, 3, 4]  # freed pages are reusable


def test_allocator_all_or_nothing():
    a = PageAllocator(4)
    assert a.alloc(2) is not None
    before = a.num_free
    assert a.alloc(2) is None                  # only 1 free: refuse whole ask
    assert a.num_free == before                # nothing leaked


def test_allocator_refcounted_sharing():
    a = PageAllocator(3)
    (p,) = a.alloc(1)
    a.retain(p)
    assert a.refcount(p) == 2
    assert not a.release(p)                    # still one holder
    assert a.release(p)                        # last reference frees
    assert a.num_free == 2
    with pytest.raises(AssertionError):
        a.release(p)                           # double-free asserts


def test_allocator_reserves_trash_page():
    with pytest.raises(ValueError):
        PageAllocator(1)                       # nothing usable besides trash


# ------------------------------------------------------------------
# chain hashes + prefix store
# ------------------------------------------------------------------

def test_page_hashes_chain_near_miss():
    ps = 4
    a = np.arange(12, dtype=np.int32)
    b = a.copy()
    b[1] += 1                                  # differ inside page 0
    ha, hb = page_hashes(a, ps), page_hashes(b, ps)
    assert len(ha) == 3                        # full pages only
    # a single early token difference changes EVERY chained hash
    assert all(x != y for x, y in zip(ha, hb))
    # same prefix, divergence in page 2: pages 0-1 still match
    c = a.copy()
    c[9] += 1
    hc = page_hashes(c, ps)
    assert ha[0] == hc[0] and ha[1] == hc[1] and ha[2] != hc[2]
    # partial trailing page contributes no hash
    assert len(page_hashes(a[:11], ps)) == 2


def test_prefix_store_longest_chain_and_lru():
    a = PageAllocator(8)
    s = PrefixStore()
    pages = a.alloc(3)
    hashes = page_hashes(np.arange(12, dtype=np.int32), 4)
    for h, p in zip(hashes, pages):
        assert s.insert(h, p, a)
        assert a.refcount(p) == 2              # store holds a reference
    assert s.match(hashes) == pages
    # a near-miss prompt matches only the common full-page chain
    other = np.arange(12, dtype=np.int32)
    other[5] += 1
    assert s.match(page_hashes(other, 4)) == pages[:1]
    # first writer wins on duplicate insert
    assert not s.insert(hashes[0], 99, a)
    assert s.match(hashes)[0] == pages[0]
    # eviction drops oldest and releases its reference
    assert s.evict_lru(a)
    assert a.refcount(pages[0]) >= 1           # match() bumped recency; some
    assert len(s) == 2                         # entry is gone either way


# ------------------------------------------------------------------
# pool admission
# ------------------------------------------------------------------

def test_admit_backpressure_no_side_effects():
    pool = PagePool(num_pages=5, page_size=4)  # 4 usable
    p1 = pool.admit(None, 8, 16)               # needs 4 pages: fits exactly
    assert p1 is not None and len(p1.pages) == 4
    free_before = pool.alloc.num_free
    assert pool.admit(None, 4, 8) is None      # needs 2, has 0: refused
    assert pool.alloc.num_free == free_before  # rollback left no trace
    pool.release(p1)
    assert pool.alloc.num_free == 4
    assert pool.admit(None, 4, 8) is not None  # serveable once freed


def test_admit_prefix_hit_and_cow():
    ps = 4
    pool = PagePool(num_pages=12, page_size=ps)
    prompt = np.arange(10, dtype=np.int32)     # 2 full pages + tail
    plan = pool.admit(prompt, 10, 14)
    assert plan.reuse_len == 0 and plan.cow is None
    pool.finalize_prompt(plan, 10)             # publishes pages 0-1

    # same 2-page prefix, different tail: page-aligned resume, no COW
    p2 = np.concatenate([prompt[:8], np.array([77, 78], np.int32)])
    plan2 = pool.admit(p2, 10, 14)
    assert plan2.num_shared == 2 and plan2.reuse_len == 8
    assert plan2.cow is None
    assert plan2.pages[:2] == plan.pages[:2]   # the very same shared pages
    assert pool.alloc.refcount(plan.pages[0]) >= 3  # req1 + store + req2

    # page-aligned prompt (exactly 2 pages): reuse caps at prompt_len-1
    # = 7, INSIDE matched page 1 -> copy-on-extend
    plan3 = pool.admit(prompt[:8].copy(), 8, 12)
    assert plan3.reuse_len == 7 and plan3.num_shared == 1
    dst, src = plan3.cow
    assert src == plan.pages[1]                # the matched-but-partial page
    assert dst == plan3.pages[1]               # first fresh page extends it
    assert pool.stats["cow_copies"] == 1

    pool.release(plan2)
    pool.release(plan3)
    pool.release(plan)
    # store still holds its published pages; nothing double-freed
    assert pool.alloc.num_free == pool.alloc.usable - 2


def test_admit_evicts_store_under_pressure():
    ps = 4
    pool = PagePool(num_pages=6, page_size=ps)  # 5 usable
    plan = pool.admit(np.arange(8, dtype=np.int32), 8, 12)   # 3 pages
    pool.finalize_prompt(plan, 8)
    pool.release(plan)                          # store keeps pages 0-1 alive
    assert pool.alloc.num_free == 3
    plan2 = pool.admit(None, 16, 20)            # needs 5: must evict store
    assert plan2 is not None and len(plan2.pages) == 5
    assert pool.stats["store_evictions"] == 2


def test_last_token_never_reused():
    """Even a fully-cached prompt recomputes its final position — the
    first generated token comes from that position's logits."""
    ps = 4
    pool = PagePool(num_pages=10, page_size=ps)
    prompt = np.arange(8, dtype=np.int32)       # exactly 2 pages
    plan = pool.admit(prompt, 8, 12)
    pool.finalize_prompt(plan, 8)
    plan2 = pool.admit(prompt.copy(), 8, 12)
    assert plan2.reuse_len == 7 < 8             # capped below prompt_len


# ------------------------------------------------------------------
# scheduler admission order
# ------------------------------------------------------------------

def test_scheduler_pops_min_arrival_uid():
    s = Scheduler(1)
    # submitted out of order; uids 2,0,1 all arrived (arrival 0), plus a
    # later arrival that must not jump the line
    s.submit(Request(uid=2, tokens=np.arange(3), max_new_tokens=2))
    s.submit(Request(uid=0, tokens=np.arange(3), max_new_tokens=2))
    s.submit(Request(uid=1, tokens=np.arange(3), max_new_tokens=2, arrival=0))
    order = [s._pop_arrived().uid for _ in range(3)]
    assert order == [0, 1, 2]                   # ties on arrival break by uid


def test_scheduler_requeue_keeps_place_in_line():
    s = Scheduler(1)
    s.submit(Request(uid=0, tokens=np.arange(3), max_new_tokens=2))
    s.submit(Request(uid=1, tokens=np.arange(3), max_new_tokens=2))
    req = s._pop_arrived()
    assert req.uid == 0
    s.requeue(req)                              # bounced (no pages)
    assert s._pop_arrived().uid == 0            # still first, not last


# ------------------------------------------------------------------
# parity: one scripted serving loop through both packages
# ------------------------------------------------------------------

PAGE_SIZE, NUM_PAGES, SLOTS, GEN = 4, 14, 3, 5


def _script_requests():
    """Prompts that share prefixes (page-aligned and not), a duplicate,
    a near miss and a long prompt that meets backpressure; staggered
    arrivals and out-of-order uids.  (uid, prompt, arrival)."""
    rng = np.random.default_rng(5)
    base = rng.integers(0, 100, size=24).astype(np.int32)
    near = base[:12].copy()
    near[6] += 1
    other = rng.integers(100, 200, size=30).astype(np.int32)
    return [(3, base[:10], 0), (0, base[:13], 0), (1, base[:8].copy(), 1),
            (5, np.concatenate([base[:8], [7, 8, 9]]).astype(np.int32), 1),
            (7, other, 1), (2, near, 2), (4, base[:22], 2),
            (6, base[:10].copy(), 3)]


def _serve_script(request_cls, scheduler_cls, pool_cls):
    """Admissions, one-step prefills (published on completion), decode
    chunks of two steps whose tokens count the step, and frees, on one
    package's classes; returns the log of every step."""
    pool = pool_cls(num_pages=NUM_PAGES, page_size=PAGE_SIZE)
    sched = scheduler_cls(SLOTS)
    for uid, toks, arrival in _script_requests():
        sched.submit(request_cls(uid=uid, tokens=toks, max_new_tokens=GEN,
                                 arrival=arrival))
    plans, log = {}, []
    for step in range(40):
        if not sched.has_work():
            break
        for slot, req in sched.admissible():
            plan = pool.admit(req.tokens, req.prompt_len,
                              req.prompt_len + req.max_new_tokens)
            if plan is None:
                sched.requeue(req)
                log.append(("requeue", step, req.uid))
                continue
            plans[slot] = plan
            sched.place_prefilling(slot, req, plan.reuse_len)
            log.append(("admit", step, slot, req.uid, list(plan.pages),
                        plan.reuse_len, plan.num_shared, plan.cow,
                        list(plan.hashes)))
        for slot in sched.prefilling_slots():
            req = sched.slots[slot].request
            log.append(("publish", step, slot,
                        pool.finalize_prompt(plans[slot], req.prompt_len)))
            if sched.finish_prefill(slot, step % 7):
                pool.release(plans.pop(slot))
        if sched.decoding_slots():
            chunk = np.full((2, SLOTS), step, np.int32)
            for slot in sched.absorb_chunk(chunk):
                pool.release(plans.pop(slot))
                log.append(("free", step, slot))
        else:
            sched.tick()
        log.append(("state", step,
                    {s: list(p.pages) for s, p in sorted(plans.items())},
                    pool.alloc.num_free,
                    [pool.alloc.refcount(p)
                     for p in range(1, NUM_PAGES)],
                    len(pool.store), dict(pool.stats)))
    results = {u: r.tolist() for u, r in sorted(sched.results().items())}
    return log, results


def test_scripted_loop_equals_the_reference():
    got, got_res = _serve_script(Request, Scheduler, PagePool)
    want, want_res = _serve_script(RefRequest, RefScheduler, RefPagePool)
    assert got == want
    assert got_res == want_res
    kinds = [e[0] for e in got]
    # the script reaches every path it is meant to: backpressure, a
    # prefix hit (page-aligned and copy-on-extend), publishing and frees
    admits = [e for e in got if e[0] == "admit"]
    assert "requeue" in kinds and kinds.count("free") == len(admits)
    assert any(e[5] > 0 and e[7] is None for e in admits)
    assert any(e[7] is not None for e in admits)
    assert [e[3] for e in admits][:3] == [0, 3, 1]
    assert sorted(got_res) == sorted(u for u, _, _ in _script_requests())

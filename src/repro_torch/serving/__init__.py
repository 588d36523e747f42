"""Continuous-batching inference engine (port of ``repro/serving``).

Layers (bottom up):

* ``sampling``  — greedy / temperature / top-k token selection, one
  code path shared by the engine and the naive loop.
* ``paging``    — host-side page bookkeeping for the paged KV cache:
  free-list block allocator, per-request worst-case reservation,
  refcounted prefix sharing (hash-matched pages, copy-on-extend).
* ``cache``     — slot-batch cache managers layered on
  ``model.init_cache`` / ``model.init_paged_cache``: per-slot position
  vectors; dense slot rows or page pools + page tables, updated in place.
* ``request``   — the host-side request record (prompt, budget, EOS,
  arrival time, per-request conditioning).
* ``scheduler`` — fixed-size slot scheduler: deterministic
  min-(arrival, uid) admission, EOS / max-new-tokens termination, slot
  reuse, prefill/decode slot phases for the paged engine.
* ``engine``    — the loop: bucketed prefill, a multi-token decode
  chunk, admission between chunks; ``paged=True`` switches to the paged
  KV cache with chunked prefill and page-exhaustion backpressure, and
  ``use_paged_kernel=True`` decodes through the CUDA paged-attention
  kernel.
* ``naive``     — the one-request-at-a-time reference loop the engine is
  exact-matched against.
"""
from repro_torch.serving.engine import Engine
from repro_torch.serving.naive import make_naive_fns, naive_generate
from repro_torch.serving.paging import (AdmitPlan, PageAllocator, PagePool,
                                        PrefixStore, page_hashes)
from repro_torch.serving.request import Request
from repro_torch.serving.sampling import SamplingParams, make_token_selector
from repro_torch.serving.scheduler import Scheduler

__all__ = ["AdmitPlan", "Engine", "PageAllocator", "PagePool",
           "PrefixStore", "Request", "SamplingParams", "Scheduler",
           "make_naive_fns", "make_token_selector", "naive_generate",
           "page_hashes"]

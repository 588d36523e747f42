"""Slot-batch cache managers: dense and paged.

Port of ``repro/serving/cache.py``.  The reference's jitted writers
donate the slot-batch cache so XLA updates it in place; here every
function below writes the caller's tensors in place and returns the same
cache tuple.

The engine's caches stay at fixed addresses (its decode chunk is one
CUDA graph): ``copy_into`` puts what a model returns back into them.

Dense layout (``init_slot_cache``): the engine's decode batch owns ONE
cache whose batch axis is the slot axis (layers are stacked at axis 0)
and whose ``pos`` fields are (num_slots,) vectors: each slot keeps its
own explicit token offset.  Admission copies a freshly prefilled
single-request cache into a slot row; eviction needs no work — the next
occupant overwrites the row.

Paged layout (``init_paged_slot_cache``): KV fields become page POOLS —
``(L, num_pages, page_size, KV, hd)`` — addressed through a
``(num_slots, max_pages)`` int32 page table (attention.PagedKVCache);
position p of slot b lives at ``pool[table[b, p // ps], p % ps]``.
SSM state / conv fields stay dense per slot (O(1) per request).  Which
pages a slot's table row names is decided host-side by
``serving/paging.py``; admission writes the row, prefill streams chunks
through the table, and nothing is copied on eviction — the pages are
simply returned to the pool.
"""
from __future__ import annotations

import torch

from repro_torch.models.model import is_pos_entry, with_cache_positions


def _leaves(cache):
    """(field name, tensor) for every tensor of a (nested) cache tuple."""
    for name, leaf in cache._asdict().items():
        if isinstance(leaf, torch.Tensor):
            yield name, leaf
        else:
            yield from _leaves(leaf)


def clone(cache):
    """A copy of a (nested) cache tuple, every tensor cloned."""
    return cache._replace(**{
        name: leaf.clone() if isinstance(leaf, torch.Tensor) else clone(leaf)
        for name, leaf in cache._asdict().items()})


def reset(cache):
    """Zero every tensor of ``cache`` in place — a model's ``init_cache``
    values — and return it."""
    for _, leaf in _leaves(cache):
        leaf.zero_()
    return cache


def copy_into(cache, new):
    """Copy each tensor of ``new`` that is not ``cache``'s own into it, and
    return ``cache``.  The models write a cache in place but return its
    ``pos`` fields as new tensors; the engine's decode graph needs every
    tensor of its cache at a fixed address."""
    for (_, old), (_, leaf) in zip(_leaves(cache), _leaves(new)):
        if leaf is not old:
            old.copy_(leaf)
    return cache


def init_slot_cache(model, params, num_slots: int, max_len: int):
    """A cache whose batch axis is the slot axis and whose positions are
    per-slot (num_slots,) vectors, all starting at 0."""
    cache = model.init_cache(params, num_slots, max_len)
    return with_cache_positions(cache, torch.zeros(num_slots,
                                                   dtype=torch.int32))


def write_slot(batch_cache, one_cache, slot: int, pos: int):
    """Copy the single-request ``one_cache`` into row ``slot`` of the slot
    batch and set that row's position to ``pos`` — the request's TRUE
    length (one_cache.pos counts the padded prefill bucket)."""
    for (name, big), (_, small) in zip(_leaves(batch_cache),
                                       _leaves(one_cache)):
        if is_pos_entry(name):
            big[slot] = pos
        else:                 # big: (L, num_slots, ...), small: (L, 1, ...)
            big[:, slot] = small[:, 0]
    return batch_cache


# ------------------------------------------------------------------
# Paged layout
# ------------------------------------------------------------------

def init_paged_slot_cache(model, params, num_slots: int, num_pages: int,
                          page_size: int, max_pages: int):
    return model.init_paged_cache(params, num_slots, num_pages, page_size,
                                  max_pages)


def admit_slot(cache, slot: int, table_row):
    """Slot admission: install the page-table row, reset the slot's
    position and recurrent state (SSM conv ring + state rows must not
    leak from the previous occupant — chunked prefill RESUMES from
    them).  Page pools are untouched."""
    for name, leaf in _leaves(cache):
        if is_pos_entry(name):
            leaf[slot] = 0
        elif name == "table":
            leaf[slot] = torch.as_tensor(table_row, dtype=torch.int32)
        elif name in ("conv", "state"):        # (L, num_slots, ...)
            leaf[:, slot] = 0
    return cache


def set_slot_pos(cache, slot: int, pos: int):
    """Set every pos field's row ``slot`` (prefill done -> decode starts
    at the full merged prompt length)."""
    for name, leaf in _leaves(cache):
        if is_pos_entry(name):
            leaf[slot] = pos
    return cache


def copy_page(cache, dst: int, src: int):
    """Copy page ``src`` of every pool to page ``dst`` (copy-on-extend of
    a shared prefix page).  A copy, never an alias: ``dst`` is then
    written by the resumed prefill while ``src`` stays shared."""
    for name, leaf in _leaves(cache):
        if name in ("k", "v"):                 # pools: (L, P, ps, ...)
            leaf[:, dst].copy_(leaf[:, src])
    return cache

"""Slot-based scheduler for the continuous-batching engine.

A fixed-size decode batch of ``num_slots`` rows; requests are admitted
into free slots (respecting their ``arrival`` step) and evicted when
they terminate — EOS or max-new-tokens — so the slot is reused by the
next queued request.  Pure host-side bookkeeping: no jax, fully
unit-testable without a model.

Admission policy: among arrived requests the scheduler always picks the
minimum ``(arrival, uid)`` — explicitly deterministic, independent of
submission order and of paged-backpressure requeues (a request bounced
back for lack of pages re-enters the queue without changing its place
in line; ties on ``arrival`` break by ``uid``).

The paged engine additionally runs slots through a PREFILL phase
(``SlotRecord.phase``): a chunked-prefill slot occupies its row and
advances ``frontier`` each engine step but emits nothing until
``finish_prefill`` flips it to the decode phase with its first token.
``absorb_chunk`` only feeds decode-phase slots.
"""
from __future__ import annotations

from collections import deque
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.serving.request import Request, SlotRecord


class Scheduler:
    def __init__(self, num_slots: int):
        if num_slots < 1:
            raise ValueError("num_slots must be >= 1")
        self.num_slots = num_slots
        self.slots: List[Optional[SlotRecord]] = [None] * num_slots
        self.queue: deque[Request] = deque()
        self.step_count = 0                       # decode chunks elapsed
        self.finished: Dict[int, SlotRecord] = {} # uid -> record
        self.tokens_emitted = 0                   # KEPT tokens (audio: xK);
                                                  # discarded speculative
                                                  # post-EOS tokens excluded

    # -- admission ----------------------------------------------------
    def submit(self, req: Request) -> None:
        self.queue.append(req)

    def free_slots(self) -> List[int]:
        return [i for i, s in enumerate(self.slots) if s is None]

    def admissible(self) -> List[Tuple[int, Request]]:
        """Pair each free slot with the next arrived queued request.
        Pops the requests; the caller MUST follow up with ``place``."""
        pairs = []
        for i in self.free_slots():
            req = self._pop_arrived()
            if req is None:
                break
            pairs.append((i, req))
        return pairs

    def _pop_arrived(self) -> Optional[Request]:
        """Pop the arrived request with the smallest ``(arrival, uid)``."""
        best = None
        for j, req in enumerate(self.queue):
            if req.arrival <= self.step_count and (
                    best is None or (req.arrival, req.uid) < best[1]):
                best = (j, (req.arrival, req.uid))
        if best is None:
            return None
        req = self.queue[best[0]]
        del self.queue[best[0]]
        return req

    def requeue(self, req: Request) -> None:
        """Return a popped request to the queue (paged backpressure: no
        pages available).  Position is irrelevant — ``_pop_arrived`` is
        a deterministic min over the whole queue."""
        self.queue.append(req)

    def place(self, slot: int, req: Request, first_token) -> bool:
        """Occupy ``slot`` with ``req`` whose first token (from the
        PREFILL logits) is ``first_token``.  Returns True if the request
        already terminated (single-token budget or immediate EOS)."""
        assert self.slots[slot] is None, f"slot {slot} occupied"
        rec = SlotRecord(request=req)
        self.slots[slot] = rec
        if self._append(rec, first_token):
            self._evict(slot)
            return True
        return False

    def place_prefilling(self, slot: int, req: Request, frontier: int) -> None:
        """Occupy ``slot`` with a request whose chunked prefill is still
        in flight.  ``frontier`` is where prefill resumes (> 0 on a
        prefix-cache hit).  The slot emits nothing until
        ``finish_prefill``."""
        assert self.slots[slot] is None, f"slot {slot} occupied"
        self.slots[slot] = SlotRecord(request=req, phase="prefill",
                                      frontier=frontier)

    def finish_prefill(self, slot: int, first_token) -> bool:
        """Flip a prefilling slot to the decode phase, recording the
        first token (from the final prefill chunk's logits).  Returns
        True if the request terminated immediately."""
        rec = self.slots[slot]
        assert rec is not None and rec.phase == "prefill"
        rec.phase = "decode"
        if self._append(rec, first_token):
            self._evict(slot)
            return True
        return False

    # -- termination --------------------------------------------------
    def _append(self, rec: SlotRecord, token) -> bool:
        tok = np.asarray(token, np.int32)
        rec.emitted.append(tok.reshape(-1) if tok.ndim else tok)
        self.tokens_emitted += int(tok.size)
        req = rec.request
        if req.eos_id is not None and bool(np.all(tok == req.eos_id)):
            rec.done = True
        if len(rec.emitted) >= req.max_new_tokens:
            rec.done = True
        return rec.done

    def _evict(self, slot: int) -> None:
        rec = self.slots[slot]
        self.finished[rec.request.uid] = rec
        self.slots[slot] = None

    # -- deadline shedding --------------------------------------------
    def shed_queued(self, uid: int) -> bool:
        """Drop a QUEUED request whose deadline expired.  It finishes
        immediately with zero tokens (the record lands in ``finished``
        so the caller's results() still covers every submitted uid)."""
        for j, req in enumerate(self.queue):
            if req.uid == uid:
                del self.queue[j]
                self.finished[uid] = SlotRecord(request=req, done=True)
                return True
        return False

    def shed_slot(self, slot: int) -> None:
        """Evict an OCCUPIED slot before natural termination (deadline
        expired mid-prefill or mid-decode).  Partial tokens emitted so
        far are kept in ``finished`` — degraded output beats none."""
        rec = self.slots[slot]
        assert rec is not None, f"slot {slot} empty"
        rec.done = True
        self._evict(slot)

    def absorb_chunk(self, chunk_tokens: np.ndarray) -> List[int]:
        """Feed one decode chunk's tokens — (C, B) or (C, B, K) — to the
        occupied slots.  A slot that terminates at step j ignores the
        chunk's remaining steps (those tokens were decoded speculatively
        past EOS and are discarded).  Returns the freed slot indices."""
        freed = []
        active = [(i, rec) for i, rec in enumerate(self.slots)
                  if rec is not None and rec.phase == "decode"]
        for i, rec in active:
            for c in range(chunk_tokens.shape[0]):
                if self._append(rec, chunk_tokens[c, i]):
                    break
            if rec.done:
                self._evict(i)
                freed.append(i)
        self.step_count += 1
        return freed

    def tick(self) -> None:
        """Advance the step clock on an engine step with no decode chunk
        (paged engine busy prefilling) so staggered arrivals progress."""
        self.step_count += 1

    # -- state --------------------------------------------------------
    def active_slots(self) -> List[int]:
        return [i for i, s in enumerate(self.slots) if s is not None]

    def decoding_slots(self) -> List[int]:
        return [i for i, s in enumerate(self.slots)
                if s is not None and s.phase == "decode"]

    def prefilling_slots(self) -> List[int]:
        return [i for i, s in enumerate(self.slots)
                if s is not None and s.phase == "prefill"]

    def has_work(self) -> bool:
        return bool(self.queue) or bool(self.active_slots())

    def results(self) -> Dict[int, np.ndarray]:
        return {uid: rec.tokens() for uid, rec in self.finished.items()}

"""The host-side request record.

Prompts are per-request (unbatched): (T,) int32 for text families,
(K, T) for audio.  Conditioning tensors are likewise unbatched —
``cond``: (cond_len, d_model) for audio, ``patch_embeds``:
(num_patches, d_model) for vlm; the engine adds the batch axis when it
prefills the request.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional

import numpy as np


@dataclass
class Request:
    uid: int
    tokens: np.ndarray                   # (T,) or (K, T) int32 prompt
    max_new_tokens: int
    eos_id: Optional[int] = None         # None: max-len termination only
    arrival: int = 0                     # engine step at which the request
                                         # becomes admissible (staggered
                                         # arrivals; 0 = immediately)
    cond: Optional[Any] = None           # audio conditioning (cond_len, d)
    patch_embeds: Optional[Any] = None   # vlm patches (num_patches, d)
    deadline_ms: Optional[float] = None  # wall budget from submit(); an
                                         # expired request is SHED (graceful
                                         # degradation) instead of served late

    def __post_init__(self):
        self.tokens = np.asarray(self.tokens, np.int32)
        if self.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")

    @property
    def prompt_len(self) -> int:
        return int(self.tokens.shape[-1])


@dataclass
class SlotRecord:
    """What the scheduler tracks per occupied slot."""
    request: Request
    emitted: list = field(default_factory=list)   # per-step int or (K,) array
    done: bool = False
    phase: str = "decode"                # "prefill" (paged engine, chunked
                                         # prefill in flight) or "decode"
    frontier: int = 0                    # cache positions prefilled so far
                                         # (merged coords: audio counts cond)

    def tokens(self) -> np.ndarray:
        """Emitted tokens as (G,) — or (K, G) for audio streams."""
        arr = np.asarray(self.emitted, np.int32)
        return arr.T if arr.ndim == 2 else arr

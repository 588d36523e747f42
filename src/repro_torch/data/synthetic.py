"""Synthetic token stream (offline — no real datasets).  Port of
``repro/data/synthetic.py``'s ``TokenStream``, ``replica_batches`` and
``make_round_batch_fn`` (the classification streams are not ported yet).

The same deterministic Markov structure: next token = (prev * 31 + 7)
% V half the time, a uniform draw otherwise.  The draws come from a
``torch.Generator`` on the stream's device, seeded per (step, shard) as
the reference keys its threefry PRNG — so batches are deterministic and
made on the device, but they are NOT the reference's numbers (threefry
is not reproduced; the parity tests feed the reference's batches
through numpy).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass
class TokenStream:
    vocab_size: int
    seq_len: int
    batch_size: int
    seed: int = 0
    device: str = "cpu"

    def batch(self, step: int) -> dict:
        """Deterministic pseudo-Markov batch for ``step`` (the whole
        stream: shard 0 of 1)."""
        return _token_batch(step, 0, 1, self.seed, self.batch_size,
                            self.seq_len, self.vocab_size, False,
                            self.device)


def _token_batch(step, idx, cnt, seed, batch_size, seq_len, vocab_size,
                 split, device):
    """split=True gives shard ``idx`` its own disjoint 2^20-wide key
    block; split=False interleaves all shards through the full stream."""
    base_idx = idx * (1 << 20) + step if split else step * cnt + idx
    gen = torch.Generator(device=device).manual_seed(seed * 100003 + base_idx)
    shape = (batch_size, seq_len + 1)
    base = torch.randint(0, vocab_size, shape, generator=gen, device=device)
    nxt = (base[:, :-1] * 31 + 7) % vocab_size
    coin = torch.rand(nxt.shape, generator=gen, device=device) < 0.5
    seq = torch.cat([base[:, :1], torch.where(coin, nxt, base[:, 1:])], dim=1)
    return {"tokens": seq[:, :-1].to(torch.int32),
            "labels": seq[:, 1:].to(torch.int32)}


def replica_batches(stream: TokenStream, step: int, batch_size: int,
                    n_replicas: int, split: bool = False) -> dict:
    """Per-replica batches stacked along a leading replica axis (n, B, T).

    split=False: every replica draws from the full data (paper §4), its
    shard index decorrelating the draws; split=True: replica a draws
    only from shard a (paper §5)."""
    outs = [_token_batch(step, a, n_replicas, stream.seed, batch_size,
                         stream.seq_len, stream.vocab_size, split,
                         stream.device)
            for a in range(n_replicas)]
    return {k: torch.stack([o[k] for o in outs]) for k in outs[0]}


def make_round_batch_fn(stream: TokenStream, L: int, batch_size: int,
                        n_replicas: int, split: bool = False):
    """Staging for whole rounds: ``stage(start_step)`` returns the L x n
    batches of a round as (L, n, B, T) leaves, equal to stacking
    :func:`replica_batches` per step."""

    def stage(start_step: int) -> dict:
        steps = [replica_batches(stream, start_step + i, batch_size,
                                 n_replicas, split=split) for i in range(L)]
        return {k: torch.stack([s[k] for s in steps]) for k in steps[0]}

    return stage

"""Synthetic data streams (offline — no real datasets).  Port of
``repro/data/synthetic.py``'s ``TokenStream``, ``TeacherTask``,
``replica_batches`` and ``make_round_batch_fn``.

``TeacherTask`` (the paper-faithful classification task of
``examples/quickstart.py``) draws everything from numpy's
``RandomState`` exactly as the reference does, so its data and every
batch equal the reference's bit for bit; the tensors live on the task's
device.

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

import numpy as np
import torch


@dataclass
class TokenStream:
    vocab_size: int
    seq_len: int
    batch_size: int
    seed: int = 0
    device: str = "cpu"
    num_codebooks: int = 0        # audio: emit (B, K, T)

    def batch(self, step: int) -> dict:
        """Deterministic pseudo-Markov batch for ``step`` (the whole
        stream: shard 0 of 1)."""
        return _token_batch(step, 0, 1, self.seed, self.batch_size,
                            self.seq_len, self.vocab_size, False,
                            self.device, self.num_codebooks)


def _token_batch(step, idx, cnt, seed, batch_size, seq_len, vocab_size,
                 split, device, num_codebooks=0):
    """split=True gives shard ``idx`` its own disjoint 2^20-wide key
    block; split=False interleaves all shards through the full stream.
    ``num_codebooks`` K > 0 gives (B, K, T) tokens and labels."""
    base_idx = idx * (1 << 20) + step if split else step * cnt + idx
    gen = torch.Generator(device=device).manual_seed(seed * 100003 + base_idx)
    shape = ((batch_size, num_codebooks, seq_len + 1) if num_codebooks
             else (batch_size, seq_len + 1))
    base = torch.randint(0, vocab_size, shape, generator=gen, device=device)
    nxt = (base[..., :-1] * 31 + 7) % vocab_size
    coin = torch.rand(nxt.shape, generator=gen, device=device) < 0.5
    seq = torch.cat([base[..., :1], torch.where(coin, nxt, base[..., 1:])],
                    dim=-1)
    return {"tokens": seq[..., :-1].to(torch.int32),
            "labels": seq[..., 1:].to(torch.int32)}


@dataclass
class TeacherTask:
    """Fixed teacher-MLP labelled Gaussian classification task."""
    in_dim: int = 64
    hidden: int = 96
    num_classes: int = 10
    num_train: int = 4096
    num_test: int = 1024
    seed: int = 0
    label_noise: float = 0.05
    device: str = "cpu"

    def __post_init__(self):
        rng = np.random.RandomState(self.seed)
        w1 = rng.randn(self.in_dim, self.hidden) / np.sqrt(self.in_dim)
        w2 = rng.randn(self.hidden, self.num_classes) / np.sqrt(self.hidden)
        xs = rng.randn(self.num_train + self.num_test,
                       self.in_dim).astype(np.float32)
        logits = np.tanh(xs @ w1) @ w2
        ys = np.argmax(logits, axis=1)
        flip = rng.rand(len(ys)) < self.label_noise
        ys = np.where(flip, rng.randint(0, self.num_classes, len(ys)), ys)
        on = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(
            self.device)
        self.x_train = on(xs[:self.num_train])
        self.y_train = on(ys[:self.num_train].astype(np.int32))
        self.x_test = on(xs[self.num_train:])
        self.y_test = on(ys[self.num_train:].astype(np.int32))

    def train_batch(self, step: int, batch_size: int,
                    shard: tuple = (0, 1)) -> dict:
        """Replica shard (a, n): draw only from the a-th 1/n of the data
        (paper §5 splitting).  Every sample is in exactly one shard."""
        a, n = shard
        per = self.num_train // n
        rng = np.random.RandomState((step * n + a) * 7919 + 13)
        idx = torch.from_numpy(a * per + rng.randint(0, per, batch_size)).to(
            self.device)
        return {"x": self.x_train[idx], "y": self.y_train[idx]}

    def test_batch(self) -> dict:
        return {"x": self.x_test, "y": self.y_test}

    def batches_per_epoch(self, batch_size: int) -> int:
        return max(1, self.num_train // batch_size)


def replica_batches(task_or_stream, step: int, batch_size: int,
                    n_replicas: int, split: bool = False) -> dict:
    """Per-replica batches stacked along a leading replica axis.

    split=False: every replica draws from the full data (paper §4), its
    shard index decorrelating the draws; split=True: replica a draws
    only from shard a (paper §5)."""
    if isinstance(task_or_stream, TeacherTask):
        outs = [task_or_stream.train_batch(
            step if split else step * n_replicas + a, batch_size,
            (a, n_replicas) if split else (0, 1))
            for a in range(n_replicas)]
    else:
        s = task_or_stream
        outs = [_token_batch(step, a, n_replicas, s.seed, batch_size,
                             s.seq_len, s.vocab_size, split, s.device,
                             s.num_codebooks)
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

"""The faults a cell can have, planted in the program for the readings of
``calibrate.py`` and for the tests, each by replacing one of the
program's functions; ``undo`` puts back what was replaced.  Each takes a
list that records what it replaced."""
from __future__ import annotations

import torch


def half_batch(monkey):
    """Fault: the loss over the first half of each row's tokens only."""
    from repro_torch.launch import steps
    orig = steps.make_loss_fn

    def make(cfg, *a, **k):
        loss = orig(cfg, *a, **k)

        def half(params, batch):
            T = batch["tokens"].shape[-1]
            return loss(params, {k2: v[..., :T // 2]
                                 for k2, v in batch.items()})
        half.cfg = cfg
        return half
    monkey.append((steps, "make_loss_fn", orig))
    steps.make_loss_fn = make


def frozen_state(monkey):
    """Fault: every step returns the state it was given."""
    from repro_torch.core import parle
    for name, fn in (("inner_step", lambda state, *a, **k: state),
                     ("sync_step", lambda state, *a, **k: state)):
        monkey.append((parle, name, getattr(parle, name)))
        setattr(parle, name, fn)


def no_exchange(monkey):
    """Fault: the sync's x̄ is the first replica's x alone."""
    from repro_torch.core import parle
    orig = parle.replica_mean

    def first(x, out=None):
        return x[0].clone() if out is None else out.copy_(x[0])
    monkey.append((parle, "replica_mean", orig))
    parle.replica_mean = first


def altered_token(monkey, every: int = 61):
    """Fault: where the best id is a multiple of ``every``, the second
    best is served."""
    from repro_torch.serving import engine
    orig = engine.make_token_selector

    def make(cfg, sp):
        sel = orig(cfg, sp)

        def bad(logits, gen):
            tok = sel(logits, gen)
            second = torch.topk(logits[:, -1], 2, dim=-1).indices[..., 1:]
            return torch.where(tok % every == 0, second.to(tok.dtype),
                               tok)
        return bad
    monkey.append((engine, "make_token_selector", orig))
    engine.make_token_selector = make


def undo(monkey):
    while monkey:
        mod, name, orig = monkey.pop()
        setattr(mod, name, orig)

"""The ``Algorithm`` protocol for the Parle family.  Port of
``repro/core/algorithm.py`` for the two algorithms the port has:
``parle`` and ``entropy_sgd`` (= Parle with n=1, §2.1/§3).

  canonicalize_cfg(cfg)      -> cfg with the algorithm's invariants
                                applied (entropy_sgd forces n=1)
  init(params, cfg)          -> State
  make_step(loss_fn, cfg, *, weight_decay, use_kernel, lr_schedule)
                             -> step(state, batch) -> (state, metrics)
  make_round_fn(loss_fn, cfg, *, weight_decay, use_kernel, lr_schedule)
                             -> round(state, batches) -> (state, metrics):
                                the L = cfg.L inner steps and the sync in
                                one call; batches leaves are (L, n, B, ...);
                                with cfg.sync_overlap the staleness-1
                                round (head first, then the inner steps)
  make_round_flush_fn(cfg, *, lr_schedule)
                             -> flush(state) -> state, the end-of-training
                                apply of the in-flight consensus; None
                                unless cfg.sync_overlap
  deployable(state)          -> the single servable param tree
  diagnostics(state)         -> dict of host floats (gamma, rho, overlap,
                                spread)

Steps and rounds consume the state they are given (its buffers are
updated in place).  ``lr_schedule`` maps the step counter to a
MULTIPLIER on both lr and lr_inner; left None it is derived from
``cfg.lr_drop_steps``/``cfg.lr_drop_factor`` (the paper's §4 step
decay) by :func:`resolve_lr_schedule`.  The reference's mesh variants
(``make_sharded_step``, ``mesh=``) are not ported yet (ROADMAP.md queue
1, item 6).
"""
from __future__ import annotations

import dataclasses

from repro_torch.core import ensemble, parle
from repro_torch.core.registry import register
from repro_torch.optim import sgd


def resolve_lr_schedule(cfg, lr_schedule=None):
    """An explicit ``lr_schedule`` wins; otherwise ``cfg.lr_drop_steps``
    builds the §4 step decay as a multiplier schedule (base 1.0);
    otherwise None (constant lr)."""
    if lr_schedule is not None:
        return lr_schedule
    if cfg.lr_drop_steps:
        return sgd.step_decay_schedule(1.0, cfg.lr_drop_steps,
                                       cfg.lr_drop_factor)
    return None


class ParleAlgorithm:
    name = "parle"

    def canonicalize_cfg(self, cfg):
        return dataclasses.replace(cfg, mode=self.name)

    def init(self, params, cfg) -> parle.ParleState:
        return parle.init(params, cfg)

    def make_step(self, loss_fn, cfg, *, weight_decay=0.0, use_kernel=False,
                  lr_schedule=None):
        return parle.make_train_step(
            loss_fn, cfg, weight_decay=weight_decay, use_kernel=use_kernel,
            lr_schedule=resolve_lr_schedule(cfg, lr_schedule))

    def make_round_fn(self, loss_fn, cfg, *, weight_decay=0.0,
                      use_kernel=False, lr_schedule=None):
        factory = (parle.make_overlap_round_fn
                   if getattr(cfg, "sync_overlap", False)
                   else parle.make_round_fn)
        return factory(loss_fn, cfg, weight_decay=weight_decay,
                       use_kernel=use_kernel,
                       lr_schedule=resolve_lr_schedule(cfg, lr_schedule))

    def make_round_flush_fn(self, cfg, *, lr_schedule=None):
        if not getattr(cfg, "sync_overlap", False):
            return None
        return parle.make_flush_fn(
            cfg, lr_schedule=resolve_lr_schedule(cfg, lr_schedule))

    def deployable(self, state):
        return parle.average_model(state)

    def diagnostics(self, state) -> dict:
        return {"gamma": float(state.scopes.gamma),
                "rho": float(state.scopes.rho),
                "overlap": float(ensemble.replica_overlap(state.x)),
                "spread": float(ensemble.replica_spread(state.x))}


class EntropySGDAlgorithm(ParleAlgorithm):
    """Exactly Parle with n=1 (§2.1/§3); the n=1 invariant is enforced
    here even when the caller skips canonicalize_cfg."""

    name = "entropy_sgd"

    def canonicalize_cfg(self, cfg):
        return dataclasses.replace(cfg, n_replicas=1, mode=self.name)

    def init(self, params, cfg):
        return super().init(params, self.canonicalize_cfg(cfg))

    def make_step(self, loss_fn, cfg, **kw):
        return super().make_step(loss_fn, self.canonicalize_cfg(cfg), **kw)

    def make_round_fn(self, loss_fn, cfg, **kw):
        return super().make_round_fn(loss_fn, self.canonicalize_cfg(cfg),
                                     **kw)

    def make_round_flush_fn(self, cfg, **kw):
        return super().make_round_flush_fn(self.canonicalize_cfg(cfg), **kw)


PARLE = register(ParleAlgorithm())
ENTROPY_SGD = register(EntropySGDAlgorithm())

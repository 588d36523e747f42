"""The ``Algorithm`` protocol for the Parle family.  Port of
``repro/core/algorithm.py``: ``parle``, ``entropy_sgd`` (= Parle with
n=1, §2.1/§3), ``elastic_sgd`` (Eq. 7, coupled every step) and ``sgd``
(data-parallel Nesterov SGD, the paper's §4 baseline).

  canonicalize_cfg(cfg)      -> cfg with the algorithm's invariants
                                applied (entropy_sgd forces n=1)
  init(params, cfg)          -> State
  make_step(loss_fn, cfg, *, weight_decay, use_kernel, lr_schedule)
                             -> step(state, batch) -> (state, metrics)
  make_round_fn(loss_fn, cfg, *, weight_decay, use_kernel, lr_schedule)
                             -> round(state, batches) -> (state, metrics):
                                L = cfg.L steps in one call (Parle: the
                                inner steps, then the sync); batches
                                leaves are (L, n, B, ...);
                                with cfg.sync_overlap the staleness-1
                                round (head first, then the inner steps)
  make_round_flush_fn(cfg, *, lr_schedule)
                             -> flush(state) -> state, the end-of-training
                                apply of the in-flight consensus; None
                                unless cfg.sync_overlap
  deployable(state)          -> the single servable param tree
  diagnostics(state)         -> dict of host floats (gamma, rho, overlap,
                                spread, where the algorithm has them)

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

from repro_torch.core import elastic_sgd, ensemble, parle
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


def _replica_diagnostics(flat) -> dict:
    return {"overlap": float(ensemble.replica_overlap(flat)),
            "spread": float(ensemble.replica_spread(flat))}


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
                **_replica_diagnostics(state.x)}


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


# ------------------------------------------------------------------
# Elastic-SGD (Eq. 7) — the per-step-coupling O(2nN) baseline
# ------------------------------------------------------------------

class ElasticSGDAlgorithm:
    name = "elastic_sgd"

    def canonicalize_cfg(self, cfg):
        return dataclasses.replace(cfg, mode=self.name)

    def init(self, params, cfg) -> elastic_sgd.ElasticState:
        return elastic_sgd.init(params, cfg)

    def make_step(self, loss_fn, cfg, *, weight_decay=0.0, use_kernel=False,
                  lr_schedule=None):
        return elastic_sgd.make_train_step(
            loss_fn, cfg, weight_decay=weight_decay, use_kernel=use_kernel,
            lr_schedule=resolve_lr_schedule(cfg, lr_schedule))

    def make_round_fn(self, loss_fn, cfg, *, weight_decay=0.0,
                      use_kernel=False, lr_schedule=None):
        return elastic_sgd.make_round_fn(
            loss_fn, cfg, weight_decay=weight_decay, use_kernel=use_kernel,
            lr_schedule=resolve_lr_schedule(cfg, lr_schedule))

    def make_round_flush_fn(self, cfg, *, lr_schedule=None):
        del cfg, lr_schedule    # per-step coupling: nothing in flight
        return None

    def deployable(self, state):
        return elastic_sgd.average_model(state)

    def diagnostics(self, state) -> dict:
        return {"rho": float(state.scopes.rho),
                **_replica_diagnostics(state.x)}


# ------------------------------------------------------------------
# SGD — the paper's §4 baseline; the replica axis is read as plain
# data-parallel shards (grads averaged every step)
# ------------------------------------------------------------------

class SGDAlgorithm:
    name = "sgd"

    def canonicalize_cfg(self, cfg):
        return dataclasses.replace(cfg, mode=self.name)

    def init(self, params, cfg) -> sgd.SGDState:
        del cfg
        return sgd.init(params)

    def make_step(self, loss_fn, cfg, *, weight_decay=0.0, use_kernel=False,
                  lr_schedule=None):
        del use_kernel      # one update stream; no kernel, as the reference
        return sgd.make_replica_train_step(
            loss_fn, cfg, weight_decay=weight_decay,
            lr_schedule=resolve_lr_schedule(cfg, lr_schedule))

    def make_round_fn(self, loss_fn, cfg, *, weight_decay=0.0,
                      use_kernel=False, lr_schedule=None):
        del use_kernel
        return sgd.make_round_fn(
            loss_fn, cfg, weight_decay=weight_decay,
            lr_schedule=resolve_lr_schedule(cfg, lr_schedule))

    def make_round_flush_fn(self, cfg, *, lr_schedule=None):
        del cfg, lr_schedule    # grads averaged every step: no sync debt
        return None

    def deployable(self, state):
        return state.layout.tree(state.params)

    def diagnostics(self, state) -> dict:
        del state
        return {}


PARLE = register(ParleAlgorithm())
ENTROPY_SGD = register(EntropySGDAlgorithm())
ELASTIC_SGD = register(ElasticSGDAlgorithm())
SGD = register(SGDAlgorithm())

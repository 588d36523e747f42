"""The ``Algorithm`` protocol for the Parle family.  Port of
``repro/core/algorithm.py``: ``parle``, ``entropy_sgd`` (= Parle with
n=1, §2.1/§3), ``elastic_sgd`` (Eq. 7, coupled every step) and ``sgd``
(data-parallel Nesterov SGD, the paper's §4 baseline).

  canonicalize_cfg(cfg)      -> cfg with the algorithm's invariants
                                applied (entropy_sgd forces n=1)
  init(params, cfg, group=None)
                             -> State (under a group: the rank's rows)
  make_step(loss_fn, cfg, *, weight_decay, use_kernel, lr_schedule)
                             -> step(state, batch) -> (state, metrics)
  make_sharded_step(loss_fn, cfg, mesh, *, ...)
                             -> the same step with the replica axis over
                                the ranks of ``mesh``, a ReplicaGroup
                                (sharding/partition.py); batches hold the
                                rank's k replicas
  make_round_fn(loss_fn, cfg, *, mesh=None, weight_decay, use_kernel,
                lr_schedule)
                             -> round(state, batches) -> (state, metrics):
                                L = cfg.L steps in one call (Parle: the
                                inner steps, then the sync); batches
                                leaves are (L, n, B, ...) (under a mesh,
                                (L, k, B, ...));
                                with cfg.sync_overlap the staleness-1
                                round (head first, then the inner steps)
  make_round_flush_fn(cfg, *, lr_schedule)
                             -> flush(state) -> state, the end-of-training
                                apply of the in-flight consensus; None
                                unless cfg.sync_overlap
  state_pspecs(replica_axis="pod", cfg=None, params=None,
               axis_sizes=None)
                             -> a prefix tree of the state (its top-level
                                fields, as in ``state.tree()``): the
                                replica axis's name for a field that
                                carries it (a rank holds its rows), None
                                for one every rank holds whole; with
                                ``params``, the planner form (a Spec
                                tree a field, ``sharding/partition.py``)
  deployable_row(state, group=None)
                             -> the single servable model as one row
                                (Parle: the mean over every rank's rows;
                                under axes inside a replica, the rank's
                                blocks of it)
  deployable(state, group=None)
                             -> that row as a param tree of whole leaves
  diagnostics(state, group=None)
                             -> dict of host floats (gamma, rho, overlap,
                                spread, where the algorithm has them;
                                under a group of ranks overlap and spread
                                are left out: they would gather the model)

Steps and rounds consume the state they are given (its buffers are
updated in place).  ``lr_schedule`` maps the step counter to a
MULTIPLIER on both lr and lr_inner; left None it is derived from
``cfg.lr_drop_steps``/``cfg.lr_drop_factor`` (the paper's §4 step
decay) by :func:`resolve_lr_schedule`.  :func:`validate_replicas` is
the reference trainer's check of ``--replicas`` against the mesh's
replica axis, with its messages.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core import elastic_sgd, ensemble, parle
from repro_torch.core.registry import register
from repro_torch.optim import sgd
from repro_torch.sharding import partition
from repro_torch.sharding.partition import distributed, replica_group


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


def _deployable(algo, state, group=None) -> dict:
    """``algo.deployable_row`` as a param tree of whole leaves (under
    axes inside a replica, its blocks gathered from the in-replica
    ranks)."""
    return parle.full_tree(algo.deployable_row(state, group), state.layout,
                           group)


def _replica_diagnostics(flat, group=None) -> dict:
    if distributed(group):
        return {}
    return {"overlap": float(ensemble.replica_overlap(flat)),
            "spread": float(ensemble.replica_spread(flat))}


def validate_replicas(algo: str, replicas: int, n: int, axis: str,
                      size: int):
    """Fail fast with a readable message when ``--replicas`` and the
    mesh's replica axis disagree (the reference trainer's
    ``_validate_replicas``).  ``replicas``: the flag (0 when not given);
    ``n``: the canonicalized count, so ``--algo entropy_sgd --mesh
    pod:2`` dies here with the fix spelled out."""
    if replicas and n != replicas and size != n:
        raise SystemExit(
            f"--algo {algo} canonicalizes --replicas "
            f"{replicas} to n_replicas={n}, which does not fit the "
            f"mesh replica axis {axis!r} of size {size}; use --algo "
            f"parle to keep {replicas} replicas, or a mesh with "
            f"{axis}:{n}")
    if n % size != 0:
        raise SystemExit(
            f"--replicas {n} is not divisible by the mesh replica axis "
            f"{axis!r} of size {size} (each device must hold a whole "
            f"number of replicas); pick a multiple of {size} or resize "
            f"the mesh")


class ParleAlgorithm:
    name = "parle"

    def canonicalize_cfg(self, cfg):
        return dataclasses.replace(cfg, mode=self.name)

    def init(self, params, cfg, group=None) -> parle.ParleState:
        return parle.init(params, cfg, group)

    def make_step(self, loss_fn, cfg, *, weight_decay=0.0, use_kernel=False,
                  lr_schedule=None):
        return parle.make_train_step(
            loss_fn, cfg, weight_decay=weight_decay, use_kernel=use_kernel,
            lr_schedule=resolve_lr_schedule(cfg, lr_schedule))

    def make_sharded_step(self, loss_fn, cfg, mesh, *, weight_decay=0.0,
                          use_kernel=False, lr_schedule=None):
        return parle.make_sharded_train_step(
            loss_fn, cfg, mesh, weight_decay=weight_decay,
            use_kernel=use_kernel,
            lr_schedule=resolve_lr_schedule(cfg, lr_schedule))

    def make_round_fn(self, loss_fn, cfg, *, mesh=None, weight_decay=0.0,
                      use_kernel=False, lr_schedule=None):
        overlap = getattr(cfg, "sync_overlap", False)
        kw = dict(weight_decay=weight_decay, use_kernel=use_kernel,
                  lr_schedule=resolve_lr_schedule(cfg, lr_schedule))
        if mesh is None:
            factory = (parle.make_overlap_round_fn if overlap
                       else parle.make_round_fn)
            return factory(loss_fn, cfg, **kw)
        factory = (parle.make_sharded_overlap_round_fn if overlap
                   else parle.make_sharded_round_fn)
        return factory(loss_fn, cfg, mesh, **kw)

    def make_round_flush_fn(self, cfg, *, lr_schedule=None):
        if not getattr(cfg, "sync_overlap", False):
            return None
        return parle.make_flush_fn(
            cfg, lr_schedule=resolve_lr_schedule(cfg, lr_schedule))

    def state_pspecs(self, replica_axis: str = "pod", cfg=None,
                     params=None, axis_sizes=None) -> dict:
        """x, y, z, both momenta and the residual ``e`` carry the replica
        axis; the step, the scopes and the in-flight consensus ``c`` do
        not (``repro/sharding/partition.py::parle_state_pspecs``).  With
        ``params``: the planner form."""
        if params is not None:
            return partition.parle_state_pspecs(replica_axis, params,
                                                axis_sizes, cfg)
        specs = {f: replica_axis for f in ("x", "y", "z", "v_y", "v_x")}
        specs.update(step=None, scopes=None)
        if cfg is not None and getattr(cfg, "sync_compress",
                                       "none") != "none":
            specs["e"] = replica_axis
        if cfg is not None and getattr(cfg, "sync_overlap", False):
            specs["c"] = None
        return specs

    def deployable_row(self, state, group=None):
        return parle.mean_row(state, group)

    deployable = _deployable

    def diagnostics(self, state, group=None) -> dict:
        return {"gamma": float(state.scopes.gamma),
                "rho": float(state.scopes.rho),
                **_replica_diagnostics(state.x, group)}


class EntropySGDAlgorithm(ParleAlgorithm):
    """Exactly Parle with n=1 (§2.1/§3); the n=1 invariant is enforced
    here even when the caller skips canonicalize_cfg."""

    name = "entropy_sgd"

    def canonicalize_cfg(self, cfg):
        return dataclasses.replace(cfg, n_replicas=1, mode=self.name)

    def init(self, params, cfg, group=None):
        return super().init(params, self.canonicalize_cfg(cfg), group)

    def make_step(self, loss_fn, cfg, **kw):
        return super().make_step(loss_fn, self.canonicalize_cfg(cfg), **kw)

    def make_sharded_step(self, loss_fn, cfg, mesh, **kw):
        self._single_replica(mesh)
        return super().make_sharded_step(loss_fn, self.canonicalize_cfg(cfg),
                                         mesh, **kw)

    def make_round_fn(self, loss_fn, cfg, *, mesh=None, **kw):
        if mesh is not None:
            self._single_replica(mesh)
        return super().make_round_fn(loss_fn, self.canonicalize_cfg(cfg),
                                     mesh=mesh, **kw)

    def make_round_flush_fn(self, cfg, **kw):
        return super().make_round_flush_fn(self.canonicalize_cfg(cfg), **kw)

    @staticmethod
    def _single_replica(mesh):
        """A replica axis above size 1 has nothing to shard at n = 1 (the
        reference's message)."""
        mesh = replica_group(mesh)
        if mesh.world != 1:
            raise ValueError(
                "entropy_sgd runs a single replica (Parle n=1), so a "
                f"replica-sharded mesh ({mesh.axis}:{mesh.world}) has "
                "nothing to shard — use --algo parle for n>1 replicas, or "
                "--algo sgd for plain data parallelism over the axis")


# ------------------------------------------------------------------
# Elastic-SGD (Eq. 7) — the per-step-coupling O(2nN) baseline
# ------------------------------------------------------------------

class ElasticSGDAlgorithm:
    name = "elastic_sgd"

    def canonicalize_cfg(self, cfg):
        return dataclasses.replace(cfg, mode=self.name)

    def init(self, params, cfg, group=None) -> elastic_sgd.ElasticState:
        return elastic_sgd.init(params, cfg, group)

    def make_step(self, loss_fn, cfg, *, weight_decay=0.0, use_kernel=False,
                  lr_schedule=None):
        return elastic_sgd.make_train_step(
            loss_fn, cfg, weight_decay=weight_decay, use_kernel=use_kernel,
            lr_schedule=resolve_lr_schedule(cfg, lr_schedule))

    def make_sharded_step(self, loss_fn, cfg, mesh, *, weight_decay=0.0,
                          use_kernel=False, lr_schedule=None):
        return elastic_sgd.make_sharded_train_step(
            loss_fn, cfg, mesh, weight_decay=weight_decay,
            use_kernel=use_kernel,
            lr_schedule=resolve_lr_schedule(cfg, lr_schedule))

    def make_round_fn(self, loss_fn, cfg, *, mesh=None, weight_decay=0.0,
                      use_kernel=False, lr_schedule=None):
        kw = dict(weight_decay=weight_decay, use_kernel=use_kernel,
                  lr_schedule=resolve_lr_schedule(cfg, lr_schedule))
        if mesh is None:
            return elastic_sgd.make_round_fn(loss_fn, cfg, **kw)
        return elastic_sgd.make_sharded_round_fn(loss_fn, cfg, mesh, **kw)

    def make_round_flush_fn(self, cfg, *, lr_schedule=None):
        del cfg, lr_schedule    # per-step coupling: nothing in flight
        return None

    def state_pspecs(self, replica_axis: str = "pod", cfg=None,
                     params=None, axis_sizes=None) -> dict:
        """The workers and their momentum carry the replica axis; the
        reference variable does not (``elastic_state_pspecs``).  With
        ``params``: the planner form."""
        del cfg
        if params is not None:
            return partition.elastic_state_pspecs(replica_axis, params,
                                                  axis_sizes)
        return {"x": replica_axis, "v": replica_axis, "ref": None,
                "step": None, "scopes": None}

    def deployable_row(self, state, group=None):
        # ref is on every rank (its blocks, inside a replica)
        return state.ref

    deployable = _deployable

    def diagnostics(self, state, group=None) -> dict:
        return {"rho": float(state.scopes.rho),
                **_replica_diagnostics(state.x, group)}


# ------------------------------------------------------------------
# SGD — the paper's §4 baseline; the replica axis is read as plain
# data-parallel shards (grads averaged every step)
# ------------------------------------------------------------------

class SGDAlgorithm:
    name = "sgd"

    def canonicalize_cfg(self, cfg):
        return dataclasses.replace(cfg, mode=self.name)

    def init(self, params, cfg, group=None) -> sgd.SGDState:
        del cfg             # one model on every rank (its blocks, inside
        return sgd.init(params, group)      # a replica)

    def make_step(self, loss_fn, cfg, *, weight_decay=0.0, use_kernel=False,
                  lr_schedule=None):
        del use_kernel      # one update stream; no kernel, as the reference
        return sgd.make_replica_train_step(
            loss_fn, cfg, weight_decay=weight_decay,
            lr_schedule=resolve_lr_schedule(cfg, lr_schedule))

    def make_sharded_step(self, loss_fn, cfg, mesh, *, weight_decay=0.0,
                          use_kernel=False, lr_schedule=None):
        del use_kernel
        return sgd.make_sharded_train_step(
            loss_fn, cfg, mesh, weight_decay=weight_decay,
            lr_schedule=resolve_lr_schedule(cfg, lr_schedule))

    def make_round_fn(self, loss_fn, cfg, *, mesh=None, weight_decay=0.0,
                      use_kernel=False, lr_schedule=None):
        del use_kernel
        kw = dict(weight_decay=weight_decay,
                  lr_schedule=resolve_lr_schedule(cfg, lr_schedule))
        if mesh is None:
            return sgd.make_round_fn(loss_fn, cfg, **kw)
        return sgd.make_sharded_round_fn(loss_fn, cfg, mesh, **kw)

    def make_round_flush_fn(self, cfg, *, lr_schedule=None):
        del cfg, lr_schedule    # grads averaged every step: no sync debt
        return None

    def state_pspecs(self, replica_axis: str = "pod", cfg=None,
                     params=None, axis_sizes=None) -> dict:
        """Nothing carries the replica axis: every rank holds the one
        model (``sgd_state_pspecs``).  With ``params``: the planner form
        (FSDP x TP over the in-replica axes)."""
        del replica_axis, cfg
        if params is not None:
            return partition.sgd_state_pspecs(params, axis_sizes)
        return {"params": None, "v": None, "step": None}

    def deployable_row(self, state, group=None):
        return state.params

    deployable = _deployable

    def diagnostics(self, state, group=None) -> dict:
        del state, group
        return {}


PARLE = register(ParleAlgorithm())
ENTROPY_SGD = register(EntropySGDAlgorithm())
ELASTIC_SGD = register(ElasticSGDAlgorithm())
SGD = register(SGDAlgorithm())

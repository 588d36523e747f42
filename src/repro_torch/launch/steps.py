"""Step functions shared by the trainer and the server.  Port of
``repro/launch/steps.py``.

 * ``make_algorithm_step`` / ``make_algorithm_round`` /
   ``make_algorithm_round_flush`` — the ONE training-step factory: any
   registered algorithm (parle, entropy_sgd, elastic_sgd, sgd) by name,
   via ``repro_torch.core.registry``, fronting the runtime's
   :func:`~repro_torch.runtime.policy_for` (barrier or overlap, from
   ``pcfg.sync_overlap``).  ``make_algorithm_sharded_step`` and
   ``make_algorithm_round(mesh=...)`` put the replica axis over the ranks
   of a ``torch.distributed`` group: ``mesh`` is a ``ReplicaGroup``
   (``sharding/partition.py``; ``launch/mesh.py::group_from_spec``), or a
   ``MeshGroups`` for a mesh with axes inside a replica (each rank then
   holds its shard of its replicas; ``launch/mesh.py::groups_from_spec``).
 * ``make_parle_steps`` — the Parle step decomposed into inner_step
   (8a-8b), sync_step (8c-8d) and their fused step.
 * ``make_prefill_step`` / ``make_decode_step`` — serving programs.

``remat`` (False, True or "dots") recomputes each block of the training
forward in the backward (``models/transformer.py::_remat``): less
activation memory for more compute, the same values bit for bit.
``use_flash=True`` routes full causal attention (the dense, moe, hybrid,
vlm and audio families) through the flash-attention kernel K3.  It is forward only, as in the
reference: ``make_prefill_step`` and ``Model.apply`` run it, and a
training step built with it raises at its backward.  The step functions
consume the state they are given (its buffers are updated in place).
"""
from __future__ import annotations

import torch

from repro_torch.core import parle as parle_mod
from repro_torch.core import registry
from repro_torch.models.model import build_model
from repro_torch.runtime import policy_for
from repro_torch.sharding.partition import active


def make_loss_fn(cfg, use_flash: bool = False, remat=False):
    return build_model(cfg, use_flash=use_flash, remat=remat).loss


def make_algorithm_step(algo_name: str, cfg, pcfg, weight_decay: float = 0.0,
                        use_flash: bool = False, remat=False,
                        use_kernel: bool = False, lr_schedule=None):
    """step(state, batch) -> (state, metrics) for any registered algo.
    ``batch`` leaves carry a leading replica axis of pcfg.n_replicas."""
    return policy_for(pcfg).make_step_fn(
        registry.get(algo_name), make_loss_fn(cfg, use_flash, remat), pcfg,
        weight_decay=weight_decay, use_kernel=use_kernel,
        lr_schedule=lr_schedule)


def make_algorithm_sharded_step(algo_name: str, cfg, pcfg, mesh,
                                weight_decay: float = 0.0,
                                use_flash: bool = False, remat=False,
                                use_kernel: bool = False, lr_schedule=None):
    """The step with the replica axis over the ranks of ``mesh`` (a
    ``ReplicaGroup`` or a ``MeshGroups``): ``batch`` leaves carry the
    rank's k replicas (each replica's whole batch: under a "data" axis
    the step takes the rank's rows)."""
    return policy_for(pcfg).make_step_fn(
        registry.get(algo_name), make_loss_fn(cfg, use_flash, remat), pcfg,
        mesh=mesh, weight_decay=weight_decay, use_kernel=use_kernel,
        lr_schedule=lr_schedule)


def make_algorithm_round(algo_name: str, cfg, pcfg, mesh=None,
                         weight_decay: float = 0.0, use_flash: bool = False,
                         remat=False, use_kernel: bool = False,
                         lr_schedule=None):
    """The fused L-step round for any registered algo: round(state,
    batches) -> (state, metrics) with batches leaves (L, n, B, ...)
    (with ``mesh``, a ``ReplicaGroup`` or a ``MeshGroups``: (L, k, B,
    ...))."""
    return policy_for(pcfg).make_round_fn(
        registry.get(algo_name), make_loss_fn(cfg, use_flash, remat), pcfg,
        mesh=mesh, weight_decay=weight_decay, use_kernel=use_kernel,
        lr_schedule=lr_schedule)


def make_algorithm_round_flush(algo_name: str, pcfg, lr_schedule=None):
    """The end-of-training pairing of the sync-overlap round: flush(state)
    -> state that applies the in-flight staleness-1 consensus once, or
    None when the algo/config has nothing in flight (barrier sync,
    elastic_sgd, sgd).  Call it on the FINAL state before eval/deploy —
    never on a state that will be checkpointed and resumed."""
    return policy_for(pcfg).make_flush_fn(registry.get(algo_name), pcfg,
                                          lr_schedule=lr_schedule)


def make_parle_steps(cfg, pcfg, weight_decay: float = 0.0,
                     use_flash: bool = False, remat=False,
                     use_kernel: bool = False, mesh=None):
    """(inner_step, sync_step, fused_step) of Parle over its flat state;
    inner_step and fused_step take batches with a leading replica axis.
    ``mesh`` (a ``ReplicaGroup`` or a ``MeshGroups``): the state and the
    batch hold the rank's replicas (its blocks of them under axes inside
    a replica, whose rows of the batch it takes), the losses are
    gathered over the replica axis each step and the sync's mean spans
    it, as in the sharded train step."""
    loss_fn = make_loss_fn(cfg, use_flash, remat)
    gbuf, shard = parle_mod.GradBuffer(), parle_mod.shard_grads_for(mesh)
    group = active(mesh)

    def grads(state, batch):
        losses = parle_mod.grads_at_y(loss_fn, state, batch, gbuf,
                                      weight_decay, shard)
        return losses if group is None else group.all_gather_rows(losses)

    def inner_step(state, batch):
        """(8a)-(8b): per-replica grad + update; no cross-replica term."""
        losses = grads(state, batch)
        state = parle_mod.inner_step(state, gbuf.buf, pcfg,
                                     use_kernel=use_kernel)
        return state, {"loss": losses.mean()}

    def sync_step(state):
        """(8c)-(8d): the one mean over the replica axis."""
        return parle_mod.sync_step(state, pcfg, group=group)

    def fused_step(state, batch):
        losses = grads(state, batch)
        state = parle_mod.fused_step(state, gbuf.buf, pcfg,
                                     use_kernel=use_kernel, group=group)
        return state, {"loss": losses.mean(), "gamma": state.scopes.gamma,
                       "rho": state.scopes.rho}

    return inner_step, sync_step, fused_step


def make_prefill_step(cfg, use_flash: bool = False):
    """prefill(params, batch, cache) -> (logits, cache), the cache
    written in place.  With ``use_flash`` the dense family's prompt
    attention runs K3."""
    model = build_model(cfg, use_flash=use_flash)

    @torch.no_grad()
    def prefill(params, batch, cache):
        return model.prefill(params, batch, cache)

    return prefill


def make_decode_step(cfg, sampling=None):
    """One-token decode + token selection through the serving sampler
    (greedy by default), the path the naive loop and the engine share."""
    from repro_torch.serving.sampling import (SamplingParams,
                                              make_token_selector)
    model = build_model(cfg)
    selector = make_token_selector(cfg, sampling or SamplingParams())

    @torch.no_grad()
    def decode(params, batch, cache, generator=None):
        logits, cache = model.decode(params, batch, cache)
        if generator is None:
            generator = torch.Generator(
                device=logits.device).manual_seed(0)
        return selector(logits, generator), cache

    return decode

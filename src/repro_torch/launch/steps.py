"""Step functions shared by the trainer and the server.  Port of
``repro/launch/steps.py``.

 * ``make_algorithm_step`` / ``make_algorithm_round`` /
   ``make_algorithm_round_flush`` — the ONE training-step factory: any
   registered algorithm (parle, entropy_sgd, elastic_sgd, sgd) by name,
   via ``repro_torch.core.registry``, fronting the runtime's
   :func:`~repro_torch.runtime.policy_for` (barrier or overlap, from
   ``pcfg.sync_overlap``).  ``make_algorithm_sharded_step`` and a
   ``mesh`` raise: the replica axis across devices is ROADMAP.md queue 1
   item 6.
 * ``make_parle_steps`` — the Parle step decomposed into inner_step
   (8a-8b), sync_step (8c-8d) and their fused step.
 * ``make_prefill_step`` / ``make_decode_step`` — serving programs.

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

_MESH_NOT_PORTED = ("the replica axis across devices (mesh / sharded "
                    "steps) is not ported yet (ROADMAP.md queue 1, item 6)")


def make_loss_fn(cfg, use_flash: bool = False):
    return build_model(cfg, use_flash=use_flash).loss


def make_algorithm_step(algo_name: str, cfg, pcfg, weight_decay: float = 0.0,
                        use_flash: bool = False, use_kernel: bool = False,
                        lr_schedule=None):
    """step(state, batch) -> (state, metrics) for any registered algo.
    ``batch`` leaves carry a leading replica axis of pcfg.n_replicas."""
    return policy_for(pcfg).make_step_fn(
        registry.get(algo_name), make_loss_fn(cfg, use_flash), pcfg,
        weight_decay=weight_decay, use_kernel=use_kernel,
        lr_schedule=lr_schedule)


def make_algorithm_sharded_step(algo_name: str, cfg, pcfg, mesh, **kw):
    """The reference's shard_map variant (replica axis over a mesh)."""
    raise NotImplementedError(_MESH_NOT_PORTED)


def make_algorithm_round(algo_name: str, cfg, pcfg, mesh=None,
                         weight_decay: float = 0.0, use_flash: bool = False,
                         use_kernel: bool = False, lr_schedule=None):
    """The fused L-step round for any registered algo: round(state,
    batches) -> (state, metrics) with batches leaves (L, n, B, ...)."""
    if mesh is not None:
        raise NotImplementedError(_MESH_NOT_PORTED)
    return policy_for(pcfg).make_round_fn(
        registry.get(algo_name), make_loss_fn(cfg, use_flash), pcfg,
        weight_decay=weight_decay, use_kernel=use_kernel,
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
                     use_flash: bool = False, use_kernel: bool = False):
    """(inner_step, sync_step, fused_step) of Parle over its flat state;
    inner_step and fused_step take batches with a leading replica axis."""
    loss_fn = make_loss_fn(cfg, use_flash)
    gbuf = parle_mod.GradBuffer()

    def grads(state, batch):
        return parle_mod.replica_grads(loss_fn, state.layout, state.y, batch,
                                       gbuf.like(state.y), weight_decay,
                                       state.y)

    def inner_step(state, batch):
        """(8a)-(8b): per-replica grad + update; no cross-replica term."""
        losses = grads(state, batch)
        state = parle_mod.inner_step(state, gbuf.buf, pcfg,
                                     use_kernel=use_kernel)
        return state, {"loss": losses.mean()}

    def sync_step(state):
        """(8c)-(8d): the one mean over the replica axis."""
        return parle_mod.sync_step(state, pcfg)

    def fused_step(state, batch):
        losses = grads(state, batch)
        state = parle_mod.fused_step(state, gbuf.buf, pcfg,
                                     use_kernel=use_kernel)
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

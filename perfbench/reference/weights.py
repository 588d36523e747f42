"""The weights and the seeds of a run, made by the benchmark.

A model type lists its leaves as ``Leaf(path, shape, init, scale)``;
``make_params`` draws all of them on the device from one
``torch.Generator`` seeded by the run's seed, in two large calls (one
normal draw, one uniform draw over one flat buffer each), and returns the
nested dict of views the program and the reference both read.
"""
from __future__ import annotations

import hashlib
import math
from typing import NamedTuple

import torch


class Leaf(NamedTuple):
    path: tuple          # keys into the nested param dict
    shape: tuple
    init: str            # normal | ones | log_uniform_dt | log_linspace
    scale: float = 1.0


def derive(seed: int, *tags) -> int:
    """A 63-bit seed for one use of the run's ``seed`` (a weight draw, a
    round's batches, the arrival order), so that no two uses share a
    stream."""
    h = hashlib.sha256(repr((int(seed),) + tags).encode()).digest()
    return int.from_bytes(h[:8], "little") >> 1


def numel(leaves) -> int:
    return sum(math.prod(l.shape) for l in leaves)


def make_params(leaves, seed: int, device, dtype=torch.float32) -> dict:
    """The param tree of ``leaves`` drawn from ``seed`` on ``device``.

    ``normal``: N(0, 1) times ``scale``; ``ones``: 1 + ``scale`` N(0, 1)
    (norm weights jittered, so a path that drops one is seen);
    ``log_uniform_dt``: softplus⁻¹ of a time step log-uniform in
    [1e-3, 1e-1] (Mamba2's dt bias); ``log_linspace``: log of a value
    uniform in [1, 16] (Mamba2's A_log)."""
    gen = torch.Generator(device=device).manual_seed(derive(seed, "weights"))
    normal = [l for l in leaves if l.init in ("normal", "ones")]
    uniform = [l for l in leaves if l.init not in ("normal", "ones")]
    tree = {}
    for group, draw in ((normal, "normal_"), (uniform, "uniform_")):
        if not group:
            continue
        flat = torch.empty(numel(group), dtype=torch.float32, device=device)
        getattr(flat, draw)(generator=gen)
        at = 0
        for leaf in group:
            n = math.prod(leaf.shape)
            v = flat[at:at + n].view(leaf.shape)
            at += n
            if leaf.init == "normal":
                v.mul_(leaf.scale)
            elif leaf.init == "ones":
                v.mul_(leaf.scale).add_(1.0)
            elif leaf.init == "log_uniform_dt":
                dt = torch.exp(v * (math.log(1e-1) - math.log(1e-3))
                               + math.log(1e-3))
                v.copy_(dt + torch.log(-torch.expm1(-dt)))
            elif leaf.init == "log_linspace":
                v.copy_(torch.log(1.0 + 15.0 * v))
            else:
                raise ValueError(f"unknown init {leaf.init!r}")
            node = tree
            for k in leaf.path[:-1]:
                node = node.setdefault(k, {})
            node[leaf.path[-1]] = v if dtype == torch.float32 else v.to(dtype)
        del flat
    return tree


def leaf_items(tree, prefix=()):
    """(path, tensor) of every leaf of a nested dict, in insertion order."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from leaf_items(v, prefix + (k,))
        else:
            yield prefix + (k,), v

"""``--mesh`` specs on a ``torch.distributed`` world.  Port of
``repro/launch/mesh.py``'s ``parse_mesh_spec``, ``replica_axis_of`` and
spec checks; the JAX mesh factories have no counterpart.

A spec names axes outermost first ("pod:2", "replica:4,data:1").  Its
replica axis ("pod", else "replica") maps onto the ranks of the current
``torch.distributed`` world, one rank per index of the axis
(:func:`group_from_spec`).  A replica axis of size 1 is the trivial
group and needs no world.  The axes inside a replica ("data", "model":
FSDP and tensor parallelism) are ROADMAP.md queue 1 item 6; a spec that
gives one a size above 1 raises.

A world is joined from the variables that ``python -m
torch.distributed.run`` and the pod launcher (``launch/dist_run.py``)
set — ``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT`` — on the
gloo backend, or is the one the caller already initialized.
"""
from __future__ import annotations

import os

import torch.distributed as dist

from repro_torch.sharding.partition import ReplicaGroup

REPLICA_AXES = ("pod", "replica")
LAUNCH_HINT = (
    "--mesh {spec} spans {size} ranks, and no torch.distributed world of "
    "{size} ranks is running: start one with `python -m "
    "torch.distributed.run --nproc-per-node {size} -m "
    "repro_torch.launch.train --mesh {spec} ...`, or use the pod launcher "
    "`python -m repro_torch.launch.dist_run --nproc {size} ...`")


def parse_mesh_spec(spec: str) -> dict:
    """Parse a ``--mesh`` flag: "replica:4" / "replica:2,data:4".

    Axis order in the string is the mesh axis order (outermost first).
    """
    out: dict = {}
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        name, _, size = part.partition(":")
        if not size:
            raise ValueError(f"mesh axis {part!r} needs a size: 'name:n'")
        if int(size) < 1:
            raise ValueError(f"mesh axis {part!r} needs a positive size")
        out[name.strip()] = int(size)
    if not out:
        raise ValueError(f"empty mesh spec {spec!r}")
    return out


def replica_axis_of(axes: dict):
    """The replica axis of a parsed spec ("pod", else "replica"), or
    None."""
    for name in REPLICA_AXES:
        if name in axes:
            return name
    return None


def mesh_size(spec: str) -> int:
    """The number of devices a spec spans (the product of its sizes)."""
    size = 1
    for s in parse_mesh_spec(spec).values():
        size *= s
    return size


def replica_axis(spec: str):
    """(axis name, size) of the spec's replica axis; raises for a spec
    without one, or with an axis inside a replica above size 1."""
    axes = parse_mesh_spec(spec)
    raxis = replica_axis_of(axes)
    if raxis is None:
        raise ValueError(f"--mesh {spec!r} has no replica axis")
    inner = {a: s for a, s in axes.items() if a != raxis and s > 1}
    if inner:
        raise ValueError(
            f"--mesh {spec!r}: the axes inside a replica ({inner}: FSDP / "
            "tensor parallelism) are not ported yet (ROADMAP.md queue 1, "
            "item 6); the replica axis spans the ranks of a "
            "torch.distributed world")
    return raxis, axes[raxis]


def join_world() -> bool:
    """Join the ``torch.distributed`` world the environment describes
    (gloo), unless one is initialized already.  Returns whether a world
    is up."""
    if dist.is_initialized():
        return True
    env = os.environ
    if not all(k in env for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR",
                                  "MASTER_PORT")):
        return False
    dist.init_process_group("gloo", rank=int(env["RANK"]),
                            world_size=int(env["WORLD_SIZE"]))
    return True


def group_from_spec(spec: str, n: int = 0, obs=None) -> ReplicaGroup:
    """The :class:`ReplicaGroup` of ``spec``'s replica axis over the
    current world (joined from the environment when needed), holding
    ``n`` replicas (0: one a rank).  The world must have exactly as many
    ranks as the axis; an axis of size 1 is the trivial group."""
    raxis, size = replica_axis(spec)
    n = n or size
    if size == 1:
        return ReplicaGroup(n, axis=raxis, obs=obs)
    if not join_world():
        raise RuntimeError(LAUNCH_HINT.format(spec=spec, size=size))
    world = dist.get_world_size()
    if world != size:
        raise ValueError(f"mesh {spec!r} needs {size} ranks, the "
                         f"torch.distributed world has {world}")
    return ReplicaGroup(n, dist.get_rank(), world, axis=raxis, obs=obs)

"""``--mesh`` specs on a ``torch.distributed`` world.  Port of
``repro/launch/mesh.py``'s ``parse_mesh_spec``, ``replica_axis_of``,
``make_mesh_from_spec``'s layout and its spec checks; its
``make_production_mesh`` is the two specs of :data:`PRODUCTION_MESHES`,
and :func:`dry_groups_from_spec` gives one rank's groups on such a mesh
with no world (the dry run's); the other JAX mesh factories have no
counterpart.

A spec names axes outermost first ("pod:2", "replica:2,data:2,model:2").
Its ranks are the world's, one for every point of the mesh, laid out in
the spec's order (rank = the row-major index of its coordinates, as the
reference reshapes its devices).  A spec whose axes inside a replica
("data", "model": FSDP and tensor parallelism) all have size 1 is the
replica axis alone (:func:`group_from_spec`: a ``ReplicaGroup``; size 1
is the trivial group and needs no world); with one above size 1,
:func:`groups_from_spec` gives the rank's ``MeshGroups``
(``sharding/partition.py``).  The world must have exactly as many ranks
as the spec's sizes multiply to: a mesh that cannot be formed raises, and
never runs on fewer ranks.

A world is joined from the variables that ``python -m
torch.distributed.run`` and the pod launcher (``launch/dist_run.py``)
set — ``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT`` — on the
gloo backend, or is the one the caller already initialized.
"""
from __future__ import annotations

import os

import torch.distributed as dist

from repro_torch.sharding.partition import (INNER_AXES, MeshGroups,
                                            ReplicaGroup, replica_axis_of)

LAUNCH_HINT = (
    "--mesh {spec} spans {size} ranks, and no torch.distributed world of "
    "{size} ranks is running: start one with `python -m "
    "torch.distributed.run --nproc-per-node {size} -m "
    "repro_torch.launch.train --mesh {spec} ...`")
# the pod launcher runs the replica axis alone
POD_HINT = (", or use the pod launcher `python -m "
            "repro_torch.launch.dist_run --nproc {size} ...`")
# the reference's production meshes: one pod of 16 x 16 chips, and two
PRODUCTION_MESHES = {"single": "data:16,model:16",
                     "multi": "pod:2,data:16,model:16"}


def production_mesh_spec(multi_pod: bool = False) -> str:
    """``make_production_mesh``'s mesh as a spec."""
    return PRODUCTION_MESHES["multi" if multi_pod else "single"]


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


def mesh_size(spec: str) -> int:
    """The number of devices a spec spans (the product of its sizes)."""
    size = 1
    for s in parse_mesh_spec(spec).values():
        size *= s
    return size


def replica_axis(spec: str):
    """(axis name, size) of the spec's replica axis; raises for a spec
    without one."""
    axes = parse_mesh_spec(spec)
    raxis = replica_axis_of(axes)
    if raxis is None:
        raise ValueError(f"--mesh {spec!r} has no replica axis")
    return raxis, axes[raxis]


def inner_axes(spec: str) -> dict:
    """{axis: size} of the spec's axes inside a replica above size 1."""
    axes = parse_mesh_spec(spec)
    raxis = replica_axis_of(axes)
    return {a: s for a, s in axes.items() if a != raxis and s > 1}


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


def _world_for(spec: str) -> int:
    """Join the world ``spec`` needs (all its ranks) and return its rank;
    raises with the launch hint when there is none, and when the world's
    size is not the spec's."""
    size = mesh_size(spec)
    if not join_world():
        hint = LAUNCH_HINT + ("" if inner_axes(spec) else POD_HINT)
        raise RuntimeError(hint.format(spec=spec, size=size))
    world = dist.get_world_size()
    if world != size:
        raise ValueError(f"mesh {spec!r} needs {size} ranks, the "
                         f"torch.distributed world has {world}")
    return dist.get_rank()


def group_from_spec(spec: str, n: int = 0, obs=None) -> ReplicaGroup:
    """The :class:`ReplicaGroup` of ``spec``'s replica axis over the
    current world (joined from the environment when needed), holding
    ``n`` replicas (0: one a rank).  The world must have exactly as many
    ranks as the axis; an axis of size 1 is the trivial group.  A spec
    with an axis inside a replica above size 1 needs
    :func:`groups_from_spec`."""
    raxis, size = replica_axis(spec)
    n = n or size
    if inner_axes(spec):
        raise ValueError(f"--mesh {spec!r} has axes inside a replica "
                         f"({inner_axes(spec)}): use groups_from_spec")
    if size == 1:
        return ReplicaGroup(n, axis=raxis, obs=obs)
    rank = _world_for(spec)
    return ReplicaGroup(n, rank, size, axis=raxis, obs=obs)


def groups_from_spec(spec: str, n: int = 0, obs=None):
    """The rank's groups for ``spec`` over the current world: a
    :class:`MeshGroups` when an axis inside a replica has more than one
    rank (the world must have the product of the sizes), else
    :func:`group_from_spec`'s ReplicaGroup."""
    inner = inner_axes(spec)
    if not inner:
        return group_from_spec(spec, n, obs)
    raxis, size = replica_axis(spec)
    bad = sorted(set(inner) - set(INNER_AXES))
    if bad:
        raise ValueError(f"--mesh {spec!r}: axes {bad} are not axes the "
                         f"planner assigns ({', '.join(INNER_AXES)})")
    rank = _world_for(spec)
    return MeshGroups(parse_mesh_spec(spec), n or size, rank, obs=obs)


def with_replica_axis(spec: str) -> dict:
    """The parsed ``spec``, a replica axis of size 1 put first when it
    has none (a mesh of one replica, as the reference's dry run reads a
    mesh without "pod")."""
    axes = parse_mesh_spec(spec) if isinstance(spec, str) else dict(spec)
    if replica_axis_of(axes) is None:
        axes = {"replica": 1, **axes}
    return axes


def dry_groups_from_spec(spec, n: int = 0, rank: int = 0,
                         policy: str = "fsdp_tp", obs=None):
    """Rank ``rank``'s groups on the mesh of ``spec`` (a spec or its
    parsed axes; a replica axis of size 1 added when it has none),
    holding ``n`` replicas (0: one a replica index), with no world: their
    collectives are counted, not run.  A ``MeshGroups`` when an axis
    inside a replica has more than one rank, else a ``ReplicaGroup``
    (None for one rank)."""
    axes = with_replica_axis(spec)
    raxis = replica_axis_of(axes)
    n = n or axes[raxis]
    if any(s > 1 for a, s in axes.items() if a != raxis):
        return MeshGroups(axes, n, rank, obs=obs, policy=policy, dry=True)
    if axes[raxis] == 1:
        return None
    return ReplicaGroup(n, rank, axes[raxis], axis=raxis, obs=obs, dry=True)

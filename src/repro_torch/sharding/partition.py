"""The Parle replica axis and the axes inside a replica over the ranks of
a ``torch.distributed`` process group, and the partition specs of the
sharding planner.  Port of ``repro/sharding/partition.py``: its spec
functions (:func:`param_pspecs`, :func:`parle_state_pspecs`, ...,
:func:`batch_pspecs`) give trees of :class:`~repro_torch.sharding.rules.Spec`;
its ``jit(shard_map)`` wrapper becomes :func:`make_sharded_step_fn`, and
GSPMD's placement inside a replica becomes :class:`MeshGroups`.

A :class:`ReplicaGroup` gives rank r of a world of W ranks the replica
rows ``[r k, (r + 1) k)`` of the n replicas (``k = n / W``).  Every
algorithm state of the port keeps only those k rows; what crosses the
ranks goes through the group's three operations:

* :meth:`ReplicaGroup.mean_rows` — the Eq. (8d) mean: the sum of the
  local rows, all-reduced with SUM, then divided by n (the arithmetic of
  ``core/parle.py::replica_mean``: with one row a rank, x0 + x1 then the
  division, bit for bit the single-process mean);
* :meth:`ReplicaGroup.all_gather_rows` — the rank-ordered concatenation
  of one or more tensors along dim 0, in ONE collective (their bytes are
  packed into one buffer): the bf16 / int8 sync payload, the per-replica
  losses;
* :meth:`ReplicaGroup.replica_means` — the means over the n replicas of
  a few per-replica values (a round's L step losses: once a round, so
  the inner steps never wait on the host), from one all-gather, so each
  mean reduces the n values in the single-process order.

A checkpoint adds a fourth, :meth:`ReplicaGroup.gather_rows`: every
rank's rows of each state leaf, gathered leaf by leaf into rank 0's host
memory (``dist.gather``, a :class:`GatherStage`) and handed to the
writer there, counted as ``op="gather"``; no rank's device holds
another's rows.  Under axes inside a replica,
:meth:`MeshGroups.gather_state` first gathers each leaf's blocks to the
replica's first in-replica rank, which assembles the whole leaf, then
runs the same replica-axis stage from those ranks.

Axes inside a replica (``--mesh replica:R,data:D,model:M``): a
:class:`MeshGroups` lays the world's R·D·M ranks out in the spec's axis
order, outermost first (rank = the row-major index of its coordinates,
as the reference reshapes its devices into the mesh).  The ranks that
share an in-replica coordinate form the replica subgroup — the ``pg`` of
the rank's ReplicaGroup, so the sync above runs unchanged at shard size —
and the D·M ranks of one replica index form the in-replica group, with
two operations, each ONE collective:

* :meth:`MeshGroups.gather_blocks` — every rank's blocks of a replica's
  row, all-gathered and assembled into the full row the forward reads
  (``utils/pytree.py::ShardedLayout``);
* :meth:`MeshGroups.reduce_grads` — a full grad row to the rank's shard:
  over "data" a SUM reduce-scatter (the data ranks took the grads of
  different batch rows), then the division by D; over "model" no
  reduction (every model rank computed the same grads: each takes its
  own blocks).

The backend is gloo, on the CPU and on the card alike (two ranks can
share one card, where NCCL refuses them).  A CUDA tensor is staged
through pinned host memory, one buffer per role, size and dtype, made at
its first use: device to host, the gloo call, host to device, each timed
and in a span (``pod.d2h``, ``pod.collective``, ``pod.h2d``).  Each
operation counts its calls and the bytes this rank contributes in the
``Obs`` registry, as ``pod.collectives{op=..., axis=...}`` and
``pod.collective_bytes{op=..., axis=...}`` (and, with the telemetry
armed, the three times in ``pod.d2h_ms`` / ``pod.collective_ms`` /
``pod.h2d_ms`` histograms); ``axis`` is the replica axis's name
("pod" / "replica") or the in-replica axes the collective spans
("data", "model", "data,model").

A world of one rank is the trivial group: it makes no collective (the
reference's size-1 replica axis runs with ``axis_name=None``), and the
algorithms take their single-process path under it.
"""
from __future__ import annotations

import contextlib
import itertools
import time
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.data.synthetic import data_rows
from repro_torch.sharding import planner as planner_mod
from repro_torch.sharding.rules import DATA, MODEL, Spec
from repro_torch.utils.pytree import (ColumnLayout, FlatLayout,
                                      ShardedLayout, tree_map,
                                      tree_leaves_with_paths)

def check_divisible(n_replicas: int, world: int, axis: str = "pod"):
    """Each rank holds a whole number of replicas (the reference's
    message)."""
    if n_replicas % world != 0:
        raise ValueError(
            f"n_replicas={n_replicas} not divisible by "
            f"mesh axis {axis!r} of size {world}")


class _Staged:
    """Pinned host staging and the counted, timed collectives of a group
    of ranks (``axis``: the label its collectives are counted under)."""

    axis = "pod"

    def _init_staging(self, obs, dry: bool = False):
        if obs is None:
            from repro_torch.obs import Obs
            obs = Obs()
        self.obs = obs
        self.dry = dry
        self._pinned: dict = {}

    def _host(self, key, numel: int, dtype) -> torch.Tensor:
        """A pinned host buffer of ``numel`` elements, made once per
        (key, numel, dtype)."""
        k = (key, numel, dtype)
        if k not in self._pinned:
            self._pinned[k] = torch.empty(numel, dtype=dtype,
                                          pin_memory=True)
        return self._pinned[k]

    def _staging(self, device, key, numel: int, dtype) -> torch.Tensor:
        """Where a collective's host side lives: a pinned buffer for a CUDA
        tensor, a fresh one on the CPU; for a dry group, one element
        stretched over ``numel`` on the ``meta`` device (never read)."""
        if self.dry:
            return torch.empty((), dtype=dtype, device="meta").expand(numel)
        if device.type == "cpu":
            return torch.empty(numel, dtype=dtype)
        return self._host(key, numel, dtype)

    def _collective(self, op: str, nbytes: int, d2h, call, h2d, axis=None):
        """Run one staged collective: ``d2h()`` -> host buffers, ``call``
        on them, ``h2d()`` back; count it and time its three parts.  A dry
        group only counts it."""
        axis = axis or self.axis
        reg, tracer = self.obs.registry, self.obs.tracer
        reg.counter("pod.collectives", op=op, axis=axis).inc()
        reg.counter("pod.collective_bytes", op=op, axis=axis).inc(nbytes)
        if self.dry:
            return
        t = [time.perf_counter()]
        for name, fn in (("pod.d2h", d2h), ("pod.collective", call),
                         ("pod.h2d", h2d)):
            with tracer.span(name, cat="sync", op=op, axis=axis,
                             bytes=nbytes):
                fn()
            t.append(time.perf_counter())
        if self.obs.enabled:
            for i, k in enumerate(("d2h_ms", "collective_ms", "h2d_ms")):
                reg.histogram(f"pod.{k}", op=op, axis=axis).observe(
                    (t[i + 1] - t[i]) * 1e3)

    def _all_reduce(self, buf: torch.Tensor, pg, axis=None,
                    segments=None, op=dist.ReduceOp.SUM) -> torch.Tensor:
        """All-reduce (``op``, SUM by default) the contiguous 1-D ``buf``
        in place over ``pg``.  ``segments``: the (offset, size) spans that
        carry data — only they move (packed into one buffer); the rest of
        ``buf`` is left as it is."""
        spans = segments if segments is not None else [(0, buf.numel())]
        total = sum(s for _, s in spans)
        whole = segments is None and buf.device.type == "cpu"
        host = (buf if whole else
                self._staging(buf.device, "reduce", total, buf.dtype))

        def d2h():
            if whole:
                return
            if buf.device.type != "cpu":
                torch.cuda.current_stream(buf.device).synchronize()
            at = 0
            for o, s in spans:
                host[at:at + s].copy_(buf[o:o + s])
                at += s

        def h2d():
            if whole:
                return
            at = 0
            for o, s in spans:
                buf[o:o + s].copy_(host[at:at + s])
                at += s

        self._collective("all_reduce", total * buf.element_size(), d2h,
                         lambda: dist.all_reduce(host, op=op, group=pg), h2d,
                         axis=axis)
        return buf

    def _all_gather(self, t: torch.Tensor, pg, size: int, axis=None,
                    key: str = "gather") -> torch.Tensor:
        """Every rank's ``t`` over ``pg`` (``size`` ranks), stacked in
        group rank order: ``(size, *t.shape)``, in ONE collective
        (``key``: the staging buffers' role)."""
        t = t.contiguous()
        dev, numel = t.device, t.numel()
        out = torch.empty((size,) + tuple(t.shape), dtype=t.dtype,
                          device=dev)
        send = (t.view(-1) if dev.type == "cpu" else
                self._staging(dev, f"{key}_send", numel, t.dtype))
        recv = (out.view(size, numel) if dev.type == "cpu" else
                self._staging(dev, f"{key}_recv", size * numel,
                              t.dtype).view(size, numel))

        def d2h():
            if dev.type != "cpu":
                torch.cuda.current_stream(dev).synchronize()
                send.copy_(t.view(-1))

        def h2d():
            if dev.type != "cpu":
                out.view(size, numel).copy_(recv)

        # moved as bytes: gloo gathers any dtype that way
        self._collective(
            "all_gather", numel * t.element_size(), d2h,
            lambda: dist.all_gather(list(recv.view(torch.uint8).unbind(0)),
                                    send.view(torch.uint8), group=pg),
            h2d, axis=axis)
        return out

    def _reduce_scatter(self, parts: torch.Tensor, pg,
                        axis=None) -> torch.Tensor:
        """``parts`` ``(size, *shape)`` -> the SUM over ``pg``'s ranks of
        their ``parts[i]``, i this rank's index in ``pg``: ``shape``, in
        ONE collective (counted at the bytes of ``parts``)."""
        parts = parts.contiguous()
        size, shape = parts.shape[0], tuple(parts.shape[1:])
        dev, numel = parts.device, parts[0].numel()
        out = torch.empty(shape, dtype=parts.dtype, device=dev)
        send = (parts.view(-1) if dev.type == "cpu" else
                self._staging(dev, "scatter_send", size * numel, parts.dtype))
        recv = (out.view(-1) if dev.type == "cpu" else
                self._staging(dev, "scatter_recv", numel, parts.dtype))

        def d2h():
            if dev.type != "cpu":
                torch.cuda.current_stream(dev).synchronize()
                send.copy_(parts.view(-1))

        def h2d():
            if dev.type != "cpu":
                out.view(-1).copy_(recv)

        self._collective(
            "reduce_scatter", size * numel * parts.element_size(), d2h,
            lambda: dist.reduce_scatter_tensor(recv, send, group=pg), h2d,
            axis=axis)
        return out


class ReplicaGroup(_Staged):
    """Rank ``rank`` of ``world`` ranks holding rows ``rows`` of the
    ``n`` replicas.  ``pg``: the ``torch.distributed`` process group
    (None: the default group); ``obs``: the ``Obs`` bundle whose registry
    and tracer record the collectives (None: a private registry, no
    spans); ``dry``: a group of no world, whose collectives are counted
    and not run (the dry run's, ``launch/dryrun.py``)."""

    def __init__(self, n: int, rank: int = 0, world: int = 1, *,
                 axis: str = "pod", pg=None, obs=None, dry: bool = False):
        check_divisible(n, world, axis)
        self.n, self.rank, self.world, self.axis = n, rank, world, axis
        self.local = n // world
        self.rows = slice(rank * self.local, (rank + 1) * self.local)
        self.pg = pg
        self._init_staging(obs, dry)

    @property
    def trivial(self) -> bool:
        return self.world == 1

    # -- operations ---------------------------------------------------
    def all_reduce_(self, buf: torch.Tensor, segments=None) -> torch.Tensor:
        """SUM-all-reduce the contiguous ``buf`` in place across the
        ranks (the trivial group: no collective).  ``segments``: only
        these (offset, size) spans of the flat ``buf`` move."""
        if self.trivial:
            return buf
        self._all_reduce(buf.view(-1), self.pg, segments=segments)
        return buf

    def mean_rows(self, x_local: torch.Tensor, out=None,
                  segments=None) -> torch.Tensor:
        """(k, M) local rows -> the (M,) mean over all n replicas: the
        local sum, all-reduced with SUM, divided by n.  ``out``: an (M,)
        buffer to write it into; ``segments``: the spans of a row that
        carry data (a ``ShardedLayout``'s blocks: the gaps stay zero)."""
        s = torch.sum(x_local, 0, out=out)
        return self.all_reduce_(s, segments).div_(self.n)

    def replica_means(self, local: torch.Tensor) -> torch.Tensor:
        """``local`` (k, L): this rank's replicas' values of L small
        quantities (a round's per-step losses) -> their (L,) means over
        all n replicas.  One all-gather, then each mean is taken over a
        contiguous (n,) vector in replica order — the single-process
        reduction, so the means agree bit for bit at any k."""
        per = self.all_gather_rows(local).t().contiguous()     # (L, n)
        return torch.stack([row.mean() for row in per])

    def all_gather_rows(self, *ts):
        """Each t (k, ...) -> (n, ...), the ranks' rows in rank order, all
        of ``ts`` in ONE collective: their bytes are packed into one
        buffer.  Returns one tensor, or a tuple for several."""
        if self.trivial:
            return ts[0] if len(ts) == 1 else ts
        flats = [t.contiguous().view(-1).view(torch.uint8) for t in ts]
        sizes = [f.numel() for f in flats]
        total = sum(sizes)
        dev = ts[0].device
        send = self._staging(dev, "gather_send", total, torch.uint8)
        recv = self._staging(dev, "gather_recv", self.world * total,
                             torch.uint8).view(self.world, total)
        outs = [torch.empty((self.n,) + tuple(t.shape[1:]), dtype=t.dtype,
                            device=t.device) for t in ts]

        def d2h():
            if dev.type != "cpu":
                torch.cuda.current_stream(dev).synchronize()
            off = 0
            for f, sz in zip(flats, sizes):
                send[off:off + sz].copy_(f)
                off += sz

        def h2d():
            for w in range(self.world):
                off = 0
                for o, sz in zip(outs, sizes):
                    o.view(-1).view(torch.uint8)[w * sz:(w + 1) * sz].copy_(
                        recv[w, off:off + sz])
                    off += sz

        self._collective(
            "all_gather", total, d2h,
            lambda: dist.all_gather(list(recv.unbind(0)), send,
                                         group=self.pg), h2d)
        return outs[0] if len(outs) == 1 else tuple(outs)

    def gather_rows(self, leaves, each=None) -> None:
        """Each local (k, ...) leaf -> every rank's rows in rank order, an
        (n, ...) host tensor on rank 0, handed to ``each(i, rows)`` there
        (in a buffer the next leaf reuses: ``each`` consumes it before it
        returns): one :class:`GatherStage` over the group."""
        with GatherStage(self, self.axis, self.pg, self.world, 0,
                         self.rank == 0, leaves) as stage:
            for i, t in enumerate(leaves):
                parts = stage.gather(t)
                if each is not None:
                    each(i, parts.view(t.dtype).view(
                        (self.n,) + tuple(t.shape[1:])))

    def barrier(self) -> None:
        """Every rank waits for every other (not counted: it moves no
        data)."""
        if not self.trivial and not self.dry:
            dist.barrier(group=self.pg)

    def counts(self) -> dict:
        """{op: (calls, bytes)} of this rank's collectives so far."""
        return collective_counts(self.obs.registry)


class GatherStage:
    """One stage of a checkpoint's gather: every rank of the group ``pg``
    (``size`` ranks) hands its tensor of each leaf in turn
    (:meth:`gather`), and world rank ``dst`` (``root``: this rank is it)
    gets the ranks' bytes of it in group rank order.  One
    ``dist.gather`` a leaf through host buffers of the largest leaf's
    bytes (pinned for CUDA leaves), never through the device, so no
    rank's device memory grows with the ranks.  ``leaves``: the tensors
    (or their shapes and dtypes) this rank will hand, for the sizes.

    Counted once, on entry, as one ``gather`` of this rank's bytes on
    ``axis`` (``pod.collectives`` / ``pod.collective_bytes``), in one
    ``pod.gather`` span whose ``gather_s`` is the time of the copies and
    the gloo calls (what the caller does with each leaf excluded)."""

    def __init__(self, staged: _Staged, axis: str, pg, size: int, dst: int,
                 root: bool, leaves):
        self.staged, self.axis, self.pg = staged, axis, pg
        self.size, self.dst, self.root = size, dst, root
        sizes = [t.numel() * t.element_size() for t in leaves]
        self.nbytes, most = sum(sizes), max(sizes, default=1)
        self.cuda = {t.device for t in leaves if t.device.type == "cuda"}
        self.send = (staged._host("ckpt_send", most, torch.uint8)
                     if self.cuda else torch.empty(most, dtype=torch.uint8))
        self.recv = (torch.empty(size * most, dtype=torch.uint8) if root
                     else None)
        self.spent = 0.0

    def __enter__(self):
        reg = self.staged.obs.registry
        reg.counter("pod.collectives", op="gather", axis=self.axis).inc()
        reg.counter("pod.collective_bytes", op="gather",
                    axis=self.axis).inc(self.nbytes)
        self.span = self.staged.obs.tracer.span(
            "pod.gather", cat="sync", op="gather", axis=self.axis,
            bytes=self.nbytes).__enter__()
        for dev in self.cuda:
            torch.cuda.current_stream(dev).synchronize()
        return self

    def __exit__(self, *exc):
        self.span.set(gather_s=round(self.spent, 3))
        self.span.__exit__(*exc)
        if self.staged.obs.enabled:
            self.staged.obs.registry.histogram(
                "pod.collective_ms", op="gather",
                axis=self.axis).observe(self.spent * 1e3)
        return False

    def buffer(self, dtype, shape) -> torch.Tensor:
        """The send buffer as a ``shape`` tensor of ``dtype``, to be
        filled in place and handed to :meth:`gather` with ``filled``."""
        nbytes = torch.Size(shape).numel() * dtype.itemsize
        return self.send[:nbytes].view(dtype).view(shape)

    def gather(self, t, filled: bool = False):
        """This rank's ``t`` -> on the root, a ``(size, bytes)`` uint8
        view of every rank's bytes of it in group rank order (in a buffer
        the next leaf reuses); None elsewhere.  ``filled``: ``t`` is the
        :meth:`buffer` view, already in place."""
        t0 = time.perf_counter()
        sz = t.numel() * t.element_size()
        if not filled:
            self.send[:sz].view(t.dtype).view(t.shape).copy_(t)
        parts = None
        if self.root:
            parts = self.recv[:self.size * sz].view(self.size, sz)
        dist.gather(self.send[:sz], gather_list=None if parts is None
                    else list(parts.unbind(0)), dst=self.dst, group=self.pg)
        self.spent += time.perf_counter() - t0
        return parts


def _counter_series(registry):
    for c in registry.snapshot()["counters"]:
        if c["name"] in ("pod.collectives", "pod.collective_bytes"):
            yield c, c["name"] == "pod.collective_bytes"


def collective_counts(registry) -> dict:
    """{op: (calls, bytes)} of the ``pod.collectives`` /
    ``pod.collective_bytes`` counters of an ``Obs`` registry, summed over
    their ``axis`` labels."""
    out = {}
    for c, is_bytes in _counter_series(registry):
        out.setdefault(c["labels"]["op"], [0, 0])[is_bytes] += c["total"]
    return {k: tuple(v) for k, v in out.items()}


def collective_counts_by_axis(registry) -> dict:
    """{axis: {op: (calls, bytes)}} of the same counters: what each mesh
    axis carried."""
    out: dict = {}
    for c, is_bytes in _counter_series(registry):
        lab = c["labels"]
        out.setdefault(lab.get("axis", "pod"), {}).setdefault(
            lab["op"], [0, 0])[is_bytes] += c["total"]
    return {a: {op: tuple(v) for op, v in ops.items()}
            for a, ops in out.items()}


# ------------------------------------------------------------------
# Axes inside a replica: the composed mesh over the ranks of a world
# ------------------------------------------------------------------

REPLICA_AXES = ("pod", "replica")
INNER_AXES = (DATA, MODEL)


def replica_axis_of(axes: dict):
    """The replica axis of a parsed spec ("pod", else "replica"), or
    None."""
    for name in REPLICA_AXES:
        if name in axes:
            return name
    return None


def mesh_coords(axes: dict, rank: int) -> dict:
    """{axis: index} of ``rank`` in the mesh of ``axes`` (a parsed spec):
    the ranks are the row-major indices of their coordinates, in the
    spec's axis order (the reference's device reshape)."""
    out, rest = {}, rank
    for name, size in reversed(list(axes.items())):
        out[name], rest = rest % size, rest // size
    return {a: out[a] for a in axes}


def mesh_rank(axes: dict, coords: dict) -> int:
    """Inverse of :func:`mesh_coords` (an axis left out: index 0)."""
    r = 0
    for name, size in axes.items():
        r = r * size + coords.get(name, 0)
    return r


class MeshGroups:
    """Rank ``rank`` of the R·D·M ranks of a ``--mesh replica:R,data:D,
    model:M`` world (``axes``: the parsed spec, outermost axis first; the
    replica axis may be "pod"), holding ``n`` replicas.

    * ``coords``: the rank's index on every axis (rank = their row-major
      index in the spec's axis order);
    * ``replica``: the :class:`ReplicaGroup` over the replica subgroup at
      the rank's in-replica coordinate (its rank: the replica index) —
      the algorithms' sync and loss gathers run on it unchanged;
    * the in-replica group (the D·M ranks of the rank's replica index, in
      rank order) with :meth:`gather_blocks`, and the data group (the D
      ranks that differ only in "data") with :meth:`reduce_grads`;
    * :meth:`layout`: the :class:`~repro_torch.utils.pytree.ShardedLayout`
      of a param tree for this rank (the planner's ``fsdp_tp`` policy,
      the reference train CLI's).

    Building one is collective: every rank of the world creates every
    subgroup, in one order.  A group of one rank makes no collective.
    The state a rank holds is its replicas' blocks; every operation is
    counted under ``pod.collectives{op, axis}``.  ``policy``: the
    planner policy of the layout; ``dry``: rank ``rank`` of no world
    (no subgroup is made, every collective is counted and not run: the
    dry run's, ``launch/dryrun.py``)."""

    def __init__(self, axes: dict, n: int, rank: int = 0, *, obs=None,
                 policy: str = "fsdp_tp", dry: bool = False):
        raxis = replica_axis_of(axes)
        if raxis is None:
            raise ValueError(f"mesh {axes} has no replica axis")
        bad = [a for a, s in axes.items()
               if a != raxis and a not in INNER_AXES and s > 1]
        if bad:
            raise ValueError(f"mesh axes {bad} are not axes the planner "
                             f"assigns ({', '.join(INNER_AXES)})")
        self.axes = dict(axes)
        self.world = 1
        for s in axes.values():
            self.world *= s
        self.rank = rank
        self.coords = mesh_coords(self.axes, rank)
        self.inner_sizes = {a: s for a, s in axes.items() if a != raxis}
        self.inner_axes = planner_mod.in_replica_axes(axes, raxis)
        self.data_size = axes.get(DATA, 1)
        self.dry = dry
        self.ctx = planner_mod.ShardContext(self.inner_sizes, policy)
        R = axes[raxis]
        inner_coords = [dict(zip(self.inner_sizes, idx)) for idx in
                        itertools.product(*[range(s) for s in
                                            self.inner_sizes.values()])]
        # in-replica group rank order = global rank order
        inner_coords.sort(key=lambda c: mesh_rank(self.axes, c))
        self.inner_coords = inner_coords
        mine = {a: self.coords[a] for a in self.inner_sizes}
        self.inner_index = inner_coords.index(mine)
        self.data_index = self.coords.get(DATA, 0)

        # every rank makes every subgroup, in one order
        replica_pg = inner_pg = data_pg = None
        for c in inner_coords:
            pg = self._new_group([mesh_rank(self.axes, {**c, raxis: r})
                                  for r in range(R)])
            if c == mine:
                replica_pg = pg
        for r in range(R):
            pg = self._new_group([mesh_rank(self.axes, {**c, raxis: r})
                                  for c in inner_coords])
            if r == self.coords[raxis]:
                inner_pg = pg
        for r in range(R):
            for c in inner_coords:
                if c.get(DATA, 0):
                    continue
                ranks = [mesh_rank(self.axes, {**c, raxis: r, DATA: d})
                         for d in range(self.data_size)]
                pg = self._new_group(ranks)
                if self.rank in ranks:
                    data_pg = pg
        self.inner_pg, self.data_pg = inner_pg, data_pg
        self._model_pg = None
        self.replica = ReplicaGroup(n, self.coords[raxis], R, axis=raxis,
                                    pg=replica_pg, obs=obs, dry=dry)
        self.inner = _InReplica(self, obs=self.replica.obs)

    def _new_group(self, ranks):
        """A gloo subgroup of ``ranks`` (None for a group of one rank or
        the whole world, or in a dry group: no subgroup needed)."""
        if len(ranks) == 1 or len(ranks) == self.world or self.dry:
            return None
        return dist.new_group(ranks, backend="gloo")

    @property
    def model_pg(self):
        """The group of the ranks that differ from this one only in
        "model", made at its first use (by every rank at once, as every
        subgroup: the expert-parallel MoE's first forward)."""
        if self._model_pg is None:
            if self.inner_axes == (MODEL,):
                self._model_pg = (self.inner_pg,)
            else:
                raxis, M = self.replica.axis, self.axes.get(MODEL, 1)
                for r in range(self.replica.world):
                    for c in self.inner_coords:
                        if c.get(MODEL, 0):
                            continue
                        ranks = [mesh_rank(self.axes,
                                           {**c, raxis: r, MODEL: m})
                                 for m in range(M)]
                        pg = self._new_group(ranks)
                        if self.rank in ranks:
                            self._model_pg = (pg,)
        return self._model_pg[0]

    # -- what the ReplicaGroup-taking code reads --------------------
    @property
    def trivial(self) -> bool:
        return self.world == 1

    @property
    def sharded(self) -> bool:
        """Whether any axis inside a replica has more than one rank."""
        return bool(self.inner_axes)

    @property
    def n(self):
        return self.replica.n

    @property
    def local(self):
        return self.replica.local

    @property
    def rows(self):
        return self.replica.rows

    @property
    def axis(self):
        return self.replica.axis

    @property
    def obs(self):
        return self.replica.obs

    def counts(self) -> dict:
        return collective_counts(self.obs.registry)

    # -- in-replica operations --------------------------------------
    def layout(self, params) -> ShardedLayout:
        """This rank's ShardedLayout of the single-model ``params``."""
        return ShardedLayout(params, self.ctx, self.inner_coords,
                             self.inner_index)

    def data_rows(self, batch_size: int) -> slice:
        """This rank's rows of a replica's batch of ``batch_size`` rows:
        its 1/D over "data" when D divides it (:func:`batch_pspecs`),
        else all of them."""
        return data_rows(batch_size, self.data_size, self.data_index)

    def gather_blocks(self, local_row, full_row, layout: ShardedLayout):
        """Every in-replica rank's ``local_row`` (this rank's blocks of one
        replica, ``(layout.numel,)``) assembled into ``full_row`` (the
        FlatLayout row of ``layout.full``): one all-gather."""
        return self.inner.gather_blocks(local_row, full_row, layout)

    def reduce_grads(self, full_grad, out, layout: ShardedLayout,
                     split: bool):
        """A replica's full grads — a FlatLayout row, or the list of its
        leaf grads — -> this rank's shard grad row ``out``.  ``split``: the data ranks took the grads of different
        rows of the batch, so their grads are summed (one reduce-scatter
        over "data") and divided by D; otherwise each rank takes its own
        blocks (no collective)."""
        if split and self.data_size > 1:
            return self.inner.reduce_scatter_grads(full_grad, out, layout)
        return layout.scatter_grads(full_grad, out)

    def barrier(self) -> None:
        """Every rank of the world waits for every other."""
        if not self.trivial and not self.dry:
            dist.barrier()

    def gather_state(self, leaves, layout: ShardedLayout, each=None):
        """A checkpoint's gather of a state held on this mesh: each leaf
        whole, in turn, on world rank 0, handed to ``each(i, t)`` there
        (a host tensor in a buffer the next leaf reuses).

        ``leaves``: ``[(t, block, rows)]``, this rank's tensor of each
        leaf; ``block``: the ``layout`` index of the leaf whose blocks
        ``t`` holds (behind its leading dims), or None for a leaf every
        rank holds whole (rank 0's own is handed on); ``rows``: whether
        the leaf carries the replica axis (``t``'s first dim: the rank's
        k replicas).  Two :class:`GatherStage`\\ s, leaf by leaf:

        1. over the in-replica group, every rank's blocks to the
           replica's first in-replica rank, which assembles the whole
           leaf (``ShardedLayout.gather_leaf_into``: a block several
           ranks hold is read from one);
        2. on those first ranks, the whole k rows over the replica
           subgroup at in-replica coordinate 0 to world rank 0, as
           :meth:`ReplicaGroup.gather_rows` gathers them.

        A leaf without the replica axis takes stage 1 in replica 0
        only.  Each stage is counted once on each rank that takes it,
        under its axis."""
        raxis = self.replica.axis
        first = self.inner_index == 0
        home = mesh_rank(self.axes, {**self.inner_coords[0],
                                     raxis: self.coords[raxis]})
        G, R = len(self.inner_coords), self.replica.world

        def whole(i):               # leaf i whole: a meta tensor
            t, b, _ = leaves[i]
            lead = tuple(t.shape[:t.dim() - len(layout.shapes[b])])
            return torch.empty(lead + tuple(layout.full.shapes[b]),
                               dtype=t.dtype, device="meta")

        def stage(group, axis, pg, size, dst, root, ts):
            return (GatherStage(group, axis, pg, size, dst, root, ts) if ts
                    else contextlib.nullcontext())

        mine = [i for i, (_, b, rows) in enumerate(leaves)
                if b is not None and (rows or self.replica.rank == 0)]
        up = [i for i in mine if leaves[i][2] and R > 1] if first else []
        inner = stage(self.inner, self.inner.axis, self.inner_pg, G, home,
                      first, [leaves[i][0] for i in mine])
        across = stage(self.replica, raxis, self.replica.pg, R, 0,
                       self.rank == 0, [whole(i) for i in up])
        # rank 0 assembles the leaves that skip stage 2 in a buffer here
        alone = ([whole(i) for i in mine if i not in set(up)]
                 if self.rank == 0 else [])
        scratch = torch.empty(max([m.numel() * m.element_size()
                                   for m in alone] + [1]), dtype=torch.uint8)
        mine, up = set(mine), set(up)
        hand = each or (lambda i, t: None)
        with inner, across:
            for i, (t, b, rows) in enumerate(leaves):
                if b is None:
                    if self.rank == 0:
                        hand(i, t)
                    continue
                if i not in mine:
                    continue
                parts = inner.gather(t)
                if not first:
                    continue
                blocks = parts.view(t.dtype).view((G,) + tuple(t.shape))
                shape = whole(i).shape
                if i in up:
                    full = across.buffer(t.dtype, shape)
                    layout.gather_leaf_into(b, blocks, full)
                    got = across.gather(full, filled=True)
                    if got is not None:
                        hand(i, got.view(t.dtype).view(
                            (self.n,) + tuple(shape[1:])))
                elif self.rank == 0:
                    full = scratch[:shape.numel() * t.element_size()] \
                        .view(t.dtype).view(shape)
                    layout.gather_leaf_into(b, blocks, full)
                    hand(i, full)

    def model_sum_(self, t: torch.Tensor) -> torch.Tensor:
        """SUM-all-reduce the contiguous ``t`` in place over the ranks that
        differ from this one only in "model" (a split product's partial
        sums), counted on axis "model"."""
        if self.model_size > 1:
            self.inner._all_reduce(t.view(-1), self.model_pg, axis=MODEL)
        return t

    # -- the Megatron split over "model" (models/megatron.py) ----------
    @property
    def model_size(self) -> int:
        return self.axes.get(MODEL, 1)

    @property
    def model_index(self) -> int:
        return self.coords.get(MODEL, 0)

    def copy_to_model(self, x: torch.Tensor) -> torch.Tensor:
        """Identity forward; backward, the grad summed over "model" (one
        all-reduce): the entry of a split region."""
        return _CopyToModel.apply(x, self)

    def reduce_from_model(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` summed over "model" (one all-reduce) forward; identity
        backward: the exit of a split region."""
        return _ReduceFromModel.apply(x, self)

    def gather_from_model(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """Every "model" rank's ``x`` concatenated along ``dim`` in "model"
        order (one all-gather) forward; backward, this rank's slice of the
        grad (the rest of the region reads the gathered tensor the same
        on every "model" rank)."""
        return _GatherFromModel.apply(x, self, dim)

    def gather_summed_from_model(self, x: torch.Tensor,
                                 dim: int) -> torch.Tensor:
        """Every "model" rank's ``x`` concatenated along ``dim`` (one
        all-gather) forward; backward, every "model" rank's grad of this
        rank's slice summed (one reduce-scatter): a gathered tensor that
        each rank reads in parts of its own."""
        return _GatherSummedFromModel.apply(x, self, dim)

    def model_max_(self, t: torch.Tensor) -> torch.Tensor:
        """The elementwise max over "model" of the contiguous ``t``, in
        place (no grad: a softmax's shift)."""
        if self.model_size > 1:
            self.inner._all_reduce(t.view(-1), self.model_pg, axis=MODEL,
                                   op=dist.ReduceOp.MAX)
        return t

    def data_gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every "data" rank's ``t`` of this rank's other coordinates,
        stacked in "data" order: ``(D, *t.shape)``, one all-gather (no
        grad: the MoE's per-rank expert counts)."""
        if self.data_size == 1:
            return t[None]
        return self.inner._all_gather(t, self.data_pg, self.data_size,
                                      axis=DATA)

    def column_layout(self, layout: ShardedLayout, cfg) -> ColumnLayout:
        """The :class:`~repro_torch.utils.pytree.ColumnLayout` of
        ``layout`` (this rank's) for ``cfg``'s Megatron split."""
        from repro_torch.models import megatron
        dims = [megatron.leaf_split_dim(cfg, self.model_size, p)
                for p in layout.paths]
        return ColumnLayout(layout, dims, MODEL, DATA)

    def gather_columns(self, local_row, row, clay: ColumnLayout):
        """This rank's blocks of one replica (``local_row``) -> its compute
        ``row`` (``clay.flat``): the data ranks' blocks (one all-gather
        over "data"), then the columns of the leaves ``clay`` gathers
        whole (one all-gather over "model", only where it has such
        leaves)."""
        if self.data_size > 1:
            blocks = self.inner._all_gather(local_row, self.data_pg,
                                            self.data_size, axis=DATA,
                                            key="block")
        else:
            blocks = local_row[None]
        clay.assemble(blocks, row)
        if clay.gathered:
            views = clay.flat.views(row)
            mine = torch.cat([clay.column_of(i, views[i], self.model_index)
                              .reshape(-1) for i in clay.gathered])
            got = self.inner._all_gather(mine, self.model_pg,
                                         self.model_size, axis=MODEL)
            for m in range(self.model_size):
                if m == self.model_index:
                    continue
                at = 0
                for i in clay.gathered:
                    dst = clay.column_of(i, views[i], m)
                    dst.copy_(got[m, at:at + dst.numel()].view(dst.shape))
                    at += dst.numel()
        return row

    def reduce_column_grads(self, grads, out, clay: ColumnLayout,
                            split: bool):
        """Autograd's grads of the compute leaves (``clay.flat`` order) ->
        this rank's shard grad row ``out``: the leaves read in part of a
        whole are summed over "model" (one all-reduce), then the blocks
        go to their ranks as :meth:`reduce_grads` sends them (summed
        over "data" and divided by D when ``split``)."""
        if clay.sums and self.model_size > 1:
            buf = torch.cat([grads[i].reshape(-1) for i in clay.sums])
            self.model_sum_(buf)
            grads = list(grads)
            at = 0
            for i in clay.sums:
                n = grads[i].numel()
                grads[i] = buf[at:at + n].view(grads[i].shape)
                at += n
        if split and self.data_size > 1:
            return self.inner.reduce_scatter_blocks(
                lambda j, buf: clay.blocks_of(grads, j, buf), out,
                clay.sharded)
        return clay.blocks_of(grads, clay.data_index.index(
            clay.sharded.index), out)

    def data_mean_(self, values: torch.Tensor, split: bool) -> torch.Tensor:
        """Per-replica values (losses) of this rank's batch rows -> their
        mean over the data ranks (a SUM all-reduce over "data", then the
        division by D), in place; unchanged unless ``split``."""
        if not split or self.data_size == 1:
            return values
        self.inner._all_reduce(values.view(-1), self.data_pg, axis=DATA)
        return values.div_(torch.full((), float(self.data_size),
                                      device=values.device))


class _InReplica(_Staged):
    """The collectives of a :class:`MeshGroups` inside one replica.  A
    staging buffer above :attr:`PIN_LIMIT` bytes is pageable: PyTorch's
    caching host allocator keeps every pinned block (its size rounded up
    to a power of two) until the process ends, and a few ranks' gathered
    rows would fill the host."""

    PIN_LIMIT = 1 << 26

    def __init__(self, mesh: MeshGroups, obs):
        self.mesh = mesh
        self.axis = ",".join(mesh.inner_axes) or "none"
        self._init_staging(obs, mesh.dry)

    def _host(self, key, numel: int, dtype) -> torch.Tensor:
        if numel * dtype.itemsize <= self.PIN_LIMIT:
            return super()._host(key, numel, dtype)
        k = (key, numel, dtype)
        if k not in self._pinned:
            self._pinned[k] = torch.empty(numel, dtype=dtype)
        return self._pinned[k]

    def gather_blocks(self, local_row, full_row, layout: ShardedLayout):
        m = self.mesh
        G = len(m.inner_coords)
        if G == 1:
            return layout.gather_into(local_row.view(1, -1), full_row)
        dev, numel = local_row.device, layout.numel
        send = self._staging(dev, "block_send", numel, local_row.dtype)
        recv = self._staging(dev, "block_recv", G * numel,
                             local_row.dtype).view(G, numel)

        def d2h():
            if dev.type != "cpu":
                torch.cuda.current_stream(dev).synchronize()
            send.copy_(local_row)

        # moved as bytes: gloo gathers any dtype that way
        self._collective(
            "all_gather", numel * local_row.element_size(), d2h,
            lambda: dist.all_gather(
                list(recv.view(torch.uint8).unbind(0)),
                send.view(torch.uint8), group=m.inner_pg),
            lambda: layout.gather_into(recv, full_row))
        return full_row

    def reduce_scatter_grads(self, full_grad, out, layout: ShardedLayout):
        m = self.mesh
        # rank j of the data group: this rank's coordinate with data = j
        mine = m.inner_coords[m.inner_index]
        idx = [m.inner_coords.index({**mine, DATA: j})
               for j in range(m.data_size)]
        return self.reduce_scatter_blocks(
            lambda j, buf: layout.blocks_of(full_grad, idx[j], buf), out,
            layout)

    def reduce_scatter_blocks(self, fill, out, layout: ShardedLayout):
        """``fill(j, buf)`` writes the grads of the blocks of the rank at
        "data" coordinate j into ``buf`` (a ``layout.numel`` row); they
        are summed over "data" into this rank's ``out`` (one
        reduce-scatter) and divided by D."""
        m = self.mesh
        D, numel, dev = m.data_size, layout.numel, out.device
        # the buffers of the blocks' all-gather over "data" (a step uses
        # both in turn)
        send = self._staging(dev, "block_recv", D * numel,
                             out.dtype).view(D, numel)
        recv = self._staging(dev, "block_send", numel, out.dtype)

        def d2h():
            if dev.type != "cpu":
                torch.cuda.current_stream(dev).synchronize()
            for j in range(D):
                fill(j, send[j])

        def call():
            dist.reduce_scatter_tensor(recv, send.view(-1), group=m.data_pg)

        def h2d():
            # the blocks only: the gaps of ``out`` stay zero
            div = torch.full((), float(D), device=out.device)
            for o, sz in layout.segments:
                out[o:o + sz].copy_(recv[o:o + sz]).div_(div)

        self._collective("reduce_scatter", D * numel * out.element_size(),
                         d2h, call, h2d, axis=DATA)
        return out


class _CopyToModel(torch.autograd.Function):
    """Megatron's f: identity forward, SUM all-reduce over "model" of the
    grad backward."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return ctx.mesh.model_sum_(grad.contiguous().clone()), None


class _ReduceFromModel(torch.autograd.Function):
    """Megatron's g: SUM all-reduce over "model" forward, identity
    backward."""

    @staticmethod
    def forward(ctx, x, mesh):
        return mesh.model_sum_(x.contiguous().clone())

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherFromModel(torch.autograd.Function):
    """All-gather over "model" along ``dim`` forward, the rank's slice of
    the grad backward."""

    @staticmethod
    def forward(ctx, x, mesh, dim):
        dim = dim % x.dim()
        ctx.mesh, ctx.dim, ctx.size = mesh, dim, x.shape[dim]
        parts = mesh.inner._all_gather(x, mesh.model_pg, mesh.model_size,
                                       axis=MODEL)
        return torch.cat(parts.unbind(0), dim)

    @staticmethod
    def backward(ctx, grad):
        return (grad.narrow(ctx.dim, ctx.mesh.model_index * ctx.size,
                            ctx.size), None, None)


class _GatherSummedFromModel(_GatherFromModel):
    """All-gather over "model" along ``dim`` forward, the reduce-scatter of
    the grad backward."""

    @staticmethod
    def backward(ctx, grad):
        parts = torch.stack(grad.split(ctx.size, ctx.dim))
        return (ctx.mesh.inner._reduce_scatter(parts, ctx.mesh.model_pg,
                                               axis=MODEL), None, None)


def replica_group(group) -> Optional[ReplicaGroup]:
    """The ReplicaGroup of ``group`` (a ReplicaGroup, a MeshGroups or
    None)."""
    return group.replica if isinstance(group, MeshGroups) else group


def active(group) -> Optional[ReplicaGroup]:
    """The ReplicaGroup of ``group`` when it spans more than one rank,
    else None (the trivial group takes the single-process path)."""
    group = replica_group(group)
    return group if group is not None and not group.trivial else None


def in_replica(group) -> Optional[MeshGroups]:
    """``group`` when it is a MeshGroups with an axis inside a replica
    above one rank, else None (whole leaves, the FlatLayout)."""
    if isinstance(group, MeshGroups) and group.sharded:
        return group
    return None


def distributed(group) -> bool:
    """Whether ``group`` spans more than one rank on any axis."""
    return group is not None and not group.trivial


def layout_for(params, group=None):
    """The flat layout of a state on ``group``: a rank's blocks under
    axes inside a replica, whole leaves otherwise."""
    mesh = in_replica(group)
    return mesh.layout(params) if mesh is not None else FlatLayout(params)


def make_sharded_step_fn(local_step, group, n_replicas: int):
    """The one wrapper behind every Algorithm's sharded step (the
    counterpart of the reference's jit(shard_map)): ``n_replicas`` is
    validated against the group so each rank gets a whole number of
    replicas, and a body that emits its per-replica losses as
    ``local_loss_per_replica`` (its k local rows) gets them republished,
    gathered over the ranks, as ``loss_per_replica``, with ``loss`` their
    mean (the single-process step's reduction on the same (n,) vector).
    ``group``: a ReplicaGroup or a MeshGroups (its replica subgroup)."""
    group = replica_group(group)
    check_divisible(n_replicas, group.world, group.axis)

    def run(state, batch):
        state, metrics = local_step(state, batch)
        if "local_loss_per_replica" in metrics:
            metrics = dict(metrics)
            per = group.all_gather_rows(
                metrics.pop("local_loss_per_replica"))
            metrics["loss_per_replica"] = per
            metrics["loss"] = per.mean()
        return state, metrics

    return run


# ------------------------------------------------------------------
# Partition specs (the planner's trees; the replica axis prepended)
# ------------------------------------------------------------------

def spec_for_path(names, shape) -> Spec:
    """Core rule table (without stack / replica prefixes) — planner-backed."""
    _, spec = planner_mod.match_rule_flat(tuple(names), tuple(shape))
    return spec


def param_pspecs(params, policy: str = "fsdp_tp") -> dict:
    """Spec tree for a (un-replicated) parameter tree, from the sharding
    planner's rule tables.

    policy:
      fsdp_tp  — weights sharded over BOTH axes (ZeRO-3 x tensor
                 parallel). Minimum memory; pays a gather of every
                 weight over the in-replica axes a step.
      tp_only  — weights sharded over "model" only, replicated over
                 "data": D times the weight memory, less to gather.
      dp_only  — no tensor parallelism: the "model" axis is repurposed
                 as extra data parallelism; weights ZeRO-shard over the
                 combined axes where divisible (:func:`sanitize_pspecs`
                 drops the rest).
    """
    return planner_mod.plan_tree(params, policy=policy).pspecs()


def prepend_axis(pspec_tree, axis_name: Optional[str]):
    """Prepend a leading axis (Parle replica dim) to every spec."""
    return tree_map(lambda s: Spec(axis_name, *s), pspec_tree)


def _plan(params, axis_sizes):
    return planner_mod.plan_tree(params, axis_sizes=axis_sizes)


def parle_state_pspecs(replica_axis: str, params=None, axis_sizes=None,
                       cfg=None) -> dict:
    """Spec tree of a ParleState, keyed as ``ParleState.tree()``.

    Without ``params`` (prefix form): the five (n, ...) iterate fields
    shard ONLY their leading replica axis over ``replica_axis``; the
    step counter and the scoping scalars are replicated.

    With ``params`` (planner form): every iterate leaf gets the composed
    spec ``Spec(replica_axis, *plan(leaf))`` — FSDP over "data",
    tensor-parallel over "model", replicas over ``replica_axis`` — so a
    rank's state is shard-sized.  ``axis_sizes`` sanitizes divisibility.

    ``cfg``: when it enables a compressed sync (cfg.sync_compress !=
    "none") the state carries the error-feedback residual ``e`` — same
    shape and spec as ``x``; when it enables the overlapped sync
    (cfg.sync_overlap) the state carries the in-flight consensus ``c`` —
    model-shaped with NO replica axis, replicated over the replica axis
    exactly like elastic's ``ref``.  Specs are dtype-agnostic: under
    cfg.precision="bf16" ``y`` is bfloat16, with the same specs."""
    has_e = cfg is not None and getattr(cfg, "sync_compress", "none") != "none"
    has_c = cfg is not None and getattr(cfg, "sync_overlap", False)
    if params is None:
        rep, flat = Spec(replica_axis), Spec()
    else:
        plan = _plan(params, axis_sizes)
        rep, flat = plan.pspecs_with_leading(replica_axis), plan.pspecs()
    out = {f: rep for f in ("x", "y", "z", "v_y", "v_x")}
    out.update(step=Spec(), scopes=Spec())
    if has_e:
        out["e"] = rep
    if has_c:
        out["c"] = flat if params is not None else Spec()
    return out


def elastic_state_pspecs(replica_axis: str, params=None,
                         axis_sizes=None) -> dict:
    """Spec tree of an ElasticState: workers and their momentum shard the
    leading replica axis; the reference variable carries no replica axis
    (every rank applies the identical Eq. (7b) update to its shard).
    With ``params``, the planner composes FSDP x TP specs under the
    replica axis (see :func:`parle_state_pspecs`)."""
    if params is None:
        rep = Spec(replica_axis)
        return {"x": rep, "ref": Spec(), "v": rep, "step": Spec(),
                "scopes": Spec()}
    plan = _plan(params, axis_sizes)
    rep = plan.pspecs_with_leading(replica_axis)
    return {"x": rep, "ref": plan.pspecs(), "v": rep, "step": Spec(),
            "scopes": Spec()}


def sgd_state_pspecs(params=None, axis_sizes=None) -> dict:
    """Spec tree of an SGDState: nothing rides the replica axis (grads are
    averaged over it, so every replica holds the identical model) but
    with ``params`` the model and its momentum still FSDP x TP shard over
    the in-replica axes."""
    if params is None:
        return {"params": Spec(), "v": Spec(), "step": Spec()}
    plan = _plan(params, axis_sizes)
    return {"params": plan.pspecs(), "v": plan.pspecs(), "step": Spec()}


def sanitize_pspecs(pspec_tree, shape_tree, axis_sizes: dict) -> dict:
    """Drop mesh axes that do not evenly divide the corresponding dim (a
    rank's block must be a whole slice: vocab sizes like 151655 or
    expert counts like 60 do not divide a 16-wide axis).  Every demotion
    is logged once per process (logger ``repro_torch.sharding``)."""
    shapes = dict(tree_leaves_with_paths(shape_tree))

    def walk(tree, prefix):
        if isinstance(tree, dict):
            return {k: walk(v, prefix + (k,)) for k, v in tree.items()}
        names = planner_mod.path_names(prefix)
        out, _ = planner_mod._sanitize(tree, tuple(shapes[prefix].shape),
                                       axis_sizes, names, warn=True)
        return out

    return walk(pspec_tree, ())


def batch_pspecs(batch_shapes, axis_sizes: dict,
                 replica_axis: Optional[str] = None) -> dict:
    """Shard the per-replica batch axis over "data" when divisible
    (``MeshGroups.data_rows``); batch leaves have layout (n?, B, ...)."""
    data_size = axis_sizes.get(DATA, 1)

    def spec(leaf):
        shape = tuple(leaf.shape)
        lead = [replica_axis] if replica_axis is not None else []
        off = len(lead)
        b = shape[off] if len(shape) > off else 1
        bspec = DATA if (b % data_size == 0 and b >= data_size) else None
        return Spec(*lead, bspec, *([None] * (len(shape) - off - 1)))

    return tree_map(spec, batch_shapes)

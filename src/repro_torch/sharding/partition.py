"""The Parle replica axis over the ranks of a ``torch.distributed`` process
group.  Port of the replica-axis half of ``repro/sharding/partition.py``
(its PartitionSpec functions serve JAX's ``shard_map`` and have no
counterpart here).

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
memory (``dist.gather``) and handed to the writer there, counted as
``op="gather"``; no rank's device holds another's rows.

The backend is gloo, on the CPU and on the card alike (two ranks can
share one card, where NCCL refuses them).  A CUDA tensor is staged
through pinned host memory, one buffer per shape and dtype, made at its
first use: device to host, the gloo call, host to device, each timed and
in a span (``pod.d2h``, ``pod.collective``, ``pod.h2d``).  Each operation
counts its calls and the bytes this rank contributes in the ``Obs``
registry, as ``pod.collectives{op=...}`` and
``pod.collective_bytes{op=...}`` (and, with the telemetry armed, the
three times in ``pod.d2h_ms`` / ``pod.collective_ms`` / ``pod.h2d_ms``
histograms).

A world of one rank is the trivial group: it makes no collective (the
reference's size-1 replica axis runs with ``axis_name=None``), and the
algorithms take their single-process path under it.
"""
from __future__ import annotations

import time
from typing import Optional

import torch
import torch.distributed as dist

def check_divisible(n_replicas: int, world: int, axis: str = "pod"):
    """Each rank holds a whole number of replicas (the reference's
    message)."""
    if n_replicas % world != 0:
        raise ValueError(
            f"n_replicas={n_replicas} not divisible by "
            f"mesh axis {axis!r} of size {world}")


class ReplicaGroup:
    """Rank ``rank`` of ``world`` ranks holding rows ``rows`` of the
    ``n`` replicas.  ``pg``: the ``torch.distributed`` process group
    (None: the default group); ``obs``: the ``Obs`` bundle whose registry
    and tracer record the collectives (None: a private registry, no
    spans)."""

    def __init__(self, n: int, rank: int = 0, world: int = 1, *,
                 axis: str = "pod", pg=None, obs=None):
        check_divisible(n, world, axis)
        self.n, self.rank, self.world, self.axis = n, rank, world, axis
        self.local = n // world
        self.rows = slice(rank * self.local, (rank + 1) * self.local)
        self.pg = pg
        if obs is None:
            from repro_torch.obs import Obs
            obs = Obs()
        self.obs = obs
        self._pinned: dict = {}

    @property
    def trivial(self) -> bool:
        return self.world == 1

    # -- staging ------------------------------------------------------
    def _host(self, key, numel: int, dtype) -> torch.Tensor:
        """A pinned host buffer of ``numel`` elements, made once per
        (key, numel, dtype)."""
        k = (key, numel, dtype)
        if k not in self._pinned:
            self._pinned[k] = torch.empty(numel, dtype=dtype,
                                          pin_memory=True)
        return self._pinned[k]

    def _collective(self, op: str, nbytes: int, d2h, call, h2d):
        """Run one staged collective: ``d2h()`` -> host buffers, ``call``
        on them, ``h2d()`` back; count it and time its three parts."""
        reg, tracer = self.obs.registry, self.obs.tracer
        reg.counter("pod.collectives", op=op).inc()
        reg.counter("pod.collective_bytes", op=op).inc(nbytes)
        t = [time.perf_counter()]
        for name, fn in (("pod.d2h", d2h), ("pod.collective", call),
                         ("pod.h2d", h2d)):
            with tracer.span(name, cat="sync", op=op, bytes=nbytes):
                fn()
            t.append(time.perf_counter())
        if self.obs.enabled:
            for i, k in enumerate(("d2h_ms", "collective_ms", "h2d_ms")):
                reg.histogram(f"pod.{k}", op=op).observe(
                    (t[i + 1] - t[i]) * 1e3)

    # -- operations ---------------------------------------------------
    def all_reduce_(self, buf: torch.Tensor) -> torch.Tensor:
        """SUM-all-reduce the contiguous ``buf`` in place across the
        ranks (the trivial group: no collective)."""
        if self.trivial:
            return buf
        if buf.device.type == "cpu":
            host = buf
            d2h = h2d = lambda: None
        else:
            host = self._host("reduce", buf.numel(), buf.dtype)
            flat = buf.view(-1)

            def d2h():
                torch.cuda.current_stream(buf.device).synchronize()
                host.copy_(flat)

            def h2d():
                flat.copy_(host)
        self._collective(
            "all_reduce", buf.numel() * buf.element_size(), d2h,
            lambda: dist.all_reduce(host, group=self.pg), h2d)
        return buf

    def mean_rows(self, x_local: torch.Tensor, out=None) -> torch.Tensor:
        """(k, M) local rows -> the (M,) mean over all n replicas: the
        local sum, all-reduced with SUM, divided by n.  ``out``: an (M,)
        buffer to write it into."""
        s = torch.sum(x_local, 0, out=out)
        return self.all_reduce_(s).div_(self.n)

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
        staged = dev.type != "cpu"
        make = ((lambda key, numel: self._host(key, numel, torch.uint8))
                if staged else
                (lambda key, numel: torch.empty(numel, dtype=torch.uint8)))
        send = make("gather_send", total)
        recv = make("gather_recv", self.world * total).view(self.world,
                                                            total)
        outs = [torch.empty((self.n,) + tuple(t.shape[1:]), dtype=t.dtype,
                            device=t.device) for t in ts]

        def d2h():
            if staged:
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
        returns).  One ``dist.gather`` a leaf through host buffers of the
        largest leaf's bytes (pinned for CUDA leaves), never through the
        device, so no rank's device memory grows with n.  Counted once,
        as one ``gather`` of the bytes of this rank's rows, in one
        ``pod.gather`` span whose ``gather_s`` is the time of the copies
        and the gloo calls (``each`` excluded)."""
        reg, tracer = self.obs.registry, self.obs.tracer
        sizes = [t.numel() * t.element_size() for t in leaves]
        reg.counter("pod.collectives", op="gather").inc()
        reg.counter("pod.collective_bytes", op="gather").inc(sum(sizes))
        cuda = {t.device for t in leaves if t.device.type != "cpu"}
        send = (self._host("ckpt_send", max(sizes), torch.uint8) if cuda
                else torch.empty(max(sizes), dtype=torch.uint8))
        recv = (torch.empty(self.world * max(sizes),
                            dtype=torch.uint8) if self.rank == 0 else None)
        spent = 0.0
        with tracer.span("pod.gather", cat="sync", op="gather",
                         bytes=sum(sizes)) as sp:
            for dev in cuda:
                torch.cuda.current_stream(dev).synchronize()
            for i, (t, sz) in enumerate(zip(leaves, sizes)):
                t0 = time.perf_counter()
                send[:sz].view(t.dtype).view(t.shape).copy_(t)
                parts = (None if recv is None else
                         list(recv[:self.world * sz].view(self.world, sz)
                              .unbind(0)))
                dist.gather(send[:sz], gather_list=parts, dst=0,
                            group=self.pg)
                spent += time.perf_counter() - t0
                if each is not None:
                    each(i, recv[:self.world * sz].view(t.dtype).view(
                        (self.n,) + tuple(t.shape[1:])))
            sp.set(gather_s=round(spent, 3))
        if self.obs.enabled:
            reg.histogram("pod.collective_ms", op="gather").observe(
                spent * 1e3)

    def barrier(self) -> None:
        """Every rank waits for every other (not counted: it moves no
        data)."""
        if not self.trivial:
            dist.barrier(group=self.pg)

    def counts(self) -> dict:
        """{op: (calls, bytes)} of this rank's collectives so far."""
        return collective_counts(self.obs.registry)


def collective_counts(registry) -> dict:
    """{op: (calls, bytes)} of the ``pod.collectives`` /
    ``pod.collective_bytes`` counters of an ``Obs`` registry."""
    out = {}
    for c in registry.snapshot()["counters"]:
        if c["name"] in ("pod.collectives", "pod.collective_bytes"):
            out.setdefault(c["labels"]["op"], [0, 0])[
                c["name"] == "pod.collective_bytes"] = c["total"]
    return {k: tuple(v) for k, v in out.items()}


def active(group: Optional[ReplicaGroup]) -> Optional[ReplicaGroup]:
    """``group`` when it spans more than one rank, else None (the trivial
    group takes the single-process path)."""
    return group if group is not None and not group.trivial else None


def make_sharded_step_fn(local_step, group: ReplicaGroup, n_replicas: int):
    """The one wrapper behind every Algorithm's sharded step (the
    counterpart of the reference's jit(shard_map)): ``n_replicas`` is
    validated against the group so each rank gets a whole number of
    replicas, and a body that emits its per-replica losses as
    ``local_loss_per_replica`` (its k local rows) gets them republished,
    gathered over the ranks, as ``loss_per_replica``, with ``loss`` their
    mean (the single-process step's reduction on the same (n,) vector)."""
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

"""Span tracing with a CUDA-aware timing discipline, exported as
Chrome-trace JSON (open in Perfetto / chrome://tracing).

CUDA launches are asynchronous: the wall clock at the end of a ``with``
block measures enqueue time, not execution.  A :class:`Span` therefore
carries an optional *block target* — ``sp.block(x)`` arms the span so
its ``__exit__`` waits, BEFORE taking the end timestamp, for an event
recorded on the current stream of every CUDA device that holds a tensor
of ``x``: the stream that produced the value, as ``jax.block_until_ready``
waits for the value alone.  Work on other streams (a collective in
flight, a side stream) is not waited for.  The span's duration then
covers launch + device execution.  The serving engine's
CUDA-graph captures are their own spans (``cat="compile"``) so
steady-state spans stay clean.

A disabled tracer hands out a shared no-op span — zero allocations,
no timestamps, no synchronisation — so un-instrumented runs are
byte-for-byte the plain code path.

Chrome-trace mapping: every span is one complete event (``"ph": "X"``)
with microsecond ``ts``/``dur`` relative to tracer construction;
nesting is by containment on the same ``(pid, tid)`` track, and the
span's nesting depth is also recorded in ``args.depth``.
"""
from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, List, Optional


def _cuda_devices(x, devices: set) -> set:
    """The CUDA devices of the tensors in ``x`` (a tensor, or a nested
    list / tuple / dict of them), added to ``devices``."""
    import torch
    if isinstance(x, dict):
        x = list(x.values())
    for t in x if isinstance(x, (list, tuple)) else [x]:
        if isinstance(t, (list, tuple, dict)):
            _cuda_devices(t, devices)
        elif isinstance(t, torch.Tensor) and t.is_cuda:
            devices.add(t.device)
    return devices


def _synchronize(x) -> None:
    """Wait until the CUDA tensors of ``x`` are computed: one event
    recorded on the current stream of each device that holds one, then
    waited for — never the whole device.  CPU tensors are already
    complete."""
    import torch
    for d in _cuda_devices(x, set()):
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(d))
        done.synchronize()


class _NullSpan:
    """The disabled-tracer span: every method is a no-op."""
    __slots__ = ()
    dur_s = 0.0

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def block(self, x) -> None:
        pass

    def set(self, **attrs) -> None:
        pass


NULL_SPAN = _NullSpan()


class Span:
    __slots__ = ("tracer", "name", "cat", "attrs", "t_start", "t_end",
                 "depth", "tid", "_block")

    def __init__(self, tracer: "Tracer", name: str, cat: str, attrs: dict):
        self.tracer = tracer
        self.name = name
        self.cat = cat
        self.attrs = attrs
        self.t_start = self.t_end = 0.0
        self.depth = 0
        self.tid = 0
        self._block: Any = None

    def block(self, x) -> None:
        """Arm the span: ``__exit__`` waits for the streams that computed
        ``x`` (a tensor, or a list/tuple/dict of them) before recording
        the end timestamp."""
        self._block = x

    def set(self, **attrs) -> None:
        self.attrs.update(attrs)

    def __enter__(self):
        self.depth, self.tid = self.tracer._push()
        self.t_start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self._block is not None:
            _synchronize(self._block)
            self._block = None
        self.t_end = time.perf_counter()
        self.tracer._pop()
        self.tracer._record(self)
        return False

    @property
    def dur_s(self) -> float:
        return self.t_end - self.t_start


class Tracer:
    def __init__(self, enabled: bool = False, collect: bool = True,
                 pid: int = 0, process_name: Optional[str] = None):
        """``enabled=False``: span() returns the shared no-op span.
        ``collect=False``: spans time themselves (``dur_s`` usable for
        histograms) but no events are retained — for metrics-only runs
        that should not grow a trace buffer."""
        self.enabled = enabled
        self.collect = collect
        self.pid = pid
        self.process_name = process_name
        self.events: List[dict] = []
        self.t0 = time.perf_counter()
        self._tls = threading.local()
        self._tids: dict = {}

    # -- span lifecycle ------------------------------------------------
    def span(self, name: str, cat: str = "", **attrs):
        if not self.enabled:
            return NULL_SPAN
        return Span(self, name, cat, attrs)

    def _push(self):
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = self._tls.stack = []
        ident = threading.get_ident()
        tid = self._tids.setdefault(ident, len(self._tids))
        depth = len(stack)
        stack.append(depth)
        return depth, tid

    def _pop(self):
        self._tls.stack.pop()

    def _record(self, span: Span) -> None:
        if not self.collect:
            return
        self.events.append({
            "name": span.name,
            "cat": span.cat or "span",
            "ph": "X",
            "ts": round((span.t_start - self.t0) * 1e6, 3),
            "dur": round((span.t_end - span.t_start) * 1e6, 3),
            "pid": self.pid,
            "tid": span.tid,
            "args": dict(span.attrs, depth=span.depth),
        })

    # -- export --------------------------------------------------------
    def to_chrome(self) -> dict:
        meta = []
        if self.process_name is not None:
            meta.append({"name": "process_name", "ph": "M",
                         "pid": self.pid, "tid": 0,
                         "args": {"name": self.process_name}})
        return {"traceEvents": meta + list(self.events),
                "displayTimeUnit": "ms"}

    def save(self, path: str) -> None:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.to_chrome(), f)
            f.write("\n")

"""The device trace of a traced run: ``torch.profiler`` (device activity
only, so that tracing the host's every operation does not slow the host
and open gaps on the device that an untraced run would not have) over a
short steady stretch of the window, read into plain records that the
per-layer readers take.

``Window.device``: (name, start_s, end_s) of every operation that ran on
the device (kernels, copies, sets); ``Window.host``: the CUDA runtime
calls the host made (launches, copies, waits), on the same clock.  The
window runs from the first event to the last.
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass, field

import torch

from perfbench import stats


@dataclass
class Window:
    start: float = 0.0
    end: float = 0.0
    device: list = field(default_factory=list)
    host: list = field(default_factory=list)

    @property
    def seconds(self) -> float:
        return self.end - self.start

    def busy_s(self) -> float:
        return stats.union_length([(s, e) for _, s, e in self.device])

    def kernel_time(self, *needles) -> tuple:
        """(seconds, launches) of the device operations whose name holds
        any of ``needles``."""
        sel = [e - s for name, s, e in self.device
               if any(n in name for n in needles)]
        return sum(sel), len(sel)

    def top_ops(self, k: int = 10) -> list:
        tot = {}
        for name, s, e in self.device:
            tot[name] = tot.get(name, 0.0) + (e - s)
        return [[n[:200], t] for n, t in
                sorted(tot.items(), key=lambda kv: -kv[1])[:k]]

    def idle_gaps(self, k: int = 10) -> list:
        """The ``k`` longest stretches of the window with nothing on the
        device, each named by the runtime call the host was making at its
        start, or "host, no CUDA call" (Python between calls)."""
        spans = [(s, e) for _, s, e in self.device]
        longest = sorted(stats.gaps(spans, self.start, self.end),
                         key=lambda g: g[0] - g[1])[:k]
        out = []
        for s, e in longest:
            under = [(hs, name) for name, hs, he in self.host
                     if hs <= s < he]
            name = max(under)[1] if under else "host, no CUDA call"
            out.append([name[:200], e - s])
        return out


@contextlib.contextmanager
def traced(window: Window, device):
    """Profile the device over the body; fill ``window`` afterwards."""
    torch.cuda.synchronize(device)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        yield window
        torch.cuda.synchronize(device)
    cuda = torch.autograd.DeviceType.CUDA
    for ev in prof.profiler.kineto_results.events():
        rec = (ev.name(), ev.start_ns() / 1e9,
               (ev.start_ns() + ev.duration_ns()) / 1e9)
        if getattr(ev, "is_user_annotation", lambda: False)():
            continue
        (window.device if ev.device_type() == cuda else window.host).append(
            rec)
    every = window.device + window.host
    if every:
        window.start = min(s for _, s, _ in every)
        window.end = max(e for _, _, e in every)

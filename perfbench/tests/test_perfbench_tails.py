"""The tails are taken over every request due in the window, from when
each was due, missing ones counted: a stall of the engine shows."""
import math

import numpy as np
import pytest

from perfbench import stats, traffic
from perfbench.drivers import serve


class FakeEngine:
    """Serves each request in a fixed time from its submission, with
    one stall that holds every request submitted during it."""

    def __init__(self):
        from repro_torch.serving.scheduler import Scheduler
        self.sched = Scheduler(4)
        self.uid = 0

    def submit(self, tokens, max_new_tokens):
        from repro_torch.serving.request import Request
        r = Request(uid=self.uid, tokens=tokens,
                    max_new_tokens=max_new_tokens)
        self.uid += 1
        self.sched.submit(r)
        return r.uid


def run(stall_at=None, stall_s=0.0, n=100, drop=()):
    eng = FakeEngine()
    tr = serve.Tracker(eng)
    for i in range(n):
        due = 0.1 * i
        req = traffic.Due(due, np.zeros(4, np.int32), 9)
        uid = tr.submit(req, due)
        start = due
        if stall_at is not None and stall_at <= due < stall_at + stall_s:
            start = stall_at + stall_s           # waits out the stall
        if uid in drop:
            continue
        tr.first[uid] = start + 0.05
        tr.done[uid] = start + 0.05 + 8 * 0.01
        tr.tokens[uid] = np.zeros(9, np.int32)
    return serve.latencies(tr)


def test_latencies_from_due():
    ttft, tpot = run()
    assert np.allclose(ttft, 0.05) and np.allclose(tpot, 0.01)


def test_a_stall_shows_in_the_tail():
    calm = stats.percentile(run()[0], 95)
    # a 1 s stall holds 10 of 100 requests: the p95 sees it
    ttft, _ = run(stall_at=5.0, stall_s=1.0)
    assert stats.percentile(ttft, 95) > calm + 0.4
    assert stats.percentile(ttft, 50) == pytest.approx(calm)


def test_missing_requests_are_infinite():
    ttft, tpot = run(drop=set(range(10)))
    assert sum(math.isinf(v) for v in ttft) == 10
    assert math.isinf(stats.percentile(ttft, 95))
    assert math.isinf(stats.percentile(tpot, 95))


def test_percentile_by_nearest_rank():
    v = list(range(1, 201))
    assert stats.percentile(v, 95) == 190
    assert stats.percentile(v, 50) == 100
    assert stats.percentile([3.0], 95) == 3.0


def test_union_and_gaps():
    iv = [(0, 2), (1, 3), (5, 6)]
    assert stats.union_length(iv) == 4
    assert stats.gaps(iv, 0, 8) == [(3, 5), (6, 8)]


def test_chunk_lengths():
    pos = np.array([10, 4])
    active = np.array([True, False])
    ln = serve.chunk_lengths(pos, active, 4, cap=100)
    assert ln == [[7, 5], [8, 5], [9, 5], [10, 5]]
    assert serve.chunk_lengths(pos, active, 4, cap=8)[3] == [8, 5]


def test_device_window_reading():
    from perfbench.devtrace import Window
    w = Window(start=0.0, end=10.0,
               device=[("gemm", 0.0, 4.0), ("gemm", 3.0, 5.0),
                       ("parle_inner_kernel<float>", 6.0, 7.0)],
               host=[("cudaStreamSynchronize", 4.5, 6.5),
                     ("cudaLaunchKernel", 7.5, 7.6)])
    assert w.busy_s() == 6.0 and w.seconds == 10.0
    assert w.kernel_time("parle_inner_kernel") == (1.0, 1)
    assert w.top_ops() == [["gemm", 6.0], ["parle_inner_kernel<float>", 1.0]]
    assert w.idle_gaps() == [["host, no CUDA call", 3.0],
                             ["cudaStreamSynchronize", 1.0]]


def test_admission_waits_from_due():
    eng = FakeEngine()
    tr = serve.Tracker(eng)
    for i in range(3):
        tr.submit(traffic.Due(0.5 * i, np.zeros(4, np.int32), 9), 0.5 * i)
    tr.admitted.update({0: 0.2, 1: 2.5})        # the third never admitted
    waits = serve.admission_waits(tr)
    assert waits[:2] == pytest.approx([0.2, 2.0]) and math.isinf(waits[2])


@pytest.mark.parametrize("points, knee", [
    # the slots keep up at 3.0 on every seed, not at 3.5 on one of them
    ([(2.5, 0.2), (2.5, 0.3), (3.0, 0.4), (3.0, 0.9), (3.5, 0.3),
      (3.5, 1.7), (4.0, 6.0), (4.0, 9.0)], 3.0),
    # a rate that reads well above one that did not is no knee
    ([(3.0, 0.3), (3.5, 2.0), (4.0, 0.5)], 3.0),
    ([(3.0, 1.5), (3.5, 0.2)], None),
])
def test_knee_is_the_highest_rate_every_seed_sustains(points, knee):
    from perfbench import calibrate
    assert calibrate.knee(points) == knee


def _record(busy, walls):
    from perfbench.devtrace import Window
    from perfbench.harness import Record
    w = Window(start=0.0, end=6.0, device=[("gemm", 0.0, busy)])
    return Record(cfg={}, mix={}, window=w, extra={"round_walls_s": walls})


def test_train_idle_share_is_over_the_untraced_rounds():
    """The profiled round is stretched by the profiler on the host: the
    idle share takes the device's busy time over the untraced rounds'
    median wall, not over the profiled round."""
    from perfbench import harness
    read = harness.reader("device_idle_share.train").read
    assert read(_record(3.0, [4.0, 4.0, 5.0])) == pytest.approx(25.0)
    assert read(_record(3.0, [])) is None

#!/usr/bin/env python3
"""Time the async pod coordinator's host work at the full-width cell of
``chip_smoke.py`` phase 11b: Qwen2.5-3B cut to 4 layers (M = 930,660,352
f32 a replica, 15 leaves), one replica a worker, int8 contributions.

    python3 tools/coordinator_timing.py

Runs on the host of the card's machine (about 40 GB of host memory; the
card is not used): builds two workers' random int8 payloads in the
layout's leaf sizes, then times, in the order an exchange runs them, the
parts of ``runtime/coordinator.py``: the dequantized mean of one payload,
its norm, the staleness-weighted fold of two workers, one periodic
consensus checkpoint and its reload, and one request and one reply frame
through a loopback ``multiprocessing.connection`` (the sender's pickle +
CRC32 + send; the receiver's wait, read, CRC32 and unpickle, from the
moment it starts to wait, so it holds the sender's time too).  Prints
one JSON line of seconds, the reply's consensus bytes and the host.
"""
from __future__ import annotations

import dataclasses
import json
import os
import platform
import sys
import tempfile
import threading
import time
from multiprocessing.connection import Client, Listener

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import parle  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.runtime import coordinator as co  # noqa: E402
from repro_torch.utils.pytree import FlatLayout  # noqa: E402


def main() -> int:
    cfg = dataclasses.replace(get_config("qwen2.5-3b"), num_layers=4)
    lay = FlatLayout(build_model(cfg).init(torch.Generator().manual_seed(0)))
    rng = np.random.default_rng(0)
    pad = lambda n: -(-n // 8192) * 8192  # noqa: E731

    def payload():
        return [{"q": rng.integers(-127, 128, (1, pad(n)), dtype=np.int8),
                 "scales": rng.random((1, pad(n) // 1024), dtype=np.float32)}
                for n in lay.sizes]

    times = {}

    def timed(name, fn):
        t = time.perf_counter()
        out = fn()
        times[name] = round(time.perf_counter() - t, 3)
        return out

    def dequantized_mean(p):
        return [co._replica_mean(co._np_dequant(leaf["q"], leaf["scales"],
                                                "int8")) for leaf in p]

    p0, p1 = payload(), payload()
    means = [timed("dequantize_mean", lambda: dequantized_mean(p0)),
             dequantized_mean(p1)]
    timed("norm", lambda: parle.contribution_norm(means[0]))
    cons = timed("fold_two_workers", lambda: parle.staleness_weighted_mean(
        means, [1, 1], [1, 1]))
    tmp = tempfile.mkdtemp()
    coord = co.Coordinator(0, method="int8")
    try:
        coord.consensus = cons
        path = os.path.join(tmp, "ck.npz")
        timed("checkpoint", lambda: coord.save(path))
        timed("load_consensus", lambda: co.load_consensus(path))
    finally:
        coord.close()
        for f in os.listdir(tmp):
            os.remove(os.path.join(tmp, f))
        os.rmdir(tmp)

    request = {"op": "exchange", "worker": "worker0", "round": 1,
               "count": 1, "payload": p0}
    reply = {"consensus": cons, "staleness": 0, "n_active": 2}
    listener = Listener(("127.0.0.1", 0), authkey=b"timing")
    received = {}

    def serve():
        with listener.accept() as conn:
            for name in ("request", "reply"):
                t = time.perf_counter()
                co._recv_frame(conn)
                received[name] = round(time.perf_counter() - t, 3)

    server = threading.Thread(target=serve)
    server.start()
    with Client(listener.address, authkey=b"timing") as conn:
        timed("send_request", lambda: co._send_frame(conn, request))
        timed("send_reply", lambda: co._send_frame(conn, reply))
    server.join()
    listener.close()
    times.update({f"receive_{k}": v for k, v in received.items()})
    print(json.dumps({"coordinator_timing_s": times,
                      "reply_consensus_bytes": sum(v.nbytes for v in cons),
                      "leaves": len(lay.sizes), "elements": lay.numel,
                      "host": platform.node(), "cpus": os.cpu_count()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The pod launcher (``repro_torch/launch/dist_run.py``): the port's
counterpart of tests/test_dist_run.py.  The pure helpers, then the
2-process smoke pod on the CPU against the single-process run (bit for
bit, ~10 s on one worker, so it stays in tier-1), and a failed worker:
the launcher exits with its code and leaves no process behind."""
import json
import os
import socket
import subprocess
import sys
import time

import pytest

from repro_torch.launch import dist_run
from repro_torch.launch.dist_run import (_losses, _mesh_size, _mesh_spec,
                                         build_argparser)
from torch_parity import one_torch_thread  # noqa: F401

SRC = os.path.join(os.path.dirname(__file__), "..", "src")


def test_mesh_size_and_default_spec():
    assert _mesh_size("pod:2") == 2
    assert _mesh_size("pod:2,data:2,model:2") == 8
    args = build_argparser().parse_args(["--nproc", "4"])
    assert _mesh_spec(args) == "pod:4"
    assert args.device == "cuda"          # as the train CLI


def test_losses_parser_filters_tagged_lines():
    out = "\n".join([
        '{"mesh": {"pod": 2}}',
        'DISTLOSS {"step": 1, "loss_hex": "0x1.8p+2", "loss": 6.0}',
        "noise",
        'DISTLOSS {"step": 2, "loss_hex": "0x1.9p+2", "loss": 6.25}',
    ])
    recs = _losses(out)
    assert [r["step"] for r in recs] == [1, 2]
    assert float.fromhex(recs[0]["loss_hex"]) == 6.0


def test_verdict_reports_the_first_mismatches():
    a = [{"step": 1, "loss_hex": "0x1.8p+2"}, {"step": 2,
                                               "loss_hex": "0x1.9p+2"}]
    b = [a[0], {"step": 2, "loss_hex": "0x1.9000000000001p+2"}]
    assert dist_run.verdict(a, a)["bitwise_equal"] is True
    v = dist_run.verdict(a, b)
    assert v["bitwise_equal"] is False and v["compared_steps"] == 2
    assert [m["step"] for m in v["mismatches"]] == [2]
    assert 0 < v["max_rel_diff"] < 1e-14


def test_async_policy_and_wrong_world_name_their_fix():
    with pytest.raises(SystemExit, match="queue 1, item 4"):
        dist_run.main(["--sync-policy", "async"])
    with pytest.raises(SystemExit, match="spans 4 ranks, --nproc is 2"):
        dist_run.main(["--nproc", "2", "--mesh", "pod:4"])


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _launch(port, env_extra=None, timeout=300):
    env = dict(os.environ, OMP_NUM_THREADS="1", **(env_extra or {}))
    env["PYTHONPATH"] = os.pathsep.join([SRC, env.get("PYTHONPATH", "")])
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dist_run", "--nproc",
         "2", "--smoke", "--steps", "6", "--L", "3", "--device", "cpu",
         "--port", str(port)],
        env=env, capture_output=True, text=True, timeout=timeout)


def test_two_process_run_matches_single_process_bitwise():
    res = _launch(_free_port())
    assert res.returncode == 0, res.stdout + res.stderr
    verdict = json.loads(res.stdout.strip().splitlines()[-1])
    assert verdict["bitwise_equal"] is True, verdict
    assert verdict["compared_steps"] == 6
    assert len(_losses(res.stdout)) == 6


def _workers_on(port) -> list:
    """pids of live processes whose command line names this pod's port
    and a worker index."""
    pids = []
    for pid in os.listdir("/proc"):
        if not pid.isdigit():
            continue
        try:
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                argv = f.read().split(b"\0")
        except OSError:
            continue
        if b"--_worker" in argv and str(port).encode() in argv:
            pids.append(int(pid))
    return pids


def test_failed_worker_fails_the_pod_without_orphans():
    port = _free_port()
    t0 = time.monotonic()
    res = _launch(port, {"REPRO_TEST_FAIL_WORKER": "1"}, timeout=120)
    assert res.returncode == 41, res.stdout + res.stderr
    assert "worker 1 exited rc=41" in res.stderr
    assert time.monotonic() - t0 < 120
    deadline = time.monotonic() + 10
    while _workers_on(port) and time.monotonic() < deadline:
        time.sleep(0.1)
    assert _workers_on(port) == []

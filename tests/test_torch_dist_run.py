"""The pod launcher (``repro_torch/launch/dist_run.py``): the port's
counterpart of tests/test_dist_run.py.  The pure helpers, then the
2-process smoke pod on the CPU against the single-process run (bit for
bit, ~10 s on one worker, so it stays in tier-1), a failed worker: the
launcher exits with its code and leaves no process behind, and composed
specs: four ranks under ``replica:2,model:2`` (an ssm replica split
over "model", within ``--tol``, the merged metrics keeping the bytes by
axis) and ``replica:2,data:2`` (within ``--tol``),
a moe replica split over ``data:2,model:2`` (within ``--tol``), the
train CLI's refusal of the async policy and a wrong ``--nproc`` naming
its fix."""
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


def test_async_policy_and_wrong_world_name_their_fix(tmp_path, capsys):
    """The async policy dispatches to the elastic pod (no replica-axis
    check: a worker is not a rank): one worker, one round, its consensus
    checkpointed; the barrier pod's wrong world still names its fix."""
    ck = str(tmp_path / "ck.npz")
    assert dist_run.main(
        ["--sync-policy", "async", "--nproc", "1", "--mesh", "pod:4",
         "--smoke", "--device", "cpu", "--steps", "2", "--L", "2",
         "--seq", "16", "--port", str(_free_port()),
         "--coord-port", str(_free_port()), "--checkpoint-out", ck]) == 0
    text = capsys.readouterr().out
    out = [json.loads(line) for line in text.splitlines()
           if line.startswith("{")]
    assert out[0]["mode"] == "async" and out[-1]["round"] == 1
    assert [r["step"] for r in _losses(text)] == [1, 2]
    with pytest.raises(SystemExit, match="spans 4 ranks, --nproc is 2"):
        dist_run.main(["--nproc", "2", "--mesh", "pod:4"])


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _launch(port, env_extra=None, timeout=300, argv=("--nproc", "2")):
    env = dict(os.environ, OMP_NUM_THREADS="1", **(env_extra or {}))
    env["PYTHONPATH"] = os.pathsep.join([SRC, env.get("PYTHONPATH", "")])
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dist_run", *argv,
         "--smoke", "--steps", "6", "--L", "3", "--device", "cpu",
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


# "data" sums each grad over two halves of the batch: the reference's
# composed-mesh loss bound (measured 7.2e-8 at this cell)
DATA_TOL = 2e-5


def test_composed_pod_under_model_is_bitwise(tmp_path):
    """``--nproc 4 --mesh replica:2,model:2 --use-kernel --tol 2e-5`` on
    an ssm replica: each rank computes its SSD heads (the Megatron split,
    ``models/mamba2.py``), so the launcher's verdict holds the losses
    within the composed-mesh bound of its one-process run (they were bit
    for bit while every rank computed the whole replica); the merged
    metrics keep each collective's bytes by axis, the sum over the four
    workers."""
    from repro_torch.obs import read_events
    m = str(tmp_path / "m.jsonl")
    res = _launch(_free_port(), argv=(
        "--nproc", "4", "--mesh", "replica:2,model:2", "--use-kernel",
        "--arch", "mamba2-1.3b", "--metrics-out", m, "--tol",
        str(DATA_TOL)))
    assert res.returncode == 0, res.stdout + res.stderr
    verdict = json.loads(res.stdout.strip().splitlines()[-1])
    print(f"[dist_run] ssm replica:2,model:2: max rel diff "
          f"{verdict['max_rel_diff']:.3e}")
    assert verdict["compared_steps"] == 6
    assert verdict["max_rel_diff"] <= DATA_TOL, verdict
    mesh = json.loads([line for line in res.stdout.splitlines()
                       if '"in_replica_axes"' in line][0])
    assert mesh["in_replica_axes"] == ["model"]
    merged = [e for e in read_events(m)
              if e["kind"] == "pod_merged"][-1]["snapshot"]
    got = {(c["labels"]["op"], c["labels"]["axis"]): c["total"]
           for c in merged["counters"]
           if c["name"] == "pod.collective_bytes"}
    want = {}
    for i in range(4):
        snap = [e for e in read_events(f"{m}.worker{i}")
                if e["kind"] == "metrics_snapshot"][-1]["snapshot"]
        for c in snap["counters"]:
            if c["name"] == "pod.collective_bytes":
                key = (c["labels"]["op"], c["labels"]["axis"])
                want[key] = want.get(key, 0) + c["total"]
    assert got == want
    assert {a for _, a in got} == {"model", "replica"}
    gauges = {(g["labels"]["kernel"], g["labels"]["worker"])
              for g in merged["gauges"]
              if g["name"] == "pod.kernel_launches"}
    assert ("parle_inner_update", 3) in gauges


def test_composed_pod_under_data_is_within_tol():
    """``--mesh replica:2,data:2 --tol 2e-5``: the launcher passes, its
    largest relative loss difference within the bound."""
    res = _launch(_free_port(), argv=(
        "--nproc", "4", "--mesh", "replica:2,data:2", "--tol",
        str(DATA_TOL)))
    assert res.returncode == 0, res.stdout + res.stderr
    verdict = json.loads(res.stdout.strip().splitlines()[-1])
    print(f"[dist_run] replica:2,data:2: max rel diff "
          f"{verdict['max_rel_diff']:.3e}")
    assert verdict["compared_steps"] == 6
    assert verdict["max_rel_diff"] <= DATA_TOL


@pytest.mark.parametrize("argv,match", [
    (["--nproc", "2", "--mesh", "replica:2,model:2"],
     r"spans 4 ranks \(2x2\), --nproc is 2: pass --nproc 4"),
    (["--nproc", "4", "--mesh", "replica:1,data:2,model:2", "--arch",
      "qwen2-moe-a2.7b"], "item 6a"),
    (["--nproc", "2", "--mesh", "replica:1,data:2", "--sync-policy",
      "async"], "item 6d"),
])
def test_composed_spec_refusals_name_their_fix(argv, match):
    """A wrong ``--nproc`` and the async policy on a composed mesh exit
    naming their fix; a moe architecture on a data axis (item 6a, once
    refused) runs split over "model" too, within the composed-mesh bound
    of one process."""
    if match != "item 6a":
        with pytest.raises(SystemExit, match=match):
            dist_run.main(argv + ["--smoke", "--device", "cpu"])
        return
    res = _launch(_free_port(), argv=tuple(argv) + ("--tol", str(DATA_TOL)))
    assert res.returncode == 0, res.stdout + res.stderr
    verdict = json.loads(res.stdout.strip().splitlines()[-1])
    print(f"[dist_run] moe replica:1,data:2,model:2: max rel diff "
          f"{verdict['max_rel_diff']:.3e}")
    assert verdict["compared_steps"] == 6
    assert verdict["max_rel_diff"] <= DATA_TOL

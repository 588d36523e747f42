"""The port's telemetry report (``repro_torch.examples.obs_report``)
against the reference's (``benchmarks/obs_report.py``, loaded by path as
``tests/test_obs.py`` loads it): on the metrics and trace of a port train
CLI run on the CPU both accept and print the same summary, and both
refuse the same broken files — a malformed JSONL line, an unknown event
kind, a trace whose spans overlap without nesting or record a wrong
depth — while a torn final line is dropped by both.  The module's own
entry point exits 0 on the run's artifacts and nonzero on a broken one.
"""
import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from repro_torch.examples import obs_report
from repro_torch.launch import train
from torch_parity import one_torch_thread  # noqa: F401 (autouse)

ROOT = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location(
    "ref_obs_report", ROOT / "benchmarks" / "obs_report.py")
ref_obs_report = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(ref_obs_report)


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    d = tmp_path_factory.mktemp("obs")
    metrics, trace = str(d / "m.jsonl"), str(d / "t.json")
    train.main(["--smoke", "--device", "cpu", "--replicas", "2", "--L", "2",
                "--steps", "4", "--batch", "2", "--seq", "16",
                "--round-fused", "--sync-compress", "int8", "--sync-overlap",
                "--checkpoint-dir", str(d / "ck"), "--checkpoint-every", "2",
                "--metrics-out", metrics, "--trace-out", trace])
    return d, metrics, trace


def _verdict(module, argv, capsys):
    """(True, printed report) or (False, the exception's type)."""
    try:
        assert module.main(argv) == 0
    except (ValueError, KeyError, TypeError) as e:
        capsys.readouterr()
        return False, type(e).__name__
    return True, json.loads(capsys.readouterr().out)


def _both(argv, capsys):
    got = _verdict(obs_report, argv, capsys)
    want = _verdict(ref_obs_report, argv, capsys)
    assert got == want
    return got


def test_run_artifacts_pass_both_with_the_same_summary(artifacts, capsys):
    _, metrics, trace = artifacts
    ok, report = _both(["--metrics", metrics, "--trace", trace], capsys)
    assert ok
    assert report["metrics"]["by_kind"]["checkpoint"] == 2
    assert report["metrics"]["by_kind"]["train_final"] == 1
    assert report["trace"]["spans"]["round"]["count"] == 2
    assert report["trace"]["spans"]["checkpoint"]["count"] == 2


def _lines(path):
    with open(path) as f:
        return f.read().splitlines()


def _write(path, lines):
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return str(path)


@pytest.mark.parametrize("breakage", ["malformed_line", "unknown_kind",
                                      "torn_tail"])
def test_metrics_files_are_judged_alike(artifacts, capsys, breakage):
    d, metrics, _ = artifacts
    lines = _lines(metrics)
    if breakage == "malformed_line":
        lines.insert(1, '{"v": 1, "kind": "checkpoint", "ts"')
    elif breakage == "unknown_kind":
        lines.insert(1, json.dumps({"v": 1, "kind": "no_such_kind",
                                    "ts": 1.0}))
    else:
        lines[-1] = lines[-1][:len(lines[-1]) // 2]
    ok, _ = _both(["--metrics", _write(d / f"{breakage}.jsonl", lines)],
                  capsys)
    assert ok is (breakage == "torn_tail")


@pytest.mark.parametrize("breakage", ["overlap", "depth", "no_events"])
def test_traces_are_judged_alike(artifacts, capsys, breakage):
    d, _, trace = artifacts
    with open(trace) as f:
        chrome = json.load(f)
    xs = [e for e in chrome["traceEvents"] if e["ph"] == "X"]
    outer = max(xs, key=lambda e: e["dur"])
    if breakage == "overlap":
        chrome["traceEvents"].append(dict(
            outer, name="straddle", ts=outer["ts"] + outer["dur"] / 2,
            dur=outer["dur"], args={}))
    elif breakage == "depth":
        outer.setdefault("args", {})["depth"] = 5   # it is top-level
    else:
        chrome = {"events": chrome["traceEvents"]}
    path = d / f"{breakage}.json"
    path.write_text(json.dumps(chrome))
    ok, _ = _both(["--trace", str(path)], capsys)
    assert not ok


def test_entry_point_exit_codes(artifacts, tmp_path):
    _, metrics, trace = artifacts
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    run = lambda *argv: subprocess.run(  # noqa: E731
        [sys.executable, "-m", "repro_torch.examples.obs_report", *argv],
        env=env, capture_output=True, text=True, timeout=120)
    good = run("--metrics", metrics, "--trace", trace)
    assert good.returncode == 0, good.stderr
    bad = tmp_path / "bad.jsonl"
    bad.write_text('{"v": 1, "kind": "nope", "ts": 1.0}\n{}\n')
    assert run("--metrics", str(bad)).returncode != 0
    assert run().returncode == 2            # nothing to do

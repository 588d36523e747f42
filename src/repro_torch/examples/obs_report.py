"""Validate + summarize the port's telemetry artifacts from
``--metrics-out`` / ``--trace-out`` (train, serve, dist_run).  Port of
``benchmarks/obs_report.py``: the same checks, summary and exit codes.

    PYTHONPATH=src python -m repro_torch.examples.obs_report \\
        --metrics /tmp/m.jsonl --trace /tmp/t.json

Checks (exit nonzero on any failure):

* metrics JSONL — every line re-validated against the versioned event
  schema (``repro_torch/obs/events.py``): envelope ``v``/``kind``/``ts``,
  known kind, required fields with the right types.  A torn FINAL line
  (a writer that died mid-write) is dropped with a warning.
* trace JSON — Chrome-trace format: a ``traceEvents`` list whose
  ``"ph": "X"`` complete events carry numeric ``ts``/``dur`` (µs) and a
  ``pid``/``tid`` track; nesting must be well-formed — a span's
  recorded ``args.depth`` is consistent with containment on its track.

The summary prints event counts by kind, the final registry snapshot's
series summaries (counters / gauges / histogram percentiles), and
per-span-name trace stats with compile separated from steady state.
"""
from __future__ import annotations

import argparse
import json
import sys

_NUM = (int, float)
EPS_US = 1.0        # µs slack: timestamps are rounded to 3 decimals


def _check_nesting(track, evs) -> None:
    """Spans of one (pid, tid) track, sorted by start, either contain or
    are disjoint from their predecessor at each depth."""
    evs.sort(key=lambda e: (e["ts"], -e["dur"]))
    stack = []
    for e in evs:
        while stack and e["ts"] >= stack[-1]["ts"] + stack[-1]["dur"] - EPS_US:
            stack.pop()
        if stack and e["ts"] + e["dur"] > (stack[-1]["ts"] + stack[-1]["dur"]
                                           + EPS_US):
            raise ValueError(
                f"track {track}: span {e['name']!r} at ts={e['ts']} "
                f"overlaps its parent {stack[-1]['name']!r} without "
                f"being contained")
        depth = (e.get("args") or {}).get("depth")
        if depth is not None and depth != len(stack):
            raise ValueError(
                f"track {track}: span {e['name']!r} at ts={e['ts']} "
                f"records depth {depth} but containment depth is "
                f"{len(stack)}")
        stack.append(e)


def validate_trace(trace: dict) -> list:
    """Chrome-trace structural validation; returns the X events."""
    if not isinstance(trace, dict) or not isinstance(
            trace.get("traceEvents"), list):
        raise ValueError("trace must be an object with a 'traceEvents' list")
    xs = []
    for i, e in enumerate(trace["traceEvents"]):
        if not isinstance(e, dict) or "ph" not in e or "name" not in e:
            raise ValueError(f"traceEvents[{i}]: every event needs "
                             f"'ph' and 'name'")
        if e["ph"] == "X":
            for field in ("ts", "dur"):
                if not isinstance(e.get(field), _NUM):
                    raise ValueError(
                        f"traceEvents[{i}] ({e['name']!r}): complete "
                        f"events need numeric {field!r}")
            if e.get("dur") < 0:
                raise ValueError(f"traceEvents[{i}]: negative dur")
            xs.append(e)
    by_track = {}
    for e in xs:
        by_track.setdefault((e.get("pid", 0), e.get("tid", 0)),
                            []).append(e)
    for track, evs in by_track.items():
        _check_nesting(track, evs)
    return xs


def summarize_metrics(events: list) -> dict:
    from repro_torch.obs.metrics import snapshot_summaries
    kinds = {}
    for e in events:
        kinds[e["kind"]] = kinds.get(e["kind"], 0) + 1
    out = {"events": len(events), "by_kind": kinds}
    snaps = [e for e in events if e["kind"] in ("metrics_snapshot",
                                                "pod_merged")]
    if snaps:
        out["series"] = snapshot_summaries(snaps[-1]["snapshot"])
    return out


def summarize_trace(xs: list) -> dict:
    by_name = {}
    for e in xs:
        d = by_name.setdefault(e["name"], {"count": 0, "total_us": 0.0})
        d["count"] += 1
        d["total_us"] = round(d["total_us"] + e["dur"], 1)
    compile_us = sum(e["dur"] for e in xs if e.get("cat") == "compile")
    total_us = sum(e["dur"] for e in xs)
    return {"spans": by_name,
            "compile_us": round(compile_us, 1),
            "steady_us": round(total_us - compile_us, 1)}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--metrics", default="",
                    help="metrics JSONL from --metrics-out")
    ap.add_argument("--trace", default="",
                    help="Chrome-trace JSON from --trace-out")
    args = ap.parse_args(argv)
    if not args.metrics and not args.trace:
        ap.error("nothing to do: pass --metrics and/or --trace")

    from repro_torch.obs.events import read_events
    report = {}
    if args.metrics:
        events = read_events(args.metrics, tolerate_torn_tail=True)
        report["metrics"] = summarize_metrics(events)
    if args.trace:
        with open(args.trace) as f:
            xs = validate_trace(json.load(f))
        report["trace"] = summarize_trace(xs)
    print(json.dumps(report, indent=1, sort_keys=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())

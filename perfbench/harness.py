"""One run of one cell: find everything it needs by name, run the cell's
driver, read the per-layer metrics, and build the result line.

What belongs to one configuration, one mix or one per-layer metric is a
file of its own, found by the names in ``BENCHMARK.json``:

* ``configs/<config>.json``: the configuration (its ``model_type``
  names ``reference/<model_type>.py``, the plain model, and
  ``adapters/<model_type>.py``, the program's reading of it);
* ``mixes/<traffic>.json``: the mix (its ``kind`` names
  ``drivers/<kind>.py``, which runs that kind of cell);
* ``limits/<workload>.json``: the limit of each number that decides the
  cell's ``correct``;
* ``metrics/<metric>.py``: the reader of one per-layer metric,
  ``read(record)`` -> a number, or None where it finds nothing to read.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import math
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def manifest(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def find(entries, name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise SystemExit(f"BENCHMARK.json names no {what} {name!r}")


def config(name: str) -> dict:
    cfg = load_json(HERE / "configs" / f"{name}.json")
    cfg["name"] = name
    return cfg


def mix(name: str) -> dict:
    return load_json(HERE / "mixes" / f"{name}.json")


def limits(workload: str) -> dict:
    return load_json(HERE / "limits" / f"{workload}.json")["limits"]


def reader(metric: str):
    """``metrics/<metric>.py`` as a module (a name may hold dots)."""
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "perfbench_metric_" + metric.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_metrics(man: dict, workload: str) -> tuple:
    """(the cell's end-to-end metric entries, its per-layer entries): an
    entry belongs to the cells its ``workloads`` lists, and an end-to-end
    entry without that key to every cell."""
    e2e = [m for m in man["end_to_end"]
           if workload in m.get("workloads", [workload])]
    layer = [m for m in man["per_layer"] if workload in m["workloads"]]
    return e2e, layer


@dataclass
class Cell:
    """Everything a driver is handed for one run."""
    name: str
    cfg: dict
    mix: dict
    limits: dict
    seed: int
    seconds: float
    trace: bool
    device: Any
    t_start: float                  # perf_counter when the run began
    reference: Any = None           # reference/<model_type>.py
    adapter: Any = None             # adapters/<model_type>.py


@dataclass
class Record:
    """What a traced run hands the per-layer readers."""
    cfg: dict
    mix: dict
    spans: list = field(default_factory=list)   # (name, dur_s, attrs)
    window: Optional[Any] = None                # devtrace.Window
    extra: dict = field(default_factory=dict)


@dataclass
class Outcome:
    """What a driver returns."""
    correct: bool
    attempted: int
    failed: int
    metrics: dict                  # end-to-end values by name
    memory_peak_bytes: int
    checks: dict
    record: Optional[Record] = None
    readings: dict = field(default_factory=dict)   # for calibrate.py


def open_cell(name: str, seed: int, seconds: float, trace: bool, device,
              t_start: Optional[float] = None, man: Optional[dict] = None,
              cfg: Optional[dict] = None,
              mix_over: Optional[dict] = None) -> Cell:
    """The Cell of workload ``name``; ``cfg`` in place of its
    configuration file and ``mix_over`` over its mix's entries are the
    tests' small sizes."""
    man = man if man is not None else manifest()
    w = find(man["workloads"], name, "workload")
    cfg = cfg if cfg is not None else config(w["config"])
    m = dict(mix(w["traffic"]), **(mix_over or {}))
    return Cell(name=name, cfg=cfg, mix=m,
                limits=limits(name), seed=int(seed), seconds=float(seconds),
                trace=bool(trace), device=device,
                t_start=time.perf_counter() if t_start is None else t_start,
                reference=importlib.import_module(
                    f"perfbench.reference.{cfg['model_type']}"),
                adapter=importlib.import_module(
                    f"perfbench.adapters.{cfg['model_type']}"))


def drive(cell: Cell) -> Outcome:
    driver = importlib.import_module(f"perfbench.drivers.{cell.mix['kind']}")
    return driver.run(cell)


def result(man: dict, cell: Cell, out: Outcome, device_info: dict) -> dict:
    """The result line: with tracing off the cell's end-to-end metrics,
    with it on its per-layer metrics (those whose reader found
    something), the device, the breakdown, and the checks last."""
    e2e, layer = cell_metrics(man, cell.name)
    line = {"correct": bool(out.correct), "attempted": int(out.attempted),
            "failed": int(out.failed)}
    metrics = {}
    if not cell.trace:
        for m in e2e:
            metrics[m["name"]] = {"value": out.metrics[m["name"]],
                                  "unit": m["unit"]}
    else:
        for m in layer:
            v = reader(m["name"]).read(out.record)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    line["metrics"] = metrics
    dev = dict(device_info, memory_peak_bytes=int(out.memory_peak_bytes))
    if cell.trace and out.record is not None and out.record.window:
        win = out.record.window
        dev.update(busy_s=win.busy_s(), window_s=win.seconds)
        line["breakdown"] = {"device_ops": win.top_ops(),
                             "idle_gaps": win.idle_gaps()}
    line["device"] = dev
    line["checks"] = out.checks
    return finite(line)


def finite(x):
    """``x`` with every float that is not finite (a missing request's
    latency) written as null, so the line stays JSON."""
    if isinstance(x, dict):
        return {k: finite(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [finite(v) for v in x]
    if isinstance(x, float) and not math.isfinite(x):
        return None
    return x

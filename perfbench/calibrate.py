"""The readings that the benchmark's bounds and limits are set from, run
on the card (not part of a benchmark run):

    python3 perfbench/calibrate.py readings --workload <name> \\
        --seeds 1,2,3 [--seconds S] [--faults]
    python3 perfbench/calibrate.py sweep --workload <serve cell> \\
        --rates 2,4,6 --seconds S --seeds 1,2,3

``readings``: for each seed, one process reads the program's numbers
(a run of the cell with a short window), the control's (the plain
reference computed with TF32 products, put in the program's place,
against the float32 reference) and, with ``--faults``, those of the
faults the cell can have, planted in the program: for training, half of
each batch left out (the mean over the rest) and the replicas' exchange
left out (x̄ the first replica's x alone); for serving, a token altered
where it is produced (the second best where the best id is a multiple
of 61).  A state that is returned unchanged reads 1 by the measure of
``check.py`` and needs no run.  ``sweep``: a serving cell at each rate
and seed (the seed drawing the mix's order too, so that each seed offers
another order), its tails and its admission waits, then the knee: the highest
rate below the first at which some seed's 95th-percentile wait for a
slot passes ``WAIT_S`` (the engine's slots stay full and requests queue
for them).

Each line goes to standard output and to ``--out`` (default
``results/calibrate-<workload>.jsonl``).
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:] = [str(ROOT), str(ROOT / "src")] + [
    p for p in sys.path
    if p and Path(p).resolve() != Path(__file__).resolve().parent]

import numpy as np  # noqa: E402
import torch  # noqa: E402

from perfbench import check, harness, stats  # noqa: E402
from perfbench.faults import (altered_token, half_batch,  # noqa: E402
                              no_exchange, undo)
from perfbench.reference import lm  # noqa: E402
from perfbench.reference.products import Products  # noqa: E402
from perfbench.reference.weights import make_params  # noqa: E402


WAIT_S = 1.0       # a few engine steps: a request waits for a free slot


def knee(points) -> float:
    """The highest swept rate sustained on every seed, each rate below
    the first that is not: ``points`` are (rate, 95th-percentile
    admission wait in s) of every run; None where the lowest rate
    already fails."""
    worst = {}
    for rate, wait in points:
        worst[rate] = max(worst.get(rate, 0.0), wait)
    best = None
    for rate in sorted(worst):
        if worst[rate] > WAIT_S:
            break
        best = rate
    return best


def emit(path: Path, rec: dict) -> None:
    line = json.dumps(harness.finite(rec))
    print(line, flush=True)
    with open(path, "a") as f:
        f.write(line + "\n")


def free():
    import gc
    gc.collect()
    torch.cuda.empty_cache()


def train_seed(name, seed, seconds, faults, dev):
    from perfbench.drivers import train
    cell = harness.open_cell(name, seed, seconds, False, dev)
    out = harness.drive(cell)
    ref, batches = out.readings["ref"], out.readings["batches"]
    rec = {"seed": seed,
           "program": check.train_numbers(out.readings["prog"], ref),
           "train_tokens_per_s": out.metrics["train_tokens_per_s"],
           "setup_s": out.metrics["setup_s"],
           "memory_peak_bytes": out.memory_peak_bytes,
           "where": check.worst(out.readings["prog"], ref),
           "losses": {"program": out.readings["prog"]["losses"],
                      "reference": ref["losses"]},
           "paths": [".".join(p) for p in ref["paths"]]}
    free()
    t = time.perf_counter()
    ctl = train.reference_readings(cell, batches, Products(tf32=True))
    rec["control"] = check.train_numbers(ctl, ref)
    rec["control_loss_steps"] = check.worst(ctl, ref)["loss_steps"]
    rec["reference_s"] = time.perf_counter() - t
    if faults:
        rec["faults"] = {}
        for fault in (half_batch, no_exchange):
            monkey = []
            fault(monkey)
            try:
                job = train.Job(harness.open_cell(name, seed, seconds,
                                                  False, dev))
                rec["faults"][fault.__name__] = check.train_numbers(
                    job.readings, ref)
                del job
            finally:
                undo(monkey)
            free()
    return rec


def control_gap(cell, sample) -> float:
    """The widest f32 gap of the token that TF32 products put first, at
    every position of the sampled prompts and served tokens."""
    cfg, dev = cell.cfg, cell.device
    params = make_params(cell.reference.leaves(cfg), cell.seed, dev)
    gap = 0.0
    for prompt, served in sample:
        p = torch.as_tensor(prompt, device=dev)
        s = torch.as_tensor(np.asarray(served).reshape(-1), device=dev)
        with Products(False).active() as f32:
            exact = lm.served_logits(cell.reference, params, cfg, p, s, f32)
        with Products(True).active() as tf32:
            low = lm.served_logits(cell.reference, params, cfg, p, s, tf32)
        gap = max(gap, lm.widest_gap(exact, low.argmax(-1)))
    return gap


def serve_seed(name, seed, seconds, faults, dev, mix_over=None):
    cell = harness.open_cell(name, seed, seconds, False, dev,
                             mix_over=mix_over)
    out = harness.drive(cell)
    r = out.readings
    wait = r["admit_wait_s"]
    rec = {"seed": seed,
           "program": {k: c["value"] for k, c in out.checks.items()},
           "metrics": out.metrics, "due": r["due"],
           "done_in_window": r["done_in_window"],
           "ttft_p50_ms": 1e3 * stats.percentile(r["ttft_s"], 50),
           "admit_wait_p95_s": stats.percentile(wait, 95),
           "admit_wait_max_s": max(wait),
           "served_tokens": int(sum(np.asarray(t).size
                                    for _, t in r["sample"])),
           "memory_peak_bytes": out.memory_peak_bytes}
    free()
    if faults:
        rec["control"] = {"served_gap": control_gap(cell, r["sample"])}
        monkey = []
        altered_token(monkey)
        try:
            bad = harness.drive(harness.open_cell(name, seed, seconds,
                                                  False, dev,
                                                  mix_over=mix_over))
            rec["faults"] = {"altered_token": {
                k: c["value"] for k, c in bad.checks.items()}}
        finally:
            undo(monkey)
        free()
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("mode", choices=("readings", "sweep"))
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--rates", default="")
    ap.add_argument("--faults", action="store_true")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    dev = torch.device("cuda", 0)
    out = Path(args.out or ROOT / "results" /
               f"calibrate-{args.workload}.jsonl")
    out.parent.mkdir(parents=True, exist_ok=True)
    kind = harness.mix(harness.find(harness.manifest()["workloads"],
                                    args.workload, "workload")["traffic"]
                       )["kind"]
    if args.mode == "sweep":
        base = harness.mix(harness.find(harness.manifest()["workloads"],
                                        args.workload, "workload")
                           ["traffic"])
        points = []
        for rate in (float(v) for v in args.rates.split(",")):
            for seed in (int(v) for v in args.seeds.split(",")):
                over = {"arrivals": dict(base["arrivals"], rate_per_s=rate),
                        "check_sample": 1, "drain_s": 15, "order_seed": seed}
                rec = serve_seed(args.workload, seed, args.seconds, False,
                                 dev, mix_over=over)
                emit(out, dict(rec, rate_per_s=rate))
                points.append((rate, rec["admit_wait_p95_s"]))
        emit(out, {"knee_per_s": knee(points), "wait_limit_s": WAIT_S})
        return
    for seed in (int(v) for v in args.seeds.split(",")):
        t = time.perf_counter()
        fn = train_seed if kind == "train" else serve_seed
        rec = fn(args.workload, seed, args.seconds, args.faults, dev)
        emit(out, dict(rec, wall_s=time.perf_counter() - t))


if __name__ == "__main__":
    main()

"""Run one cell of the benchmark once:

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout on a machine with the card(s) the cell asks
for.  The run makes its weights and inputs from ``--seed``, warms up
(set-up), measures for ``--seconds``, checks the timed path's outputs
against the plain reference, and prints one JSON object as the last line
of standard output: ``correct``, ``attempted``, ``failed``, ``metrics``
(the cell's end-to-end metrics with ``--trace 0``, its per-layer metrics
with ``--trace 1``), ``device`` and, traced, ``breakdown``; ``checks``
last, each number compared beside its limit, which are also the last
lines of standard error.  It exits non-zero and prints no result where
there is no CUDA card (or fewer than the cell asks for), where the
program is not beside it, or where JAX or the JAX package got loaded.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def caches(root: Path) -> None:
    """Every build and kernel cache at a fixed path inside the checkout
    (``build/``, where the program's ``kernels/build.py`` puts its nvcc
    builds too)."""
    os.environ["TRITON_CACHE_DIR"] = str(root / "build" / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(root / "build" /
                                             "torch_extensions")
    os.environ["USE_FLAX"] = "0"


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's, jaxlib's, flax's or
    the JAX package's (whole names: ``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    caches(ROOT)
    # the repository root and the program's source, not this script's
    # folder: a module here must not stand in for a standard one
    here = str(Path(__file__).resolve().parent)
    sys.path[:] = [str(ROOT), str(ROOT / "src")] + [
        p for p in sys.path if p and Path(p).resolve() != Path(here)]

    import torch
    from perfbench import check, harness

    man = harness.manifest(ROOT)
    w = harness.find(man["workloads"], args.workload, "workload")
    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark measures the card",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < w["chips"]:
        print(f"{args.workload} needs {w['chips']} cards, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    torch.cuda.init()
    print(f"set-up: torch imported and the card's context made at "
          f"{time.perf_counter() - T_START:.3f} s", file=sys.stderr)
    cell = harness.open_cell(args.workload, args.seed, args.seconds,
                             bool(args.trace), device, t_start=T_START,
                             man=man)
    out = harness.drive(cell)
    from perfbench import roofline
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": w["chips"], "power_limit_w": roofline.power_limit_w()}
    line = harness.result(man, cell, out, info)
    bad = forbidden_modules()
    if bad:
        print(f"modules of JAX or the JAX package were loaded: {bad}",
              file=sys.stderr)
        return 3
    sys.stdout.flush()
    for text in check.lines(line["checks"]):
        print(text, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

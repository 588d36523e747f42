"""The dry run's records as one markdown table: a row for each (arch,
mesh), a cell for each input shape with, of the pair's largest program,
the bytes a card holds at its peak (arguments + temp, GiB), whether they
fit the card, the dominant roofline term and the FLOPs a card.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both
    python3 tools/dryrun_table.py results/dryrun

Extrapolated pairs are marked "(x)".  Reads only the JSON files ``launch/dryrun.py`` writes.
"""
from __future__ import annotations

import json
import os
import sys

MESHES = (("sp", "16x16"), ("mp", "2x16x16"))
SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")
TERMS = {"compute_s": "compute", "memory_s": "mem", "collective_s": "coll"}


def cell(rec) -> str:
    if rec is None:
        return "—"
    prog = max(rec["programs"], key=lambda p: p["flops_per_device"])
    mem = prog["memory"]
    gib = (mem["argument_size_bytes"] + mem["temp_size_bytes"]) / 2 ** 30
    mark = " (x)" if prog["accounting"].startswith("depth") else ""
    return (f"{gib:.1f}{mark} · {'yes' if mem['fits'] else 'no'} · "
            f"{TERMS[prog['dominant']]} · {prog['flops_per_device']:.3g}")


def main(argv=None) -> int:
    folder = (argv or sys.argv[1:] or ["results/dryrun"])[0]
    recs = {}
    for name in os.listdir(folder):
        if name.endswith(".json"):
            with open(os.path.join(folder, name)) as f:
                rec = json.load(f)
            tag = name[:-len(".json")].split("__")[2]
            recs[(rec["arch"], tag, rec["shape"])] = rec
    print("| arch | mesh | " + " | ".join(SHAPES) + " |")
    print("|---|---|" + "---|" * len(SHAPES))
    for arch in sorted({k[0] for k in recs}):
        for tag, mesh in MESHES:
            cells = " | ".join(cell(recs.get((arch, tag, shape)))
                               for shape in SHAPES)
            print(f"| {arch} | {mesh} | {cells} |")
    return 0


if __name__ == "__main__":
    sys.exit(main())

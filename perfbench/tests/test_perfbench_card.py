"""On the card: one short traced run of each cell through the command
(15 s: a training cell profiles its window's second round), its last
line of the contract's shape.  Skips without a CUDA card; run on the
card with ``python -m pytest -m gpu perfbench/tests``."""
import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
MAN = json.loads((ROOT / "BENCHMARK.json").read_text())


@pytest.mark.gpu
@pytest.mark.parametrize("w", MAN["workloads"], ids=lambda e: e["name"])
def test_cell_runs_on_the_card(card, w):
    out = subprocess.run(
        [sys.executable, *MAN["command"][1:], "--workload", w["name"],
         "--seed", str(2**31 + 7), "--seconds", "15", "--trace", "1"],
        capture_output=True, text=True, cwd=ROOT, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert list(line)[-1] == "checks"
    assert line["correct"] is True, line["checks"]
    dev = line["device"]
    assert dev["platform"] == "gpu" and dev["count"] == w["chips"]
    assert 0 < dev["busy_s"] <= dev["window_s"]
    assert line["metrics"]
    for m in line["metrics"].values():
        if m["unit"] == "%":
            assert 0 < m["value"] <= 105

"""BENCHMARK.json against the benchmark's contract: names and units of
the allowed characters, every per-layer metric reported where the metric
it moves is, every file the manifest names present, and the run length
inside the check's budget."""
import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
MAN = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
WIDTHS = {"hidden_size", "intermediate_size", "d_model", "d_intermediate",
          "d_state", "headdim", "head_dim", "expand", "d_conv",
          "num_experts_per_tok", "moe_intermediate_size"}


def metrics():
    return MAN["end_to_end"] + MAN["per_layer"]


def test_keys_exactly():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}


@pytest.mark.parametrize("entry", MAN["configs"] + MAN["workloads"]
                         + metrics(), ids=lambda e: e["name"])
def test_names_and_text(entry):
    assert NAME.match(entry["name"])
    for key in ("why", "layer", "source"):
        if key in entry:
            assert 1 <= len(entry[key]) <= 200
            assert "\n" not in entry[key] and "\t" not in entry[key]
    if "unit" in entry:
        assert UNIT.match(entry["unit"])
        assert entry["better"] in ("lower", "higher")
    for key in ("config", "traffic"):
        if key in entry:
            assert NAME.match(entry[key])


def test_unique_names():
    for group in (MAN["configs"], MAN["workloads"], metrics()):
        names = [e["name"] for e in group]
        assert len(names) == len(set(names))


@pytest.mark.parametrize("cfg", MAN["configs"], ids=lambda e: e["name"])
def test_config_files(cfg):
    path = ROOT / cfg["file"]
    assert cfg["file"].startswith("perfbench/") and path.exists()
    data = json.loads(path.read_text())
    assert data["reduced"] == cfg["reduced"] and len(cfg["reduced"]) <= 16
    for key in cfg["reduced"]:
        assert NAME.match(key)
        assert not key.endswith(("_dim", "_rank"))
        assert key not in WIDTHS, key


@pytest.mark.parametrize("w", MAN["workloads"], ids=lambda e: e["name"])
def test_cell_files(w):
    here = ROOT / "perfbench"
    assert w["config"] in {c["name"] for c in MAN["configs"]}
    assert (here / "mixes" / f"{w['traffic']}.json").exists()
    assert (here / "limits" / f"{w['name']}.json").exists()
    assert w["chips"] == 1


def _cell_e2e(w):
    return {m["name"] for m in MAN["end_to_end"]
            if w in m.get("workloads", [w])}


@pytest.mark.parametrize("w", MAN["workloads"], ids=lambda e: e["name"])
def test_each_cell_reports_what_its_layers_move(w):
    e2e = _cell_e2e(w["name"])
    assert "setup_s" in e2e and len(e2e) >= 2
    layer = [m for m in MAN["per_layer"] if w["name"] in m["workloads"]]
    assert layer
    for m in layer:
        assert m["moves"] in e2e, (m["name"], w["name"])


@pytest.mark.parametrize("m", MAN["per_layer"], ids=lambda e: e["name"])
def test_per_layer_reader_and_sources(m):
    assert (ROOT / "perfbench" / "metrics" / f"{m['name']}.py").exists()
    assert m["source"] in ("device_trace", "program_span",
                           "program_counter", "host_clock")
    assert m["moves"] in {e["name"] for e in MAN["end_to_end"]}
    assert set(m) <= {"name", "unit", "better", "source", "layer", "moves",
                      "workloads"}
    # each lists the cells it reads in: the harness reads it there alone
    assert m["workloads"] and set(m["workloads"]) <= {
        w["name"] for w in MAN["workloads"]}


def test_end_to_end_bounds():
    for m in MAN["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    setup = [m for m in MAN["end_to_end"] if m["name"] == "setup_s"]
    assert setup and "workloads" not in setup[0]


def test_run_seconds_fit_the_check_with_24_cells():
    s = MAN["run_seconds"]
    assert isinstance(s, int) and 1 <= s <= 51
    cells = 24
    assert (2 + 14 * cells) * (s + 60) + cells * 2 * 90 + 1200 <= 43200


def test_command_and_paths():
    assert MAN["paths"] == ["perfbench"]
    assert MAN["command"] == ["python3", "perfbench/run.py"]

"""What decides ``correct``, driven on the CPU at small sizes with each
cell's own limits (the harness's look for a card skipped): sound runs of
the four kinds of cell come out correct; the faults each cell can have,
planted in the program, come out not correct; and the control, the plain
reference with TF32 products in the program's place, fails a limit."""
import json
from pathlib import Path

import pytest
import torch

from perfbench import check, faults, harness, traffic
from perfbench.drivers import train
from perfbench.reference import lm
from perfbench.reference.products import Products
from perfbench.reference.weights import make_params
from perfbench_small import CELLS, manifest, open_small

TRAIN = ["qwen2.5-3b.train.seq2048", "mamba2-1.3b.train.seq2048"]
SERVE = ["qwen2.5-3b.serve.chat", "mamba2-1.3b.serve.chat"]
LIMITS = sorted((Path(__file__).resolve().parents[1] / "limits").glob("*.json"))


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_sound_run_is_correct(cell):
    c = open_small(cell, seconds=1.5)
    out = harness.drive(c)
    line = harness.result(manifest(), c, out, {"platform": "cpu"})
    assert line["correct"], line["checks"]
    assert list(line)[-1] == "checks"
    assert out.failed == 0 and out.attempted > 0


@pytest.mark.parametrize("fault", [faults.frozen_state,
                                   faults.half_batch,
                                   faults.no_exchange],
                         ids=lambda f: f.__name__)
@pytest.mark.parametrize("cell", TRAIN)
def test_training_fault_is_not_correct(cell, fault):
    monkey = []
    fault(monkey)
    try:
        out = harness.drive(open_small(cell, seconds=0.5))
    finally:
        faults.undo(monkey)
    assert not out.correct, out.checks


@pytest.mark.parametrize("cell", SERVE)
def test_altered_token_is_not_correct(cell):
    monkey = []
    faults.altered_token(monkey, every=2)
    try:
        out = harness.drive(open_small(cell, seconds=1.5))
    finally:
        faults.undo(monkey)
    assert not out.correct, out.checks


@pytest.mark.parametrize("cell", TRAIN)
def test_training_control_fails(cell):
    c = open_small(cell)
    batches = traffic.train_batches(c.mix, c.cfg, c.seed, c.device)
    ref = train.reference_readings(c, batches, Products(False))
    low = train.reference_readings(c, batches, Products(True))
    ok, checks = check.verdict(check.train_numbers(low, ref), c.limits)
    assert not ok, checks


@pytest.mark.parametrize("weights", [3, 4])
@pytest.mark.parametrize("cell", SERVE)
def test_serving_control_fails(cell, weights):
    """The control reads the f32 gap of the token TF32 puts first at
    every position of 2000 positions."""
    c = open_small(cell)
    params = make_params(c.reference.leaves(c.cfg), weights,
                         torch.device("cpu"))
    seq = torch.randint(0, 250, (2000,),
                        generator=torch.Generator().manual_seed(2))
    args = (c.reference, params, c.cfg, seq[:10], seq[10:])
    exact = lm.served_logits(*args, Products(False))
    low = lm.served_logits(*args, Products(True))
    gap = lm.widest_gap(exact, low.argmax(-1))
    assert gap > c.limits["served_gap"]
    assert lm.widest_gap(exact, exact.argmax(-1)) == 0.0


@pytest.mark.parametrize("path", LIMITS, ids=lambda p: p.stem)
def test_limits_name_only_computed_numbers(path):
    """Every number a limits file holds is one the checks compute, and a
    training cell compares each leaf's change by its worst leaf."""
    names = set(json.loads(path.read_text())["limits"])
    if ".train." in path.name:
        assert {"loss_gap", "grad_gap", "change_gap"} <= names <= {
            "loss_gap", "grad_gap", "change_gap", "change_gap_median"}
    else:
        assert names == {"served_gap", "wrong_length", "missing"}

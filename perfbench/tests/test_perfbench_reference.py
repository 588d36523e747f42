"""The plain references equal ``repro_torch`` at small widths on the CPU,
on the benchmark's own weights: the dense decoder's and Mamba2's logits,
and one Parle round's readings."""
import pytest
import torch

from perfbench.drivers import train
from perfbench.reference import lm, mamba2, qwen2
from perfbench.reference.products import Products
from perfbench.reference.weights import make_params
from perfbench_small import MAMBA, QWEN, open_small

CASES = {"qwen2": (QWEN, qwen2), "mamba2": (MAMBA, mamba2)}


@pytest.mark.parametrize("name", sorted(CASES))
def test_logits_equal_the_program(name):
    from perfbench.adapters import mamba2 as am, qwen2 as aq
    from repro_torch.models.model import build_model
    cfg, ref = CASES[name]
    adapter = aq if name == "qwen2" else am
    params = make_params(ref.leaves(cfg), 11, torch.device("cpu"))
    tokens = torch.randint(0, 250, (2, 48), generator=torch.Generator()
                           .manual_seed(0), dtype=torch.int32)
    model = build_model(adapter.port_config(cfg))
    with torch.no_grad():
        got, _ = model.apply(params, {"tokens": tokens})
        want = ref.logits(params, cfg, ref.hidden(params, cfg, tokens))
    assert got.shape == want.shape
    torch.testing.assert_close(got, want, rtol=1e-5, atol=2e-5)


@pytest.mark.parametrize("name", sorted(CASES))
def test_served_logits_are_the_forward_rows(name):
    cfg, ref = CASES[name]
    params = make_params(ref.leaves(cfg), 12, torch.device("cpu"))
    seq = torch.randint(0, 250, (40,), generator=torch.Generator()
                        .manual_seed(1))
    full = ref.logits(params, cfg, ref.hidden(params, cfg, seq[None]))[0]
    rows = lm.served_logits(ref, params, cfg, seq[:30], seq[30:], rows=4)
    torch.testing.assert_close(rows, full[29:39], rtol=1e-5, atol=1e-5)
    assert lm.widest_gap(rows, rows.argmax(-1)) == 0.0


@pytest.mark.parametrize("cell", ["qwen2.5-3b.train.seq2048",
                                  "mamba2-1.3b.train.seq2048"])
def test_parle_round_equals_the_program(cell):
    c = open_small(cell)
    job = train.Job(c)
    ref = train.reference_readings(c, job.batches, Products(False))
    prog = job.readings
    torch.testing.assert_close(torch.tensor(prog["losses"]),
                               torch.tensor(ref["losses"]), rtol=1e-6,
                               atol=0)
    for field in ("grad", "change"):
        torch.testing.assert_close(torch.tensor(prog[field]),
                                   torch.tensor(ref[field]), rtol=1e-4,
                                   atol=1e-9)

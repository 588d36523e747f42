"""The benchmark's operation counts equal what
``torch.utils.flop_counter.FlopCounterMode`` sees of ``repro_torch``'s
loss at a small size: the forward exactly; forward and backward, three
forwards and the CE's recomputed head (Mamba2 less the first chunk's
state, which needs no grad)."""
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from perfbench import roofline
from perfbench.reference import mamba2, qwen2
from perfbench.reference.weights import leaf_items, make_params
from perfbench_small import MAMBA, QWEN

CASES = {"qwen2": (QWEN, qwen2), "mamba2": (MAMBA, mamba2)}


@pytest.mark.parametrize("name", sorted(CASES))
def test_counts_equal_flop_counter(name):
    from perfbench.adapters import mamba2 as am, qwen2 as aq
    from repro_torch.models.model import build_model
    cfg, ref = CASES[name]
    adapter = aq if name == "qwen2" else am
    params = make_params(ref.leaves(cfg), 5, torch.device("cpu"))
    model = build_model(adapter.port_config(cfg))
    B, T = 2, 64
    tok = torch.randint(0, 250, (B, T), dtype=torch.int32)
    batch = {"tokens": tok, "labels": tok}
    with torch.no_grad(), FlopCounterMode(display=False) as fc:
        model.loss(params, batch)
    fwd = fc.get_total_flops()
    assert fwd == roofline.forward_flops(cfg, B, T, as_computed=True)
    assert roofline.forward_flops(cfg, B, T) < fwd    # the causal half
    for _, t in leaf_items(params):
        t.requires_grad_(True)
    with FlopCounterMode(display=False) as fc:
        loss, _ = model.loss(params, batch)
        loss.backward()
    head = 2 * B * T * roofline.head_params(cfg)
    total = fc.get_total_flops()
    if name == "qwen2":
        assert total == 3 * fwd + head
    else:
        assert 3 * fwd < total <= 3 * fwd + head


@pytest.mark.parametrize("name", sorted(CASES))
def test_param_count(name):
    cfg, ref = CASES[name]
    params = make_params(ref.leaves(cfg), 5, torch.device("cpu"))
    assert roofline.param_count(cfg) == sum(t.numel() for _, t in
                                            leaf_items(params))


def test_kernel_bytes_match_the_kernel_table():
    # K1 and K2 at 2 x 2^26 f32: 1.282080 and 0.881430 ms at 3.35 TB/s
    M = 2 ** 26
    assert roofline.k1_bytes(2, M) / roofline.PEAK_BYTES_PER_S * 1e3 == \
        pytest.approx(1.282080, rel=1e-5)
    assert roofline.k2_bytes(2, M) / roofline.PEAK_BYTES_PER_S * 1e3 == \
        pytest.approx(0.881430, rel=1e-5)


def test_full_size_counts():
    import json
    from pathlib import Path
    here = Path(__file__).resolve().parents[1] / "configs"
    q = json.loads((here / "qwen2.5-3b.json").read_text())
    assert roofline.param_count(q) == 3_085_938_688
    m = json.loads((here / "mamba2-1.3b.json").read_text())
    assert roofline.layer_matmul_params(m) == 2048 * 8512 + 4096 * 2048

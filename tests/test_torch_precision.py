"""Every entry point of the port computes float32 products in float32: it
turns TF32 off for cuBLAS and cuDNN (``runtime/precision.py::
pin_float32``), whatever the caller's process had set.  PyTorch's own
default for ``torch.backends.cudnn.allow_tf32`` is True, so without the
pin the All-CNN convolutions (``models/convnet.py``) would run in TF32
on a card, where the reference computes in float32."""
import pytest
import torch

from repro_torch.examples import (fig1_overlap, quickstart, serve_batched,
                                  split_data, table1_baselines,
                                  table2_split_data, train_llm_parle)
from repro_torch.launch import serve, train
from repro_torch.runtime.precision import pin_float32

ENTRY_POINTS = {
    "train": (train.main, ["--smoke", "--device", "cpu", "--steps", "1",
                           "--replicas", "1", "--batch", "1", "--seq", "8"]),
    "serve": (serve.main, ["--arch", "qwen2.5-3b", "--smoke", "--device",
                           "cpu", "--requests", "1", "--slots", "1",
                           "--prompt-len", "4", "--gen", "2"]),
    # no training step: both models are the init, the claim holds
    # with equality (test_torch_convnet.py runs the 400-step claim)
    "quickstart": (quickstart.main, ["--device", "cpu", "--steps", "0"]),
    # the paper's experiments and examples at a step or two
    "table1": (table1_baselines.main, ["--device", "cpu", "--steps", "2"]),
    "table2": (table2_split_data.main, ["--device", "cpu", "--steps", "2"]),
    "fig1": (fig1_overlap.main, ["--device", "cpu", "--steps", "2"]),
    "split_data": (split_data.main, ["--device", "cpu", "--steps", "0"]),
    "train_llm_parle": (train_llm_parle.main, [
        "--device", "cpu", "--steps", "1", "--batch", "1", "--seq", "8",
        "--checkpoint", ""]),
    "serve_batched": (serve_batched.main, [
        "--arch", "llama3-8b", "--device", "cpu", "--batch", "1",
        "--prompt-len", "4", "--gen", "2"]),
}


def _flags():
    return (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32,
            torch.get_float32_matmul_precision())


@pytest.fixture
def tf32_on():
    """Every flag at its TF32 value for the test; the caller's values
    come back afterwards."""
    saved = _flags()
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    torch.set_float32_matmul_precision("medium")
    yield
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = saved[:2]
    torch.set_float32_matmul_precision(saved[2])


@pytest.mark.parametrize("entry", sorted(ENTRY_POINTS))
def test_entry_point_leaves_tf32_off(entry, tf32_on, capsys):
    main, argv = ENTRY_POINTS[entry]
    assert _flags() == (True, True, "medium")
    main(argv)
    assert _flags() == (False, False, "highest")


def test_pin_float32_sets_all_three_flags(tf32_on):
    pin_float32()
    assert _flags() == (False, False, "highest")

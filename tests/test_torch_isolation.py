"""The port stands alone: no file of ``src/repro_torch/``, not
``chip_smoke.py`` and not the port's tools (``tools/*.py``) imports JAX
or the JAX package, and importing the port loads neither."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"] + sorted((ROOT / "tools").glob("*.py"))


def _forbidden(module: str) -> bool:
    return module.split(".")[0] in ("jax", "jaxlib", "repro")


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 \
                and node.module and _forbidden(node.module):
            bad.append(node.module)
    assert not bad, f"{path.name} imports {bad}"


def test_importing_the_port_loads_no_jax():
    code = ("import sys, repro_torch, repro_torch.serving, "
            "repro_torch.launch.serve, repro_torch.kernels.ops, "
            "repro_torch.launch.train, repro_torch.core.algorithm, "
            "repro_torch.checkpoint.checkpoint, "
            "repro_torch.examples.quickstart, repro_torch.models.convnet, "
            "repro_torch.launch.steps, repro_torch.models.mamba2, "
            "repro_torch.kernels.flash_attention, "
            "repro_torch.kernels.ssd_scan, repro_torch.examples.common, "
            "repro_torch.examples.table1_baselines, "
            "repro_torch.examples.table2_split_data, "
            "repro_torch.examples.fig1_overlap, "
            "repro_torch.examples.split_data, "
            "repro_torch.examples.train_llm_parle, "
            "repro_torch.examples.serve_batched, "
            "repro_torch.sharding.partition, repro_torch.launch.mesh, "
            "repro_torch.launch.dist_run, repro_torch.core.entropy_sgd, "
            "repro_torch.runtime.coordinator, repro_torch.runtime.faults, "
            "repro_torch.data.threefry, repro_torch.examples.obs_report, "
            "repro_torch.sharding.rules, repro_torch.sharding.planner, "
            "repro_torch.launch.specs, repro_torch.launch.dryrun\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro'))\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr

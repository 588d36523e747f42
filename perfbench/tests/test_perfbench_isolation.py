"""What the benchmark loads: in a fresh interpreter, a run's modules (the
harness, the drivers, the adapters, every reader, and a small cell of
each kind driven on the CPU) include nothing whose top-level name is
``jax``, ``jaxlib``, ``flax`` or the JAX package's ``repro`` (names
compared whole: ``repro_torch`` is the program), and the references load
nothing of ``repro_torch``.  Without a card the command prints no
result and exits non-zero."""
import ast
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
HERE = ROOT / "perfbench"
ENV_PATH = f"{ROOT}:{ROOT / 'src'}:{HERE / 'tests'}"


def top_modules(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys, json\n"
         "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
        capture_output=True, text=True, cwd=ROOT, timeout=600,
        env={"PYTHONPATH": ENV_PATH, "PATH": "/usr/bin:/bin",
             "OMP_NUM_THREADS": "2"})
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax():
    code = """
import glob, torch
from perfbench import harness, calibrate, devtrace, faults, roofline, traffic
from perfbench.drivers import serve, train
from perfbench.adapters import mamba2, qwen2
import perfbench_small as small
for f in sorted(glob.glob('perfbench/metrics/*.py')):
    harness.reader(f.split('/')[-1][:-3])
for name in ('qwen2.5-3b.train.seq2048', 'mamba2-1.3b.serve.chat'):
    harness.drive(small.open_small(name))
"""
    mods = top_modules(code)
    assert "repro_torch" in mods
    assert not mods & {"jax", "jaxlib", "flax", "repro"}


def test_the_references_load_nothing_of_the_program():
    code = ("from perfbench.reference import lm, mamba2, parle, products, "
            "qwen2, weights")
    mods = top_modules(code)
    assert not mods & {"repro_torch", "repro", "jax", "jaxlib", "flax"}


def test_reference_sources_import_no_program():
    for path in sorted((HERE / "reference").glob("*.py")):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for n in names:
                assert n.split(".")[0] in {"__future__", "contextlib",
                                           "hashlib", "math", "typing",
                                           "torch", "numpy", "perfbench"}, \
                    (path.name, n)
                if n.startswith("perfbench"):
                    assert n.startswith("perfbench.reference"), (path, n)


def test_no_card_no_result():
    out = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload",
         "qwen2.5-3b.train.seq2048", "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, cwd=ROOT,
        timeout=300, env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert out.stdout.strip() == ""

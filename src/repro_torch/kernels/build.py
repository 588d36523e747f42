"""Build the port's CUDA sources and load them with ``ctypes``.

Each ``csrc/<name>.cu`` exposes a plain C interface (no PyTorch headers,
so ``nvcc`` takes seconds, not minutes).  It is compiled for Hopper
(``sm_90a``) into ``build/<name>-<hash>.so`` at the repository root, at
the first CUDA launch that needs it; the hash (``digest``) covers the
source, every shared header ``csrc/*.cuh`` and the flags, so an edited
source or header is rebuilt and an unchanged one is loaded from the
earlier build.  ``nvcc``'s ``-Xptxas -v`` report (registers,
shared memory, spills per kernel) is kept beside the library as
``<name>-<hash>.log``.

Nothing here runs at import: importing the port needs no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


@dataclass
class Library:
    lib: ctypes.CDLL
    path: Path
    build_s: float       # nvcc wall time; 0.0 when an earlier build was loaded
    report: str          # nvcc's output, the -Xptxas -v report included


_loaded: dict = {}


def nvcc() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([str(Path(home) / "bin" / "nvcc")] if home else []) + [
            shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]:
        if cand and Path(cand).exists():
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH "
                       "(CUDA kernels are built at their first launch)")


def digest(src: Path) -> str:
    """The build hash of ``src``: its bytes, the name and bytes of every
    header ``*.cuh`` beside it (a source may include any of them) and
    the nvcc flags."""
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(src.parent.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def load(source: str) -> Library:
    """Build ``csrc/<source>`` if no build of its current content exists,
    then load it (once per process)."""
    if source in _loaded:
        return _loaded[source]
    src = CSRC / source
    out = BUILD_DIR / f"{src.stem}-{digest(src)}.so"
    log = out.with_suffix(".log")
    build_s = 0.0
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        t0 = time.perf_counter()
        proc = subprocess.run([nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                              capture_output=True, text=True)
        build_s = time.perf_counter() - t0
        report = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src} "
                               f"(exit {proc.returncode}):\n{report}")
        log.write_text(report)
        os.replace(tmp, out)         # atomic: concurrent builds never
                                     # load a half-written library
    report = log.read_text() if log.exists() else ""
    lib = Library(ctypes.CDLL(str(out)), out, build_s, report)
    _loaded[source] = lib
    return lib

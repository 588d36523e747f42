"""The port's CUDA build cache (``repro_torch/kernels/build.py``): the
build hash of a source covers the shared headers ``csrc/*.cuh`` it may
include, so an edited header rebuilds every library instead of loading
a stale one.  Needs no ``nvcc``: it hashes copies of the sources."""
import shutil

from repro_torch.kernels import build


def test_digest_covers_sources_and_shared_headers(tmp_path):
    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC, csrc)
    headers = sorted(csrc.glob("*.cuh"))
    assert [h.name for h in headers] == ["tf32x3.cuh"]
    sources = sorted(csrc.glob("*.cu"))
    before = {src.name: build.digest(src) for src in sources}
    assert before == {src.name: build.digest(build.CSRC / src.name)
                      for src in sources}
    assert len(set(before.values())) == len(sources)

    header = headers[0]
    header.write_text(header.read_text() + "\n// edited\n")
    edited = {src.name: build.digest(src) for src in sources}
    assert all(edited[name] != before[name] for name in before)

    (csrc / "extra.cuh").write_text("#pragma once\n")   # a new header
    added = {src.name: build.digest(src) for src in sources}
    assert all(added[name] != edited[name] for name in before)

    src = csrc / "ssd_scan.cu"
    src.write_text(src.read_text() + "\n")
    assert build.digest(src) != added["ssd_scan.cu"]
    assert build.digest(csrc / "flash_attention.cu") == \
        added["flash_attention.cu"]

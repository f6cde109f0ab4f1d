"""tpubwa_torch/device/_build.py without a CUDA toolkit: a stand-in nvcc
shows the hash-keyed cache and the assembler report kept beside each
library, which a cached load returns."""
import os
import stat
import sys
import threading

import pytest

from tpubwa_torch.device import _build

FAKE_NVCC = """#!{python}
import sys, time
out = sys.argv[sys.argv.index("-o") + 1]
src = sys.argv[-1]
time.sleep(0.2)
open(out, "wb").write(b"not a library")
sys.stderr.write("ptxas info    : Used 40 registers for " + src + "\\n"
                 "0 bytes spill stores, 0 bytes spill loads\\n")
"""


@pytest.fixture
def fake_toolchain(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for name in ("k1", "k2"):
        (csrc / f"{name}.cu").write_text(f"// {name}\n")
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(FAKE_NVCC.format(python=sys.executable))
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IXUSR)
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD", tmp_path / "build")
    monkeypatch.setattr(_build, "_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(_build, "build_info", {})
    return tmp_path


def test_cached_load_returns_the_ptxas_report(fake_toolchain):
    so = _build._compile("k1")
    first = dict(_build.build_info["k1"])
    assert first["seconds"] > 0 and "Used 40 registers" in first["ptxas"]
    report = so.with_suffix(".ptxas.txt")
    assert report.read_text() == first["ptxas"]
    assert sorted(p.name for p in so.parent.iterdir()) == sorted(
        [so.name, report.name])           # no temporary files left
    assert _build._compile("k1") == so
    cached = _build.build_info["k1"]
    assert cached["seconds"] == 0.0 and cached["ptxas"] == first["ptxas"]


def test_kernels_build_concurrently(fake_toolchain, monkeypatch):
    """Two kernels' builds overlap: each holds only its own lock."""
    inside, peak = [0], [0]
    guard = threading.Lock()
    compile_one = _build._compile

    def counted(name):
        with guard:
            inside[0] += 1
            peak[0] = max(peak[0], inside[0])
        try:
            return compile_one(name)
        finally:
            with guard:
                inside[0] -= 1
    monkeypatch.setattr(_build, "_compile", counted)
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build, "_locks", {})
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: os.path.basename(
        path))
    threads = [threading.Thread(target=_build.load, args=(n, {}))
               for n in ("k1", "k2")]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    assert peak[0] == 2
    assert set(_build.build_info) == {"k1", "k2"}


def test_an_included_header_keys_the_library(fake_toolchain):
    """A library is keyed by the headers of csrc/ its source includes,
    directly or through another header: an edit to one builds anew."""
    csrc = fake_toolchain / "csrc"
    (csrc / "k1.cu").write_text('#include "a.cuh"\n#include <cstdint>\n')
    (csrc / "a.cuh").write_text('#pragma once\n  #  include "b.h"\n')
    (csrc / "b.h").write_text("// b\n")
    assert [p.name for p in _build._sources(csrc / "k1.cu")] == [
        "k1.cu", "a.cuh", "b.h"]
    first = _build._compile("k1")
    assert _build._compile("k1") == first
    for header in ("b.h", "a.cuh"):
        path = csrc / header
        path.write_text(path.read_text() + "// edited\n")
        again = _build._compile("k1")
        assert again != first and again.exists()
        first = again
    # a file the source does not include changes nothing
    (csrc / "k2.cu").write_text("// other\n")
    assert _build._compile("k1") == first

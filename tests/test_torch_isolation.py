"""tpubwa_torch stands alone: it imports nothing of the JAX package,
builds its own native libraries under names of its own, and runs on
cuda unless the caller asks for the CPU."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import tpubwa.native
from tpubwa_torch import native
from tpubwa_torch.cli import main_index, main_mem
from tpubwa_torch.device import pipeline as tp
from tpubwa_torch.device.occ import DeviceIndex
from tpubwa_torch.index import FMIndex
from tpubwa_torch.opts import MemOpt

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLD = os.path.join(ROOT, "tests", "golden")

# every module of the port and chip_smoke; an index built through the
# port (its native SA-IS), `mem --device cpu` on tests/golden; then no
# module of tpubwa and no jax may have been loaded
_ISOLATION = f"""
import importlib, io, pkgutil, sys
sys.path.insert(0, {ROOT!r})
import tpubwa_torch
names = [m.name for m in pkgutil.walk_packages(tpubwa_torch.__path__,
                                               "tpubwa_torch.")
         if not m.name.endswith("__main__")]
for name in names:
    importlib.import_module(name)
import chip_smoke
from tpubwa_torch import native
from tpubwa_torch.cli import main_index, main_mem
assert main_index([{os.path.join(GOLD, "ref.fa")!r}, "-p", "g"]) == 0
assert native._sais_lib is not None, "the native SA-IS did not run"
out = io.StringIO()
assert main_mem(["--device", "cpu", "g", {os.path.join(GOLD, "se.fq")!r}],
                out=out) == 0
assert out.getvalue().count("\\n") > 300
bad = sorted(k for k in sys.modules if k in ("tpubwa", "jax")
             or k.startswith(("tpubwa.", "jax.")))
assert not bad, bad
assert len(names) > 30, names
print("isolated", len(names))
"""


def test_port_imports_nothing_of_tpubwa(tmp_path):
    res = subprocess.run([sys.executable, "-c", _ISOLATION], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "isolated" in res.stdout


def test_native_libraries_are_the_ports_own():
    """One process that loads both packages gets two libraries, not one
    dlopen handle (and one set of C globals) for the two."""
    ours = native.load_bwacore()
    theirs = tpubwa.native.load_bwacore()
    assert ours._name != theirs._name and ours._handle != theirs._handle
    assert os.path.basename(ours._name).startswith("torch-bwacore-")
    assert os.path.dirname(ours._name) == str(native._CACHE)


@pytest.fixture(scope="module")
def golden_index(tmp_path_factory):
    prefix = str(tmp_path_factory.mktemp("iso") / "g")
    assert main_index([os.path.join(GOLD, "ref.fa"), "-p", prefix]) == 0
    return prefix


def test_default_device_raises_without_a_card(golden_index, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    fmi = FMIndex.load(golden_index)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tp.make_device_aligner(MemOpt(), fmi)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tp.DeviceAligner(MemOpt(), fmi)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main_mem([golden_index, os.path.join(GOLD, "se.fq")])


def test_device_index_from_numpy_defaults_to_cuda():
    arrays = {"pac_words": np.zeros(4, np.uint32), "l_pac": 8,
              "seq_len": 17}
    assert DeviceIndex.from_numpy(arrays, device="cpu").device.type == "cpu"
    if not torch.cuda.is_available():
        # this torch build has no CUDA: the default device cannot be had
        with pytest.raises((AssertionError, RuntimeError)):
            DeviceIndex.from_numpy(arrays)
    else:
        assert DeviceIndex.from_numpy(arrays).device.type == "cuda"


def test_cli_device_choices_have_no_auto(golden_index, capsys):
    with pytest.raises(SystemExit):
        main_mem(["--device", "auto", golden_index,
                  os.path.join(GOLD, "se.fq")])
    assert "invalid choice: 'auto'" in capsys.readouterr().err

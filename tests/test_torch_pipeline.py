"""The tpubwa_torch slice end to end on the CPU: regions equal to
tpubwa's DeviceAligner, `mem` SAM byte-equal to the golden snapshots
(tpubwa's own output), no JAX import, and no hidden CPU fallback."""
import io
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import tpubwa.device  # noqa: F401  (x64, as the JAX package runs)
from tpubwa.cli import main_index
from tpubwa.device.pipeline import make_device_aligner as jax_aligner
from tpubwa.index import FMIndex
from tpubwa.io.fastq import Read
from tpubwa.opts import MEM_F_PE, MemOpt
from tpubwa_torch.cli import main_mem
from tpubwa_torch.device import pipeline as tp
from tpubwa_torch.device.smem import collect_intv_device
from simread import simulate_pairs, simulate_reads

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLD = os.path.join(ROOT, "tests", "golden")


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    rng = np.random.default_rng(41)
    d = tmp_path_factory.mktemp("tpipe")
    unit = rng.integers(0, 4, 40).astype(np.uint8)
    codes = np.concatenate([
        rng.integers(0, 4, 9000).astype(np.uint8), np.tile(unit, 3),
        rng.integers(0, 4, 5000).astype(np.uint8)])
    bases = "".join("ACGT"[c] for c in codes)
    fa = d / "ref.fa"
    fa.write_text(">d1\n" + "\n".join(
        bases[i:i + 70] for i in range(0, len(bases), 70)) + "\n")
    assert main_index([str(fa)]) == 0
    return codes, FMIndex.load(str(fa))


def _reads(recs):
    code = {"A": 0, "C": 1, "G": 2, "T": 3}
    return [Read(name=n, seq=np.array([code[c] for c in s], np.uint8),
                 qual=None) for n, s in recs]


def _flat(regs):
    return (regs.cnt.tolist(), regs.iv.tolist(), regs.fr.tolist())


@pytest.mark.parametrize("paired,chunk_reads", [
    (False, None), (True, None), (True, 16)])
def test_regions_equal_jax_aligner(setup, paired, chunk_reads):
    """chunk_reads=16 splits the batch into chunks: the seeding of chunk
    i+1 overlaps the planning of chunk i."""
    codes, fmi = setup
    rng = np.random.default_rng(8 + paired)
    if paired:
        pairs = simulate_pairs(codes, 24, 100, rng, snp_rate=0.02)
        recs = [x for n, s1, s2, *_ in pairs for x in ((n, s1), (n, s2))]
    else:
        recs = [(n, s) for n, s, *_ in simulate_reads(
            codes, 40, 100, rng, snp_rate=0.02, indel_rate=0.004)]
    reads = _reads(recs)
    # stress reads: garbage, N codes
    reads.append(Read("garb", rng.integers(0, 4, 100).astype(np.uint8),
                      None))
    nread = reads[0].seq.copy()
    nread[40:44] = 4
    reads.append(Read("withn", nread, None))
    opt = MemOpt(flag=MEM_F_PE) if paired else MemOpt()
    port = tp.make_device_aligner(opt, fmi, device="cpu")
    if chunk_reads:
        port.chunk_reads = chunk_reads
    got = port(reads)
    want = jax_aligner(opt, fmi, platform="cpu")(reads)
    assert _flat(got) == _flat(want)
    assert port.extender.n_waves > 0 and port.extender.n_jobs > 0


def test_oversize_reads_take_the_scalar_path(setup):
    codes, fmi = setup
    opt = MemOpt()
    long_read = Read("long", codes[100:700].copy(), None)
    short = Read("short", codes[2000:2100].copy(), None)
    port = tp.make_device_aligner(opt, fmi, device="cpu")
    got = port([short, long_read])
    want = jax_aligner(opt, fmi, platform="cpu")([short, long_read])
    key = [[(r.rb, r.re, r.qb, r.qe, r.score, r.sub) for r in regs]
           for regs in (list(got[0]), list(got[1]))]
    assert key == [[(r.rb, r.re, r.qb, r.qe, r.score, r.sub)
                    for r in regs] for regs in (list(want[0]),
                                                list(want[1]))]
    assert got[1] and got[1][0].qe - got[1][0].qb > 500


@pytest.fixture(scope="module")
def golden_index(tmp_path_factory):
    prefix = str(tmp_path_factory.mktemp("tgold") / "g")
    assert main_index([os.path.join(GOLD, "ref.fa"), "-p", prefix]) == 0
    return prefix


@pytest.mark.parametrize("name,fqs", [
    ("se.sam", ["se.fq"]), ("pe.sam", ["pe1.fq", "pe2.fq"])])
def test_cli_mem_cpu_equals_golden(golden_index, name, fqs):
    out = io.StringIO()
    assert main_mem(["--device", "cpu", golden_index]
                    + [os.path.join(GOLD, f) for f in fqs], out=out) == 0
    got = "".join(l + "\n" for l in out.getvalue().splitlines()
                  if not l.startswith("@PG"))
    with open(os.path.join(GOLD, name)) as fh:
        assert got == fh.read()


def test_no_jax_import():
    code = ("import sys, tpubwa_torch, tpubwa_torch.cli, "
            "tpubwa_torch.device.pipeline; "
            "assert 'jax' not in sys.modules, 'jax imported'; "
            "assert 'tpubwa.device' not in sys.modules")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                   timeout=120)


def test_cuda_without_a_card_raises(setup, monkeypatch):
    _, fmi = setup
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        tp.make_device_aligner(MemOpt(), fmi, device="cuda")
    assert tp.resolve_device("auto") == torch.device("cpu")


def test_missing_paths_raise_not_implemented(setup, monkeypatch):
    codes, fmi = setup
    reads = _reads([("r", "".join("ACGT"[c] for c in codes[300:400]))])
    aligner = tp.make_device_aligner(MemOpt(), fmi, device="cpu")
    arr, lens = aligner._pack(reads, 32)
    with pytest.raises(NotImplementedError, match="item 5"):
        collect_intv_device(MemOpt(), aligner.didx, arr, lens, fmi,
                            mode="megaq")
    monkeypatch.setenv("TPUBWA_NO_NATIVE_PLAN", "1")
    with pytest.raises(NotImplementedError, match="item 6"):
        aligner(reads)
    with pytest.raises(NotImplementedError, match="item 7"):
        main_mem(["--dist", "-o", "x.sam", "p", "r.fq"])

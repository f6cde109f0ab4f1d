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
from tpubwa.cli import main_mem as tpubwa_main_mem
from tpubwa.device.pipeline import make_device_aligner as jax_aligner
from tpubwa.index import FMIndex
from tpubwa.io.fastq import Read
from tpubwa.opts import MEM_F_PE, MemOpt
from tpubwa_torch.cli import main_mem
from tpubwa_torch.device import pipeline as tp
from tpubwa_torch.device.smem import collect_intv_device
from simread import simulate_pairs, simulate_reads, write_fastq

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


@pytest.fixture(scope="module")
def alt_index(tmp_path_factory):
    """Two contigs, the second a diverged copy of part of the first and
    declared ALT in a .alt file (as tests/test_flags.py builds one), with
    SE and PE reads drawn from both."""
    rng = np.random.default_rng(5)
    d = tmp_path_factory.mktemp("talt")
    primary = rng.integers(0, 4, 9000).astype(np.uint8)
    alt = primary[2000:6000].copy()
    snp = rng.random(len(alt)) < 0.01
    alt[snp] = (alt[snp] + 1) % 4
    fa = d / "ref.fa"
    fa.write_text("".join(
        f">{name}\n" + "".join("ACGT"[c] for c in seq) + "\n"
        for name, seq in (("chrM main", primary), ("chrA alt", alt))))
    assert main_index([str(fa)]) == 0
    (d / "ref.fa.alt").write_text("chrA\t0\t*\n")
    codes = np.concatenate([primary, alt])
    write_fastq(str(d / "se.fq"), simulate_reads(codes, 60, 100, rng))
    pairs = simulate_pairs(codes, 40, 100, rng, insert_mean=300)
    write_fastq(str(d / "pe1.fq"), [(n, s1) for n, s1, *_ in pairs])
    write_fastq(str(d / "pe2.fq"), [(n, s2) for n, _, s2, *_ in pairs])
    return str(fa), d


def _sam(main, argv):
    out = io.StringIO()
    assert main(argv, out=out) == 0
    return [l for l in out.getvalue().splitlines()
            if not l.startswith("@PG")]


@pytest.mark.parametrize("index,paired,port_opts", [
    ("alt", False, []), ("alt", True, []),
    ("golden", False, ["-t", "4"]), ("golden", True, ["-t", "4"])])
def test_cli_mem_cpu_equals_tpubwa_scalar(alt_index, golden_index, index,
                                          paired, port_opts):
    """The port's `mem --device cpu` against tpubwa's scalar pipeline
    (`-t 1`): on an index with ALT contigs, and with 4 host threads."""
    if index == "alt":
        prefix, d = alt_index
        fqs = ["pe1.fq", "pe2.fq"] if paired else ["se.fq"]
        fqs = [str(d / f) for f in fqs]
    else:
        prefix = golden_index
        fqs = [os.path.join(GOLD, f) for f in (
            ["pe1.fq", "pe2.fq"] if paired else ["se.fq"])]
    want = _sam(tpubwa_main_mem, ["--device", "scalar", prefix] + fqs)
    got = _sam(main_mem, ["--device", "cpu"] + port_opts + [prefix] + fqs)
    assert len(got) > len(fqs) * 40
    assert got == want
    if index == "alt":
        assert any(l.startswith("@SQ") and l.endswith("AH:*")
                   for l in got)


def test_no_jax_import():
    code = ("import sys, tpubwa_torch, tpubwa_torch.cli, "
            "tpubwa_torch.device.pipeline, "
            "tpubwa_torch.scripts.exp_int16_kernel; "
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

"""The tpubwa_torch slice end to end on the CPU: regions equal to
tpubwa's DeviceAligner, `mem` SAM byte-equal to the golden snapshots
(tpubwa's own output), no JAX import, and no hidden CPU fallback.

The port carries its own index, reads and options: each test builds the
port's objects and tpubwa's from the same input, and checks that the
inputs are equal before it compares the outputs."""
import io
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import tpubwa.device  # noqa: F401  (x64, as the JAX package runs)
import tpubwa.index
import tpubwa.io.fastq
import tpubwa.opts
from tpubwa.cli import main_mem as tpubwa_main_mem
from tpubwa.device.pipeline import make_device_aligner as jax_aligner
from tpubwa_torch.cli import main_index, main_mem
from tpubwa_torch.device import pipeline as tp
from tpubwa_torch.index import FMIndex
from tpubwa_torch.io.fastq import Read
from tpubwa_torch.opts import MEM_F_PE, MemOpt
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
    fmi, jfmi = FMIndex.load(str(fa)), tpubwa.index.FMIndex.load(str(fa))
    assert_same_index(fmi, jfmi)
    return codes, fmi, jfmi


def assert_same_index(fmi, jfmi):
    """The port's FMIndex and tpubwa's, loaded from one prefix, hold the
    same arrays and contigs."""
    assert (fmi.seq_len, fmi.primary) == (jfmi.seq_len, jfmi.primary)
    for name in ("L2", "bwt_words", "occ_ckpt", "sa_sample"):
        assert np.array_equal(getattr(fmi, name), getattr(jfmi, name))
    assert np.array_equal(fmi.bnt.codes, jfmi.bnt.codes)
    assert ([(a.name, a.offset, a.length) for a in fmi.bnt.anns]
            == [(a.name, a.offset, a.length) for a in jfmi.bnt.anns])


def _opts(**kw):
    """MemOpt of the port and of tpubwa, from the same keywords."""
    opt, jopt = MemOpt(**kw), tpubwa.opts.MemOpt(**kw)
    assert vars(opt) == vars(jopt)
    return opt, jopt


def _reads(recs):
    """The port's reads and tpubwa's, from the same records."""
    code = {"A": 0, "C": 1, "G": 2, "T": 3, "N": 4}
    seqs = [(n, np.array([code[c] for c in s], np.uint8)) for n, s in recs]
    return ([Read(name=n, seq=x, qual=None) for n, x in seqs],
            [tpubwa.io.fastq.Read(name=n, seq=x, qual=None)
             for n, x in seqs])


def _flat(regs):
    return (regs.cnt.tolist(), regs.iv.tolist(), regs.fr.tolist())


@pytest.fixture(scope="module")
def stock_setup(setup, tmp_path_factory):
    """setup's index written as stock bwa files (save_bwa into a fresh
    prefix, no .tpubwa.npz) and loaded by both packages: no
    text-position marks, so the SA walk is the rank-sampled one."""
    codes, fmi, _ = setup
    prefix = str(tmp_path_factory.mktemp("tstock") / "ref")
    fmi.save_bwa(prefix)
    sfmi, sjfmi = (FMIndex.load_bwa(prefix),
                   tpubwa.index.FMIndex.load_bwa(prefix))
    assert_same_index(sfmi, sjfmi)
    assert not sfmi.sa_mark_D and not sjfmi.sa_mark_D
    return codes, sfmi, sjfmi


@pytest.mark.parametrize("index,paired,chunk_reads", [
    pytest.param("npz", False, None, id="False-None"),
    pytest.param("npz", True, None, id="True-None"),
    pytest.param("npz", True, 16, id="True-16"),
    pytest.param("bwa", False, None, id="bwa-False-None"),
    pytest.param("bwa", True, 16, id="bwa-True-16")])
def test_regions_equal_jax_aligner(setup, stock_setup, index, paired,
                                   chunk_reads):
    """chunk_reads=16 splits the batch into chunks: the seeding of chunk
    i+1 overlaps the planning of chunk i.  On the stock-bwa index the SA
    positions come from occ.sa_lookup, tpubwa's from its device walk."""
    codes, fmi, jfmi = setup if index == "npz" else stock_setup
    rng = np.random.default_rng(8 + paired)
    if paired:
        pairs = simulate_pairs(codes, 24, 100, rng, snp_rate=0.02)
        recs = [x for n, s1, s2, *_ in pairs for x in ((n, s1), (n, s2))]
    else:
        recs = [(n, s) for n, s, *_ in simulate_reads(
            codes, 40, 100, rng, snp_rate=0.02, indel_rate=0.004)]
    # stress reads: garbage, N codes
    garb = "".join("ACGT"[c] for c in rng.integers(0, 4, 100))
    recs += [("garb", garb), ("withn", recs[0][1][:40] + "NNNN"
                               + recs[0][1][44:])]
    reads, jreads = _reads(recs)
    assert reads[-1].seq[40:44].tolist() == [4] * 4
    opt, jopt = _opts(flag=MEM_F_PE) if paired else _opts()
    port = tp.make_device_aligner(opt, fmi, device="cpu")
    if chunk_reads:
        port.chunk_reads = chunk_reads
    got = port(reads)
    want = jax_aligner(jopt, jfmi, platform="cpu")(jreads)
    assert _flat(got) == _flat(want)
    assert port.extender.n_waves > 0 and port.extender.n_jobs > 0
    # the FM arrays were read only where the native walk had no marks
    assert (port.didx._fm is None) == (index == "npz")


def test_oversize_reads_take_the_scalar_path(setup):
    codes, fmi, jfmi = setup
    opt, jopt = _opts()
    recs = [("short", codes[2000:2100]), ("long", codes[100:700])]
    reads = [Read(n, c.copy(), None) for n, c in recs]
    jreads = [tpubwa.io.fastq.Read(n, c.copy(), None) for n, c in recs]
    port = tp.make_device_aligner(opt, fmi, device="cpu")
    got = port(reads)
    want = jax_aligner(jopt, jfmi, platform="cpu")(jreads)
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


@pytest.fixture(scope="module")
def golden_bwa_index(golden_index, tmp_path_factory):
    """The golden index as stock bwa files in a fresh prefix (save_bwa,
    no .tpubwa.npz): `mem` loads it through FMIndex.load_bwa."""
    prefix = str(tmp_path_factory.mktemp("tgoldbwa") / "g")
    FMIndex.load(golden_index).save_bwa(prefix)
    assert not os.path.exists(prefix + ".tpubwa.npz")
    return prefix


@pytest.mark.parametrize("index,paired,port_opts", [
    ("alt", False, []), ("alt", True, []),
    ("golden", False, ["-t", "4"]), ("golden", True, ["-t", "4"]),
    ("golden-bwa", False, []), ("golden-bwa", True, [])])
def test_cli_mem_cpu_equals_tpubwa_scalar(alt_index, golden_index,
                                          golden_bwa_index, index, paired,
                                          port_opts):
    """The port's `mem --device cpu` against tpubwa's scalar pipeline
    (`-t 1`): on an index with ALT contigs, with 4 host threads, and on
    a stock-bwa index (the SA walk of occ.sa_lookup), where it must also
    equal the port's run on the npz index."""
    if index == "alt":
        prefix, d = alt_index
        fqs = ["pe1.fq", "pe2.fq"] if paired else ["se.fq"]
        fqs = [str(d / f) for f in fqs]
    else:
        prefix = golden_bwa_index if index == "golden-bwa" else golden_index
        fqs = [os.path.join(GOLD, f) for f in (
            ["pe1.fq", "pe2.fq"] if paired else ["se.fq"])]
    want = _sam(tpubwa_main_mem, ["--device", "scalar", prefix] + fqs)
    got = _sam(main_mem, ["--device", "cpu"] + port_opts + [prefix] + fqs)
    assert len(got) > len(fqs) * 40
    assert got == want
    if index == "alt":
        assert any(l.startswith("@SQ") and l.endswith("AH:*")
                   for l in got)
    if index == "golden-bwa":
        assert got == _sam(main_mem, ["--device", "cpu", golden_index]
                           + fqs)


@pytest.mark.parametrize("index", ["alt", "golden-bwa"])
@pytest.mark.parametrize("paired", [False, True])
def test_cli_mem_cpu_megaq_equals_host_and_tpubwa(alt_index,
                                                 golden_bwa_index,
                                                 monkeypatch, paired, index):
    """`mem --device cpu` with TPUBWA_SEED_MODE=megaq (K2's and K3's plain
    versions seed every read; the native seeder is never called): SAM
    byte-equal to host mode's and to tpubwa's scalar pipeline, on an
    index with ALT contigs and on a stock-bwa index, where the SA walk
    is occ.sa_lookup's too (K2, K3 and K-sa in one run on the card)."""
    from tpubwa_torch.device import occ as tocc
    from tpubwa_torch.device import smem as tsmem
    if index == "alt":
        prefix, d = alt_index
        fqs = [str(d / f) for f in (["pe1.fq", "pe2.fq"] if paired
                                    else ["se.fq"])]
    else:
        prefix = golden_bwa_index
        fqs = [os.path.join(GOLD, f) for f in (
            ["pe1.fq", "pe2.fq"] if paired else ["se.fq"])]
    host = _sam(main_mem, ["--device", "cpu", prefix] + fqs)
    want = _sam(tpubwa_main_mem, ["--device", "scalar", prefix] + fqs)

    def no_host_seeding(*a, **k):
        raise AssertionError("a megaq chunk was seeded on the host")

    walked = []

    def counted(*a, **k):
        walked.append(1)
        return walk(*a, **k)

    walk = tocc.sa_lookup_plain
    monkeypatch.setattr(tsmem, "smem_collect_batch_native", no_host_seeding)
    monkeypatch.setattr(tocc, "sa_lookup_plain", counted)
    monkeypatch.setenv("TPUBWA_SEED_MODE", "megaq")
    got = _sam(main_mem, ["--device", "cpu", prefix] + fqs)
    assert len(got) > len(fqs) * 40
    assert got == host == want
    # the stock index has no text-position marks: its SA walk is K-sa's
    assert bool(walked) == (index == "golden-bwa")


def test_no_jax_import():
    code = ("import sys, tpubwa_torch, tpubwa_torch.cli, "
            "tpubwa_torch.device.pipeline, "
            "tpubwa_torch.scripts.exp_int16_kernel, "
            "tpubwa_torch.scripts.exp_kernel_real; "
            "assert 'jax' not in sys.modules, 'jax imported'; "
            "assert 'tpubwa' not in sys.modules, 'tpubwa imported'")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                   timeout=120)


def test_cuda_without_a_card_raises(setup, monkeypatch):
    """cuda is the default, and no value resolves to the CPU unless the
    caller names it: there is no 'auto'."""
    _, fmi, _ = setup
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        tp.make_device_aligner(MemOpt(), fmi, device="cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        tp.make_device_aligner(MemOpt(), fmi)
    with pytest.raises(RuntimeError, match="cuda"):
        tp.resolve_device()
    with pytest.raises(RuntimeError):
        tp.resolve_device("auto")
    assert tp.resolve_device("cpu") == torch.device("cpu")


def test_missing_paths_raise_not_implemented(setup, monkeypatch):
    codes, fmi, _ = setup
    reads, _ = _reads([("r", "".join("ACGT"[c] for c in codes[300:400]))])
    aligner = tp.make_device_aligner(MemOpt(), fmi, device="cpu")
    monkeypatch.setenv("TPUBWA_NO_NATIVE_PLAN", "1")
    with pytest.raises(NotImplementedError, match=r"\[waves\]"):
        aligner(reads)
    with pytest.raises(NotImplementedError, match=r"\[dist\]"):
        main_mem(["--dist", "-o", "x.sam", "p", "r.fq"])

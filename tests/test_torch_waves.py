"""tpubwa_torch's Python planner and its extension waves
(device/dispatch.py:WaveExtender, extend_fused.extend_seed_batch_np),
and `mem` with no native planner (TPUBWA_NO_NATIVE_PLAN) and with no
native host stage at all (TPUBWA_NO_NATIVE: seeding in megaq, the SA
walk through occ.sa_lookup, chaining, planning and emit in Python).

Each is held to tpubwa (its Pallas kernel in interpret mode, its
WaveExtender, its CLI) and to the port's native run, at
tests/test_mode_matrix.py's size: 70 SE reads and 50 pairs on a 23 kb
genome.  Tolerance 0."""
import contextlib
import io
import os

import numpy as np
import pytest
import torch

import tpubwa.device  # noqa: F401  (x64, as the JAX package runs)
import tpubwa.index
from tpubwa.cli import main_mem as tpubwa_main_mem
from tpubwa.device import extend_fused as jf
from tpubwa.device.pipeline import make_device_aligner as jax_aligner
from tpubwa_torch.cli import main_index, main_mem
from tpubwa_torch.device import extend_fused as tf
from tpubwa_torch.device import smem
from tpubwa_torch.device import pipeline as tp
from tpubwa_torch.device.dispatch import WaveExtender
from tpubwa_torch.device.extend_kernel import extend_batch_plain
from tpubwa_torch.host.native_emit import FlatRegs
from tpubwa_torch.index import FMIndex
from tpubwa_torch.opts import MemOpt
from test_extend_fused import _rand_job
from test_torch_pipeline import _flat, _opts, _reads, assert_same_index
from simread import simulate_pairs, simulate_reads, write_fastq

SWITCHES = ("TPUBWA_NO_NATIVE_PLAN", "TPUBWA_NO_NATIVE")


@contextlib.contextmanager
def native_off(name):
    """``name`` set to 1 and the port's native caches reset, so that the
    switch takes effect mid-process; both undone on the way out.  Only
    the port runs inside: tpubwa's bridges would cache the switch."""
    old = os.environ.get(name)
    os.environ[name] = "1"
    tp.reset_native_caches()
    try:
        yield
    finally:
        if old is None:
            del os.environ[name]
        else:
            os.environ[name] = old
        tp.reset_native_caches()


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """tests/test_mode_matrix.py's corpus: a 23 kb genome with a 35-base
    unit four times, 70 SE reads, 50 pairs."""
    rng = np.random.default_rng(0x31337)
    d = tmp_path_factory.mktemp("twaves")
    unit = rng.integers(0, 4, 35).astype(np.uint8)
    codes = np.concatenate([
        rng.integers(0, 4, 14000).astype(np.uint8), np.tile(unit, 4),
        rng.integers(0, 4, 9000).astype(np.uint8)])
    bases = "".join("ACGT"[c] for c in codes)
    fa = d / "ref.fa"
    fa.write_text(">mx1\n" + "\n".join(
        bases[i:i + 70] for i in range(0, len(bases), 70)) + "\n")
    assert main_index([str(fa)]) == 0
    se = simulate_reads(codes, 70, 100, rng, snp_rate=0.01,
                        indel_rate=0.004)
    pe = simulate_pairs(codes, 50, 100, rng, snp_rate=0.01)
    fq_se = str(d / "se.fq")
    write_fastq(fq_se, se)
    fq1, fq2 = str(d / "p1.fq"), str(d / "p2.fq")
    write_fastq(fq1, [(n, s1, p, q) for n, s1, s2, p, q in pe])
    write_fastq(fq2, [(n, s2, p, q) for n, s1, s2, p, q in pe])
    fmi, jfmi = FMIndex.load(str(fa)), tpubwa.index.FMIndex.load(str(fa))
    assert_same_index(fmi, jfmi)
    recs = [(n, s) for n, s, *_ in se]
    return str(fa), fmi, jfmi, recs, fq_se, fq1, fq2


def _mem(fn, prefix, fqs, extra=()):
    out = io.StringIO()
    assert fn(["--device", "cpu", *extra, prefix, *fqs], out=out) == 0
    return [l for l in out.getvalue().splitlines()
            if not l.startswith("@PG")]


# ------------------------------------------------ extend_seed_batch_np
@pytest.mark.parametrize("seed", [0, 1])
def test_seed_batch_equals_jax_and_scalar(seed):
    """Sequence-tile jobs: the port's rows == tpubwa's (its Pallas
    kernel in interpret mode) on every column, and == scalar_fused on
    the columns the planner reads; the routed extension == the plain
    one on the CPU."""
    opt = MemOpt()
    mat = opt.scoring_matrix()
    rng = np.random.default_rng(seed)
    jobs = [_rand_job(rng) for _ in range(40)]
    pen = (mat, opt.o_del, opt.e_del, opt.o_ins, opt.e_ins, opt.zdrop)
    want = jf.extend_seed_batch_np(jobs, *pen, 256, 512, interpret=True)
    got = tf.extend_seed_batch_np(jobs, *pen, 512, torch.device("cpu"))
    assert got.dtype == np.int32 and got.shape == (40, 16)
    assert got.tolist() == want.tolist()
    plain = tf.extend_seed_batch_np(jobs, *pen, 512, "cpu",
                                    extend=extend_batch_plain)
    assert plain.tolist() == got.tolist()
    for i, j in enumerate(jobs):
        ref = tf.scalar_fused(j, *pen)
        if j[0] > 0:
            assert got[i, :6].tolist() == ref[:6].tolist(), i
            assert got[i, 12] == ref[12], i
        if j[4] > 0:
            assert got[i, 6:12].tolist() == ref[6:12].tolist(), i
            assert got[i, 13] == ref[13], i
        assert got[i, 14:].tolist() == ref[14:].tolist(), i


def test_seed_batch_refusals():
    """What the kernel does not take raises; a matrix that is not
    bwa_fill_scmat-structured runs on K1-mat and equals tpubwa's route
    for it, the scalar trial loops, on the columns the planner reads."""
    opt = MemOpt()
    mat = opt.scoring_matrix()
    pen = (opt.o_del, opt.e_del, opt.o_ins, opt.e_ins, opt.zdrop)
    job = _rand_job(np.random.default_rng(3))
    bad = mat.copy()
    bad[0, 1] = -7          # not bwa_fill_scmat-structured
    got = tf.extend_seed_batch_np([job], bad, *pen, 512, "cpu")[0]
    ref = tf.scalar_fused(job, bad, *pen)
    if job[0] > 0:
        assert got[:6].tolist() == ref[:6].tolist()
    if job[4] > 0:
        assert got[6:12].tolist() == ref[6:12].tolist()
    assert got[12:].tolist() == ref[12:].tolist()
    # a side longer than the kernel's lanes is the caller's to route
    q = np.zeros(600, np.uint8)
    long_job = (600, q, 10, q[:10], 0, q[:0], 0, q[:0], 100, 30, 5, 5)
    with pytest.raises(ValueError, match="lanes"):
        tf.extend_seed_batch_np([long_job], mat, *pen, 1024, "cpu")
    assert tf.extend_seed_batch_np([], mat, *pen, 512, "cpu").shape == \
        (0, 16)


# ---------------------------------------------------- WaveExtender
@pytest.mark.parametrize("qmax", [511, 60], ids=["kernel", "oversize"])
def test_wave_extender_equals_jax(corpus, monkeypatch, qmax):
    """One chunk through the Python planner's descriptor waves: the
    regions, and n_waves, n_jobs and n_fallback, equal tpubwa's
    WaveExtender's.  At qmax 60 the seeds with a side past 60 bases
    take the scalar loops (rebuilt from their descriptors), never the
    kernel."""
    _, fmi, jfmi, recs, *_ = corpus
    reads, jreads = _reads(recs)
    opt, jopt = _opts()
    monkeypatch.setenv("TPUBWA_NO_NATIVE_PLAN", "1")
    port = tp.make_device_aligner(opt, fmi, device="cpu")
    jax = jax_aligner(jopt, jfmi, platform="cpu")
    assert isinstance(port.extender, WaveExtender)
    port.extender.qmax = jax.extender.qmax = qmax
    seen = []
    real = tf.extend_seed_desc_np

    def spy(didx, qd, jobs, *a, **k):
        seen.append(max(max(j[2], j[4] - j[2] - j[3]) for j in jobs))
        return real(didx, qd, jobs, *a, **k)

    monkeypatch.setattr("tpubwa_torch.device.dispatch.extend_seed_desc_np",
                        spy)
    got = port(reads)
    want = jax(jreads)
    assert isinstance(got, list)
    assert _flat(FlatRegs.from_lists(got)) == \
        _flat(FlatRegs.from_lists(want))
    e, je = port.extender, jax.extender
    assert (e.n_waves, e.n_jobs, e.n_fallback) == \
        (je.n_waves, je.n_jobs, je.n_fallback)
    assert e.n_waves == len(seen) > 0 and max(seen) <= qmax
    assert (e.n_fallback > 0) == (qmax == 60)


# ------------------------------------------------------ DeviceAligner
@pytest.mark.parametrize("switch", SWITCHES)
def test_aligner_regions_equal_native(corpus, switch):
    """The Python planner's regions == the native planner's, in two
    chunks (the prefetch thread seeds the second while the first is
    planned); under TPUBWA_NO_NATIVE every seeding row comes from megaq
    and every SA position from occ.sa_lookup."""
    _, fmi, _, recs, *_ = corpus
    reads, _ = _reads(recs)
    opt = MemOpt()
    native = tp.make_device_aligner(opt, fmi, device="cpu")
    want = native(reads)
    assert isinstance(want, FlatRegs)
    walked, seeded = [], []
    real_sa, real_k2 = tp.sa_lookup, smem.rounds12_megaq

    def sa_spy(didx, ranks):
        walked.append(len(ranks))
        return real_sa(didx, ranks)

    def k2_spy(*a, **k):
        seeded.append(1)
        return real_k2(*a, **k)

    # the SA walk of megaq is fused into seeding (smem.sa_lookup), the
    # classic stage's is pipeline's
    tp.sa_lookup, smem.rounds12_megaq = sa_spy, k2_spy
    smem.sa_lookup = sa_spy
    try:
        with native_off(switch):
            aligner = tp.make_device_aligner(opt, fmi, device="cpu")
            aligner.chunk_reads = 40
            got = aligner(reads)
    finally:
        tp.sa_lookup, smem.rounds12_megaq = real_sa, real_k2
        smem.sa_lookup = real_sa
    assert isinstance(got, list) and len(got) == len(reads)
    assert _flat(FlatRegs.from_lists(got)) == _flat(want)
    assert aligner.extender.n_waves > 0
    assert aligner.seed_mode == ("megaq" if switch == "TPUBWA_NO_NATIVE"
                                 else "host")
    assert bool(walked) == bool(seeded) == (switch == "TPUBWA_NO_NATIVE")


@pytest.mark.parametrize("switch", SWITCHES)
@pytest.mark.parametrize("kind,threads", [("se", "1"), ("pe", "1"),
                                          ("se", "4")])
def test_mem_sam_equals_native_and_tpubwa(corpus, switch, kind, threads):
    """`mem --device cpu` under each switch == the port's native run ==
    tpubwa's CLI, SE and PE, and SE at -t 4 (the native stages' threads
    have nothing to split without them)."""
    prefix, *_, fq_se, fq1, fq2 = corpus
    fqs = [fq_se] if kind == "se" else [fq1, fq2]
    extra = ("-t", threads)
    want = _mem(tpubwa_main_mem, prefix, fqs, extra)
    native = _mem(main_mem, prefix, fqs, extra)
    with native_off(switch):
        got = _mem(main_mem, prefix, fqs, extra)
    assert len(got) > (70 if kind == "se" else 100)
    assert got == native == want


def test_seed_mode_default_and_explicit_host(corpus, monkeypatch):
    """megaq by default where the native seeder is unavailable, host
    where it is; an explicit host with no seeder raises at the first
    chunk, as tpubwa's, instead of taking seeding off the device."""
    _, fmi, _, recs, *_ = corpus
    reads, _ = _reads(recs[:4])
    monkeypatch.delenv("TPUBWA_SEED_MODE", raising=False)
    assert tp.make_device_aligner(MemOpt(), fmi, device="cpu").seed_mode \
        == "host"
    with native_off("TPUBWA_NO_NATIVE"):
        assert tp.make_device_aligner(MemOpt(), fmi,
                                      device="cpu").seed_mode == "megaq"
        monkeypatch.setenv("TPUBWA_SEED_MODE", "host")
        aligner = tp.make_device_aligner(MemOpt(), fmi, device="cpu")
        assert aligner.seed_mode == "host"
        with pytest.raises(NotImplementedError, match="native seeder"):
            aligner(reads)


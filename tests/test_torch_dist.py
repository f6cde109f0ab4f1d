"""tpubwa_torch's data-parallel mode (dist/sharding.py:DataParallel, the
counterpart of tpubwa's mesh mode): the split covers the rows exactly,
the index replicas are equal, and the aligner over DataParallel([cpu]*3)
gives the regions and SAM of the port on one device and of tpubwa's
aligner (mirroring tests/test_multichip.py), in seed modes megaq and
host, on a marked and on a stock-bwa index; the extension waves split
over replicas equal the call without them.  Tolerance 0."""
import sys
import threading

import numpy as np
import pytest
import torch

import tpubwa.device  # noqa: F401  (x64, as the JAX package runs)
import tpubwa.host.pipeline
import tpubwa.index
import tpubwa.io.fastq
import tpubwa.opts
from tpubwa.device.pipeline import make_device_aligner as jax_aligner
from tpubwa_torch.cli import main_index
from tpubwa_torch.device import counts, smem
from tpubwa_torch.device import extend_fused as tf
from tpubwa_torch.device import pipeline as tp
from tpubwa_torch.device.extend_kernel import extend_batch_plain
from tpubwa_torch.device.occ import FM_ARRAYS
from tpubwa_torch.dist.dryrun import dryrun_multidevice
from tpubwa_torch.dist.sharding import DataParallel
from tpubwa_torch.host.native_emit import FlatRegs
from tpubwa_torch.host.pipeline import process_seqs
from tpubwa_torch.index import FMIndex
from tpubwa_torch.io.fastq import Read
from tpubwa_torch.opts import MEM_F_PE, MemOpt
from chip_smoke import adversarial_descs
from simread import simulate_pairs
from test_extend_fused import _rand_job

CPU3 = ["cpu"] * 3


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """test_multichip's genome (a 40-base unit three times), indexed by
    the port, and the same index as stock bwa files; both packages load
    each."""
    rng = np.random.default_rng(91)
    d = tmp_path_factory.mktemp("tdist")
    unit = rng.integers(0, 4, 40).astype(np.uint8)
    codes = np.concatenate([
        rng.integers(0, 4, 15000).astype(np.uint8), np.tile(unit, 3),
        rng.integers(0, 4, 8000).astype(np.uint8)])
    bases = "".join("ACGT"[c] for c in codes)
    fa = d / "ref.fa"
    fa.write_text(">m1\n" + "\n".join(
        bases[i:i + 70] for i in range(0, len(bases), 70)) + "\n")
    assert main_index([str(fa)]) == 0
    stock = str(d / "stock")
    FMIndex.load(str(fa)).save_bwa(stock)
    indexes = {"npz": (FMIndex.load(str(fa)),
                       tpubwa.index.FMIndex.load(str(fa))),
               "bwa": (FMIndex.load_bwa(stock),
                       tpubwa.index.FMIndex.load_bwa(stock))}
    assert not indexes["bwa"][0].sa_mark_D
    return codes, indexes


def _pe_records(codes, n_pairs, rng):
    return [x for n, s1, s2, *_ in simulate_pairs(codes, n_pairs, 100, rng)
            for x in ((n, s1), (n, s2))]


def _mixed_records(codes, rng):
    """test_multichip's mixed reads: mutated echoes, a repeat, a random
    read and one with an N."""
    recs = []
    for t in range(12):
        start = int(rng.integers(0, len(codes) - 110))
        q = codes[start:start + 100].copy()
        for _ in range(int(rng.integers(0, 5))):
            q[int(rng.integers(0, 100))] = int(rng.integers(0, 5))
        recs.append((f"x{t}", q))
    recs.append(("rep", np.tile(codes[15000:15040], 3)[:100].copy()))
    recs.append(("junk", rng.integers(0, 4, 100).astype(np.uint8)))
    q = codes[700:800].copy()
    q[50] = 4
    recs.append(("withN", q))
    return recs


def _reads(recs):
    """The port's reads and tpubwa's from the same (name, seq) records,
    seq a string or codes."""
    code = {"A": 0, "C": 1, "G": 2, "T": 3, "N": 4}
    seqs = [(n, s if isinstance(s, np.ndarray) else np.array(
        [code[c] for c in s], np.uint8)) for n, s in recs]
    return ([Read(name=n, seq=x.copy(), qual=None) for n, x in seqs],
            [tpubwa.io.fastq.Read(name=n, seq=x.copy(), qual=None)
             for n, x in seqs])


def _flat(regs):
    if not isinstance(regs, FlatRegs):
        regs = FlatRegs.from_lists(regs)
    return (regs.cnt.tolist(), regs.iv.tolist(), regs.fr.tolist())


# ------------------------------------------------------------- the split
@pytest.mark.parametrize("n,m", [(n, m) for n in range(1, 5)
                                 for m in sorted({0, 1, n - 1, n, 1000})])
def test_split_covers_rows_in_order(n, m):
    dp = DataParallel(["cpu"] * n)
    parts = dp.split(m)
    assert len(parts) == n == dp.n
    assert [r for lo, hi in parts for r in range(lo, hi)] == list(range(m))
    assert all(b[0] == a[1] for a, b in zip(parts, parts[1:]))
    sizes = [hi - lo for lo, hi in parts]
    assert max(sizes) - min(sizes) <= 1


def test_replicate_index_gives_equal_arrays(setup):
    _, indexes = setup
    for fmi, _ in indexes.values():
        dp = DataParallel(CPU3)
        reps = dp.replicate_index(fmi)
        assert len(reps) == 3 and len({id(r) for r in reps}) == 3
        for r in reps[1:]:
            assert torch.equal(r.pac_words, reps[0].pac_words)
            assert (r.l_pac, r.seq_len, r.primary, r.mark_D, r.idt) == (
                reps[0].l_pac, reps[0].seq_len, reps[0].primary,
                reps[0].mark_D, reps[0].idt)
            for name in FM_ARRAYS:
                assert torch.equal(r.upload_fm()[name],
                                   reps[0].upload_fm()[name])
        got = dp.replicate(np.arange(6, dtype=np.int32))
        assert [x.tolist() for x in got] == [list(range(6))] * 3


def test_over_needs_a_card(monkeypatch):
    """No device list means every CUDA device, and none raises: the CPU
    is taken only when named."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="CUDA"):
        DataParallel.over()
    with pytest.raises(RuntimeError, match="CUDA"):
        DataParallel.over(["cuda:0", "cuda:0"])
    with pytest.raises(ValueError):
        DataParallel.over([])
    assert DataParallel.over(["cpu", "cpu"]).n == 2


def test_map_orders_results_and_propagates_failures():
    dp = DataParallel(CPU3)
    names = dp.map(lambda i, p: (i, p, threading.current_thread().name),
                   "abc")
    assert [x[:2] for x in names] == [(0, "a"), (1, "b"), (2, "c")]
    assert all(x[2].startswith("tpubwa-dp") for x in names)
    done = []

    def fail_on_one(i, p):
        if i == 1:
            raise KeyError("replica 1")
        done.append(i)
        return i

    with pytest.raises(KeyError, match="replica 1"):
        dp.map(fail_on_one, [None] * 3)
    assert sorted(done) == [0, 2]      # the other parts ran to their end
    with pytest.raises(ValueError):
        dp.map(fail_on_one, [None] * 2)


def test_counts_are_exact_from_threads():
    """Sixteen threads bump one count 20,000 times each, switching as
    often as the interpreter allows (a lost update would show); the
    replica tallies get their own threads' bumps."""
    def fn():
        pass
    fn.launches = 0
    tallies = [{} for _ in range(16)]

    def work(t):
        with counts.tallying(tallies[t]):
            for _ in range(20000):
                counts.bump(fn)

    threads = [threading.Thread(target=work, args=(t,)) for t in range(16)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert fn.launches == 320000
    assert tallies == [{"fn.launches": 20000}] * 16


# -------------------------------------------------------- the aligner
@pytest.mark.parametrize("mode", ["megaq", "host"])
@pytest.mark.parametrize("reads_kind", ["pairs", "mixed"])
def test_aligner_over_replicas_equals_one_device_and_tpubwa(setup, mode,
                                                           reads_kind):
    """test_multichip's 40 pairs (PE) and its mixed/repetitive reads (SE)
    through the port's aligner over DataParallel([cpu]*3) in ``mode``,
    the port's on one CPU device and tpubwa's on JAX-CPU: equal regions
    and SAM."""
    codes, indexes = setup
    fmi, jfmi = indexes["npz"]
    rng = np.random.default_rng(3 if reads_kind == "pairs" else 5)
    flag = MEM_F_PE if reads_kind == "pairs" else 0
    recs = (_pe_records(codes, 40, rng) if reads_kind == "pairs"
            else _mixed_records(codes, rng))
    reads, jreads = _reads(recs)
    opt, jopt = MemOpt(flag=flag), tpubwa.opts.MemOpt(flag=flag)
    dp = DataParallel(CPU3)
    multi = tp.make_device_aligner(opt, fmi, dp=dp)
    assert multi.seed_mode == "megaq"          # tpubwa's mesh default
    multi.seed_mode = mode
    single = tp.make_device_aligner(opt, fmi, device="cpu")
    jax = jax_aligner(jopt, jfmi, platform="cpu")
    got = multi(reads)
    assert _flat(got) == _flat(single(reads)) == _flat(jax(jreads))
    sam = process_seqs(opt, fmi, reads, 0, align_fn=multi)
    assert sam == process_seqs(opt, fmi, reads, 0, align_fn=single)
    assert sam == tpubwa.host.pipeline.process_seqs(jopt, jfmi, jreads, 0,
                                                    align_fn=jax)
    assert len(sam) >= len(reads)
    # every replica extended jobs; in megaq every replica seeded reads
    assert all(t.get("jobs", 0) > 0 for t in dp.tally)
    assert all((t.get("reads", 0) > 0) == (mode == "megaq")
               for t in dp.tally)
    # the marked index's SA walk is the native one: no rank went down
    assert not any(t.get("ranks") for t in dp.tally)


def test_stock_bwa_index_splits_the_sa_walk(setup):
    """On the stock-bwa index (no text-position marks) the SA walk is
    occ.sa_lookup, split over the replicas (K-sa on each card): SAM
    equal to the port on one device on the marked index, and to
    tpubwa's on the stock one."""
    codes, indexes = setup
    sfmi, sjfmi = indexes["bwa"]
    reads, jreads = _reads(_pe_records(codes, 40,
                                       np.random.default_rng(3)))
    opt, jopt = MemOpt(flag=MEM_F_PE), tpubwa.opts.MemOpt(flag=MEM_F_PE)
    dp = DataParallel(CPU3)
    walked = []
    real = tp.sa_lookup

    def spy(didx, ranks):
        walked.append((str(didx.device), len(ranks)))
        return real(didx, ranks)

    tp.sa_lookup = spy
    try:
        multi = tp.make_device_aligner(opt, sfmi, dp=dp)
        sam = process_seqs(opt, sfmi, reads, 0, align_fn=multi)
    finally:
        tp.sa_lookup = real
    fmi = indexes["npz"][0]
    single = tp.make_device_aligner(opt, fmi, device="cpu")
    assert sam == process_seqs(opt, fmi, reads, 0, align_fn=single)
    jax = jax_aligner(jopt, sjfmi, platform="cpu")
    assert sam == tpubwa.host.pipeline.process_seqs(jopt, sjfmi, jreads,
                                                    0, align_fn=jax)
    ranks = [t.get("ranks", 0) for t in dp.tally]
    assert all(r > 0 for r in ranks)
    assert sum(ranks) == sum(n for _, n in walked)
    assert max(ranks) - min(ranks) <= len(walked)   # split evenly a call


def test_hybrid_over_replicas_raises(setup):
    codes, indexes = setup
    fmi, _ = indexes["npz"]
    reads, _ = _reads(_pe_records(codes, 4, np.random.default_rng(1)))
    aligner = tp.make_device_aligner(MemOpt(), fmi, dp=DataParallel(CPU3))
    aligner.seed_mode = "hybrid"
    with pytest.raises(NotImplementedError, match=r"\[dist-hybrid\]"):
        aligner(reads)
    arr, lens = aligner._pack(reads, 32)
    with pytest.raises(NotImplementedError, match=r"\[dist-hybrid\]"):
        smem.collect_intv_device(MemOpt(), aligner.didxs, arr, lens, fmi,
                                 mode="hybrid", dp=aligner.dp)


# ------------------------------------------------------ the extension
@pytest.mark.parametrize("n_jobs", [0, 2, 48])
def test_desc_waves_over_replicas_equal_one_device(setup, n_jobs):
    """Adversarial descriptors, all of them, fewer than the replicas
    (an empty part) and none: the rows equal the call without a dp."""
    _, indexes = setup
    fmi, _ = indexes["npz"]
    rng = np.random.default_rng(21)
    B, L = 32, 100
    reads = rng.integers(0, 4, (B, L)).astype(np.uint8)
    da = adversarial_descs(rng, fmi.bnt.l_pac, B, L, max(n_jobs, 1))
    da = da[:n_jobs]
    opt = MemOpt()
    args = (opt.scoring_matrix(), opt.o_del, opt.e_del, opt.o_ins,
            opt.e_ins, opt.zdrop, 512)
    dp = DataParallel(CPU3)
    didxs = dp.replicate_index(fmi)
    one = tf.extend_seed_desc_np(didxs[0], torch.from_numpy(reads), da,
                                 *args)
    got = tf.extend_seed_desc_np(didxs, dp.replicate(reads), da, *args,
                                 dp=dp)
    assert got.shape == (n_jobs, 16) and got.tolist() == one.tolist()
    assert [t.get("jobs", 0) for t in dp.tally] == [
        hi - lo for lo, hi in dp.split(n_jobs)]


@pytest.mark.parametrize("n_jobs", [0, 2, 40])
def test_seed_batch_waves_over_replicas_equal_one_device(n_jobs):
    """The Python planner's sequence-tile waves split the same way."""
    opt = MemOpt()
    rng = np.random.default_rng(7)
    jobs = [_rand_job(rng) for _ in range(n_jobs)]
    pen = (opt.scoring_matrix(), opt.o_del, opt.e_del, opt.o_ins,
           opt.e_ins, opt.zdrop)
    dp = DataParallel(CPU3)
    one = tf.extend_seed_batch_np(jobs, *pen, 512, "cpu",
                                  extend=extend_batch_plain)
    got = tf.extend_seed_batch_np(jobs, *pen, 512, None, dp=dp)
    assert got.shape == (n_jobs, 16) and got.tolist() == one.tolist()
    assert sum(t.get("jobs", 0) for t in dp.tally) == n_jobs


def test_dryrun_multidevice_on_three_cpu_replicas():
    facts = dryrun_multidevice(CPU3, mb=0.3, n_pairs=128)
    assert facts["records"] >= facts["reads"] == 256
    assert facts["seed_mode"] == "megaq"
    assert all(t["reads"] > 0 and t["jobs"] > 0 for t in facts["tally"])

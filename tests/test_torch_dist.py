"""tpubwa_torch's data-parallel mode (dist/sharding.py:DataParallel, the
counterpart of tpubwa's mesh mode): the split covers the rows exactly,
the index replicas are equal, and the aligner over DataParallel([cpu]*3)
gives the regions and SAM of the port on one device and of tpubwa's
aligner (mirroring tests/test_multichip.py), in seed modes megaq, host
and hybrid, on a marked and on a stock-bwa index; megaq's SA walk,
fused into seeding, and hybrid's device share split over the replicas
equal one device's, and the balancer takes the slowest replica's wall;
the extension waves split over replicas equal the call without them.
Tolerance 0."""
import sys
import threading
import time

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
from tpubwa_torch.device.smem import HybridSplit
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
    # and walked its rows' ranks (the SA walk fused into seeding, the
    # marked walk; a part of padding rows has none); host mode's SA walk
    # is the native one: no rank went down
    assert all(t.get("jobs", 0) > 0 for t in dp.tally)
    assert all((t.get("reads", 0) > 0) == (mode == "megaq")
               for t in dp.tally)
    assert (sum(t.get("ranks", 0) for t in dp.tally) > 0) == (mode == "megaq")


def _sa_spy(monkeypatch):
    """The SA walks' calls of occ.sa_lookup, (device, ranks) each: the
    classic stage's (pipeline) and the one fused into seeding (smem)."""
    walked = []
    real = tp.sa_lookup

    def spy(didx, ranks):
        walked.append((str(didx.device), len(ranks)))
        return real(didx, ranks)

    monkeypatch.setattr(tp, "sa_lookup", spy)
    monkeypatch.setattr(smem, "sa_lookup", spy)
    return walked


def test_stock_bwa_index_splits_the_sa_walk(setup, monkeypatch):
    """On the stock-bwa index (no text-position marks) the SA walk is
    occ.sa_lookup, split over the replicas (K-sa on each card), in megaq
    fused into each replica's seeding: one walk a replica, of its own
    rows' ranks.  SAM equal to the port on one device on the marked
    index, and to tpubwa's on the stock one."""
    codes, indexes = setup
    sfmi, sjfmi = indexes["bwa"]
    reads, jreads = _reads(_pe_records(codes, 40,
                                       np.random.default_rng(3)))
    opt, jopt = MemOpt(flag=MEM_F_PE), tpubwa.opts.MemOpt(flag=MEM_F_PE)
    dp = DataParallel(CPU3)
    with monkeypatch.context() as mp:
        walked = _sa_spy(mp)
        multi = tp.make_device_aligner(opt, sfmi, dp=dp)
        sam = process_seqs(opt, sfmi, reads, 0, align_fn=multi)
    fmi = indexes["npz"][0]
    single = tp.make_device_aligner(opt, fmi, device="cpu")
    assert sam == process_seqs(opt, fmi, reads, 0, align_fn=single)
    jax = jax_aligner(jopt, sjfmi, platform="cpu")
    assert sam == tpubwa.host.pipeline.process_seqs(jopt, sjfmi, jreads,
                                                    0, align_fn=jax)
    # one walk a replica with rows (the chunk's padding rows have none)
    ranks = [t.get("ranks", 0) for t in dp.tally]
    assert sum(ranks) > 0
    assert sorted(n for _, n in walked) == sorted(r for r in ranks if r)


def test_stock_bwa_index_splits_the_classic_sa_walk(setup, monkeypatch):
    """Host mode's SA stage on the stock-bwa index: the chunk's ranks
    split evenly over the replicas by DataParallel.map_rows."""
    codes, indexes = setup
    sfmi = indexes["bwa"][0]
    reads, _ = _reads(_pe_records(codes, 40, np.random.default_rng(3)))
    opt = MemOpt(flag=MEM_F_PE)
    dp = DataParallel(CPU3)
    multi = tp.make_device_aligner(opt, sfmi, dp=dp)
    multi.seed_mode = "host"
    with monkeypatch.context() as mp:
        walked = _sa_spy(mp)
        got = multi(reads)
    single = tp.make_device_aligner(opt, sfmi, device="cpu")
    assert _flat(got) == _flat(single(reads))
    ranks = [t.get("ranks", 0) for t in dp.tally]
    assert all(r > 0 for r in ranks)
    assert sum(ranks) == sum(n for _, n in walked)
    assert max(ranks) - min(ranks) <= len(walked)   # split evenly a call


# ------------------------------------------------ hybrid over replicas
@pytest.fixture(scope="module")
def chunk(setup):
    """48 PE reads of the setup genome and 15 mixed ones, packed into a
    chunk of 64 (one padding row), with host mode's rows and the classic
    SA positions, on the marked and the stock-bwa index."""
    codes, indexes = setup
    recs = (_pe_records(codes, 24, np.random.default_rng(12))
            + _mixed_records(codes, np.random.default_rng(5)))[:63]
    reads, _ = _reads(recs)
    out = {}
    for kind, (fmi, _) in indexes.items():
        one = tp.make_device_aligner(MemOpt(), fmi, device="cpu")
        arr, lens = one._pack(reads, 64)
        flat, frid, _ = smem.collect_intv_device(MemOpt(), one.didx, arr,
                                                 lens, fmi)
        out[kind] = {"fmi": fmi, "one": one, "arr": arr, "lens": lens,
                     "host": (flat, frid),
                     "sa": one._sa_positions((flat, None))}
    return out


def _hybrid(c, k, dp=None, **kw):
    split = HybridSplit(f=(k + 0.5) / len(c["lens"]), auto=False,
                        k_floor=1)
    didx = c["one"].didx if dp is None else dp.replicate_index(c["fmi"])
    got = smem.collect_intv_device(MemOpt(), didx, c["arr"], c["lens"],
                                   c["fmi"], mode="hybrid", split=split,
                                   dp=dp, **kw)
    assert [h[:2] for h in split.history] == [(len(c["lens"]), k)]
    return got


@pytest.mark.parametrize("kind", ["npz", "bwa"])
@pytest.mark.parametrize("k", [2, 37])
def test_hybrid_over_replicas_equals_host_and_one_device(chunk, monkeypatch,
                                                        kind, k):
    """Hybrid over DataParallel([cpu]*3) with k pinned: k = 2 gives one
    replica no device read (it seeds and walks nothing), 37 puts the seam
    inside the chunk's real reads.  Rows equal host mode's and one-device
    hybrid's; the SA segments equal one-device hybrid's (the host share
    -1 on the stock index), and merged by the aligner the classic
    positions; every replica holds the whole chunk."""
    c = chunk[kind]
    dp = DataParallel(CPU3)
    with monkeypatch.context() as mp:
        walked = _sa_spy(mp)
        flat, frid, qd, sa = _hybrid(c, k, dp, return_sa=True)
    assert np.array_equal(flat, c["host"][0])
    assert np.array_equal(frid, c["host"][1])
    assert len(qd) == 3 and all(torch.equal(x, torch.from_numpy(c["arr"]))
                                for x in qd)
    one = _hybrid(c, k, return_sa=True)
    assert np.array_equal(one[0], flat) and np.array_equal(one[1], frid)
    assert np.array_equal(one[3][0], sa[0])
    assert np.array_equal(one[3][1], sa[1])
    assert ((sa[0][frid >= k] == -1).all() if kind == "bwa"
            else (sa[0] >= 0).all())
    pos, cnt = c["one"]._sa_merge(flat, *sa)
    assert np.array_equal(cnt, c["sa"][1]) and np.array_equal(pos, c["sa"][0])
    parts = dp.split(k)
    assert [t.get("reads", 0) for t in dp.tally] == [hi - lo
                                                     for lo, hi in parts]
    walks = sorted(n for _, n in walked)
    assert sorted(t["ranks"] for t in dp.tally if t.get("ranks")) == walks
    assert len(walks) == sum(hi > lo for lo, hi in parts)


@pytest.mark.parametrize("kind", ["npz", "bwa"])
def test_megaq_fused_sa_over_replicas_equals_one_device(chunk, kind):
    """megaq over the replicas with return_sa: each replica's segments,
    K2's rows' before K3's hits' in replica order, carried through the
    one merge, equal one device's classic positions (which equal its
    fused ones, tests/test_torch_safuse.py)."""
    c = chunk[kind]
    dp = DataParallel(CPU3)
    flat, frid, qd, (cnt, pos) = smem.collect_intv_device(
        MemOpt(), dp.replicate_index(c["fmi"]), c["arr"], c["lens"],
        c["fmi"], mode="megaq", dp=dp, return_sa=True)
    assert np.array_equal(flat, c["host"][0])
    assert np.array_equal(frid, c["host"][1])
    assert len(qd) == 3
    assert np.array_equal(cnt, c["sa"][1]) and np.array_equal(pos, c["sa"][0])
    assert [t.get("reads", 0) for t in dp.tally] == [21, 21, 22]
    assert sum(t.get("ranks", 0) for t in dp.tally) == len(pos)


def test_hybrid_balancer_over_replicas_takes_the_slowest(chunk,
                                                         monkeypatch):
    """One update a chunk, t_dev the device share's wall: each replica's
    part is a stand-in held 0.1 s (replica 0) or 0.3 s (replica 2), side
    by side, so the wall is at least the slowest one's and less than
    their sum."""
    c = chunk["npz"]
    dp = DataParallel(CPU3)
    didxs = dp.replicate_index(c["fmi"])
    hold = {id(didxs[0]): 0.1, id(didxs[2]): 0.3}
    none = (np.zeros(0, np.int64), np.zeros(0, np.int64))

    def held(opt, didx, *a, **k):
        time.sleep(hold.get(id(didx), 0.0))
        return smem.Seeded(np.zeros((0, 5), np.int64), none[0], (),
                           none, none)

    monkeypatch.setattr(smem, "_megaq_rounds", held)
    split = HybridSplit(f=0.5, auto=True, k_floor=1)
    for n in (1, 2):
        smem.collect_intv_device(MemOpt(), didxs, c["arr"], c["lens"],
                                 c["fmi"], mode="hybrid", split=split,
                                 dp=dp, return_sa=True)
        assert len(split.history) == n
        B, k, t_dev, t_host, _ = split.history[-1]
        assert (B, k) == (64, 32) and 0.3 <= t_dev < 0.4 and t_host > 0
    assert split.chunks == 2


def test_mem_hybrid_over_replicas_equals_tpubwa(setup, monkeypatch):
    """`mem`'s path (process_seqs over the aligner) with
    TPUBWA_SEED_MODE=hybrid over DataParallel([cpu]*3), the share pinned
    and the floor lowered so that the seam falls inside the chunk: SAM
    equal to host mode's on one device and to tpubwa's."""
    codes, indexes = setup
    fmi, jfmi = indexes["npz"]
    reads, jreads = _reads(_pe_records(codes, 40, np.random.default_rng(3)))
    opt, jopt = MemOpt(flag=MEM_F_PE), tpubwa.opts.MemOpt(flag=MEM_F_PE)
    monkeypatch.setenv("TPUBWA_SEED_MODE", "hybrid")
    monkeypatch.setenv("TPUBWA_HYBRID_AUTO", "0")
    monkeypatch.setenv("TPUBWA_HYBRID_K_FLOOR", "8")
    dp = DataParallel(CPU3)
    multi = tp.make_device_aligner(opt, fmi, dp=dp)
    assert multi.seed_mode == "hybrid"
    sam = process_seqs(opt, fmi, reads, 0, align_fn=multi)
    assert [h[:2] for h in multi.hybrid.history] == [(128, 32)]
    assert all(t.get("reads", 0) > 0 for t in dp.tally)
    monkeypatch.delenv("TPUBWA_SEED_MODE")
    single = tp.make_device_aligner(opt, fmi, device="cpu")
    assert single.seed_mode == "host"
    assert sam == process_seqs(opt, fmi, reads, 0, align_fn=single)
    jax = jax_aligner(jopt, jfmi, platform="cpu")
    assert sam == tpubwa.host.pipeline.process_seqs(jopt, jfmi, jreads, 0,
                                                    align_fn=jax)
    assert len(sam) >= len(reads)


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

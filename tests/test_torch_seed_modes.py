"""The port's seed modes reach, cursor, mega, fused and split on the CPU
(device/smem.py:collect_intv_device(mode=...): the reach rounds over
K-reach's plain version, the job rounds of cursor and fused over
K-cur's (device/smem_cursor.py), mega's over K2's
(device/smem_fused.py) and split's over K-fwd's and K-bwd's
(device/smem_split.py)) against tpubwa on JAX-CPU in the same mode, the
scalar oracle ref.smem.collect_intv, the port's host mode, and one
device against two replicas.

* ``smems_round1`` and ``smems_reseed`` == tpubwa's (x in {10, 45, 70},
  min_intv in {2, 3, 5}) and == smem1a;
* K-reach on the host harness (csrc/occ_host.cpp) gives each job the
  same (ik, e) however the jobs are laid out: round 2's jobs of one read
  concatenated, shuffled, and in reverse;
* ``run_smem_jobs`` == tpubwa's ``run_smem_jobs`` (``mem[k, :mem_n[k]]``,
  at caps where no lane overflows, which the test asserts) on round-1
  and round-2 jobs;
* ``collect_intv_device(mode=...)``'s (flat, frid) == tpubwa's
  ``return_flat=True``, in order, == ref.smem.collect_intv read by read
  and == host mode;
* `mem`'s path (process_seqs over the aligner) in each mode, SE and PE,
  at max_mem_intv 20 and 0: SAM == tpubwa's aligner in the same mode ==
  the port's host mode, and over a DataParallel of two CPU replicas ==
  one device.

On tpubwa's seeding test genome (3,070 bases with a tandem repeat,
tests/test_device_smem.py) and its cursor genome (60 kb with planted
repeats, tests/test_smem_cursor.py), each indexed by both packages from
the same input, int32 and int64 ranks.  Tolerance 0."""
import dataclasses

import numpy as np
import pytest
import torch

import tpubwa.device  # noqa: F401  (x64, as the JAX package runs)
import jax.numpy as jnp
import tpubwa.host.pipeline
import tpubwa.index
import tpubwa.io.fastq
import tpubwa.opts
from tpubwa.device import smem as jsmem
from tpubwa.device.occ import DeviceIndex as JaxIndex
from tpubwa.device.pipeline import make_device_aligner as jax_aligner
from tpubwa.device.smem_cursor import run_smem_jobs as jax_run_smem_jobs
from tpubwa.index.build import BntSeq as JaxBnt, SeqAnn as JaxAnn
from tpubwa.ref.smem import collect_intv, smem1a
from tpubwa_torch.device import pipeline as tp
from tpubwa_torch.device import (smem, smem_cursor, smem_fused, smem_split,
                                 warp_host)
from tpubwa_torch.device.occ import DeviceIndex
from tpubwa_torch.dist.sharding import DataParallel
from tpubwa_torch.host.pipeline import process_seqs
from tpubwa_torch.index import FMIndex
from tpubwa_torch.index.build import BntSeq, SeqAnn
from tpubwa_torch.io.fastq import Read
from tpubwa_torch.opts import MEM_F_PE, MemOpt
from simread import simulate_pairs, simulate_reads
from test_smem_cursor import _reads as cursor_reads
from test_torch_occ_host import host_arrays
from test_torch_smem import _pack, _test_genome

MODES = ["reach", "cursor", "mega", "fused", "split"]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The plain reach steps a few thousand jobs a round through tensors
    big enough for torch's intra-op threads, which, where the test
    workers share the machine's cores, spin far longer than they work
    (a reach case took 99 s under six such processes against 0.7 s on
    one thread).  The results do not depend on the threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cursor_genome():
    """tests/test_smem_cursor.py's genome (60,000 random bases, seed 77,
    two repeats planted) and reads: 48 mutated windows, a third with two
    N (seed 1), and its edge reads (:141-175): shorter than
    min_seed_len, all N, N at the cursor's start, a full-length match."""
    rng = np.random.default_rng(77)
    n = 60000
    codes = rng.integers(0, 4, n).astype(np.uint8)
    codes[20000:21000] = codes[1000:2000]
    codes[40000:40500] = codes[1500:2000]
    ann = dict(name="c", anno="", offset=0, length=n, n_ambs=0)
    fmi = FMIndex.build(BntSeq(l_pac=n, anns=[SeqAnn(**ann)], ambs=[],
                               seed=11, codes=codes))
    jfmi = tpubwa.index.FMIndex.build(JaxBnt(
        l_pac=n, anns=[JaxAnn(**ann)], ambs=[], seed=11, codes=codes))
    arr, lens = cursor_reads(codes, np.random.default_rng(1), 48, amb=True)
    reads = [arr[i, :lens[i]] for i in range(len(lens))]
    reads += [codes[100:110].copy(), np.full(60, 4, np.uint8),
              np.concatenate([[4, 4], codes[200:300]]).astype(np.uint8),
              codes[500:628].copy()]
    return fmi, jfmi, reads, codes


@pytest.fixture(scope="module")
def genomes(tmp_path_factory):
    fmi, jfmi, reads = _test_genome(tmp_path_factory.mktemp("tmodes"))
    out = {"test": (fmi, jfmi, reads), "cursor": _cursor_genome()[:3]}
    for fmi, jfmi, _ in out.values():
        assert (fmi.seq_len, fmi.primary) == (jfmi.seq_len, jfmi.primary)
        assert np.array_equal(fmi.occ_ckpt, jfmi.occ_ckpt)
        assert np.array_equal(fmi.bwt_words, jfmi.bwt_words)
    return out


def _didx(fmi, idt):
    didx = DeviceIndex.from_fmindex(fmi, "cpu")
    return didx if idt == "int32" else dataclasses.replace(
        didx, idt=torch.int64, _fm=None)


def _opts(**kw):
    opt, jopt = MemOpt(**kw), tpubwa.opts.MemOpt(**kw)
    assert vars(opt) == vars(jopt)
    return opt, jopt


def _tensors(arr, lens):
    return torch.from_numpy(arr), torch.from_numpy(lens)


def _reads(recs):
    """The port's reads and tpubwa's from the same (name, seq string)
    records."""
    seqs = [(n, np.array(["ACGTN".index(c) for c in s], np.uint8))
            for n, s in recs]
    return ([Read(name=n, seq=x.copy(), qual=None) for n, x in seqs],
            [tpubwa.io.fastq.Read(name=n, seq=x.copy(), qual=None)
             for n, x in seqs])


CASES = [(g, i) for g in ("test", "cursor") for i in ("int32", "int64")]


@pytest.mark.parametrize("name,idt", CASES)
def test_smems_round1_equals_tpubwa(genomes, name, idt):
    """Round 1 of mode reach: every read's SMEMs by start, == tpubwa's
    smems_round1 read by read, on reads packed to 128 columns (28 or
    more pad starts a read fail at once)."""
    fmi, jfmi, reads = genomes[name]
    arr, lens = _pack(reads)
    got = smem.smems_round1(_didx(fmi, idt), *_tensors(arr, lens), 19)
    want = jsmem.smems_round1(JaxIndex.from_fmindex(jfmi), arr, lens, 19)
    assert len(got) == len(want) == len(reads)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == np.int64 and g.tolist() == w.tolist(), i
    assert sum(map(len, got)) > len(reads)


@pytest.mark.parametrize("idt", ["int32", "int64"])
def test_smems_reseed_equals_tpubwa_and_smem1a(genomes, idt):
    """Round 2 of mode reach, every job in one K-reach launch: a pair a
    job, == tpubwa's smems_reseed and, as sorted sets, == smem1a(x,
    min_intv), on tests/test_device_smem.py's reads (the repeat unit
    three times, and a window across the repeat's start)."""
    fmi, jfmi, _ = genomes["test"]
    text = fmi.bnt.doubled()
    unit = text[1500:1535]
    reads = [np.tile(unit, 3)[:90].copy(), text[1490:1590].copy()]
    arr, lens = _pack(reads)
    jobs = [(r, x, mi) for r in range(2) for x in (10, 45, 70)
            for mi in (2, 3, 5) if reads[r][x] <= 3]
    got = smem.smems_reseed(_didx(fmi, idt), *_tensors(arr, lens), jobs, 1)
    want = jsmem.smems_reseed(JaxIndex.from_fmindex(jfmi), arr, lens, jobs, 1)
    assert [r for r, _ in got] == [r for r, _ in want] == [j[0] for j in jobs]
    tmp = []
    for (r, rows), (_, wrows), (_, x, mi) in zip(got, want, jobs):
        assert rows.tolist() == wrows.tolist(), (r, x, mi)
        smem1a(jfmi, reads[r], x, mi, 0, tmp)
        assert sorted(map(tuple, rows.tolist())) == sorted(
            (m.x0, m.x1, m.size, m.qb, m.qe) for m in tmp), (r, x, mi)
    assert all(len(rows) for _, rows in got)
    assert smem.smems_reseed(_didx(fmi, idt), *_tensors(arr, lens), [],
                             1) == []


@pytest.mark.parametrize("idt", ["int32", "int64"])
def test_reach_jobs_layout_free(genomes, idt):
    """K-reach links a job to its right neighbour only for the same read,
    the next start and the same min_intv; round 2's jobs of one read meet
    at x_A -> 0, no link.  On the host harness the same jobs
    concatenated, shuffled and reversed give each job the same (ik, e),
    == the plain version."""
    fmi, _, reads = genomes["test"]
    arr, lens = _pack(reads)
    didx = _didx(fmi, idt)
    rows, rids = smem.reach_round1(didx, *_tensors(arr, lens), 19)
    rid, x, mi = smem.reseed_jobs(MemOpt(), rows, rids)
    # three jobs on the first re-seeded read, then every job
    rid = torch.cat([rid[:1].repeat(3), rid])
    x = torch.cat([torch.tensor([x[0], 10, 60], dtype=torch.int32), x])
    mi = torch.cat([torch.tensor([mi[0], 2, 2], dtype=didx.idt), mi])
    ri, starts, mij, job = smem.reseed_starts(rid, x, mi)
    want = smem.rightmost_reach_plain(didx, *_tensors(arr, lens), ri,
                                      starts, mij)
    arrays = host_arrays(didx)
    perm = np.random.default_rng(3).permutation(len(job))
    for order in (np.arange(len(job)), perm, np.arange(len(job))[::-1]):
        ik, e = warp_host.reach_host(arrays, arr, lens, ri.numpy()[order],
                                     starts.numpy()[order],
                                     mij.numpy()[order])
        back = np.argsort(order)
        assert ik[back].tolist() == want[0].tolist()
        assert e[back].tolist() == want[1].tolist()
    assert len(x) >= 4 and int((e > starts.numpy()[order]).sum()) > 0


def _jax_jobs(jfmi, arr, lens, jobs, min_seed_len):
    """tpubwa's run_smem_jobs: a list of each job's rows; no lane may
    overflow its caps."""
    mem, mem_n, ovf = jax_run_smem_jobs(
        JaxIndex.from_fmindex(jfmi), jnp.asarray(arr), jnp.asarray(lens),
        tuple(x.numpy() for x in jobs), min_seed_len)
    assert not ovf.any()
    return [mem[k, :int(mem_n[k])].tolist() for k in range(len(mem))]


@pytest.mark.parametrize("name,idt", CASES)
def test_run_smem_jobs_equals_tpubwa(genomes, name, idt):
    """K-cur's contract (its plain version): round-1 jobs (a read each,
    restarting past N) and round 2's one-shot jobs, each job's rows ==
    tpubwa's cursor machine's (its emission order within a call is by
    descending start, the port's by ascending: compared sorted), with
    the counts; a one-shot job at an N or past its read's end has no
    rows."""
    fmi, jfmi, reads = genomes[name]
    arr, lens = _pack(reads)
    didx = _didx(fmi, idt)
    q, ld = _tensors(arr, lens)
    B = len(reads)
    r1 = smem_cursor.round1_jobs(B, didx.idt, "cpu")
    rows1, rids1 = smem_fused.rounds12_plain(MemOpt(split_factor=1e9), didx,
                                             q, ld)
    rid, x, mi = smem.reseed_jobs(MemOpt(), rows1, rids1)
    # a one-shot job at the first N of a read, and one past a read's end
    r_n, at_n = np.argwhere(arr == 4)[0]
    assert at_n < lens[r_n]
    r2 = (torch.cat([rid, torch.tensor([r_n, 0], dtype=torch.int32)]),
          torch.cat([x, torch.tensor([at_n, 120], dtype=torch.int32)]),
          torch.cat([mi, torch.ones(2, dtype=didx.idt)]),
          torch.ones(len(rid) + 2, dtype=torch.bool))
    for jobs, round1 in ((r1, True), (r2, False)):
        rows, counts = smem_cursor.run_smem_jobs(didx, q, ld, jobs, 19)
        assert rows.dtype == didx.idt and counts.dtype == torch.int32
        want = _jax_jobs(jfmi, arr, lens, jobs, 19)
        got = rows.tolist()
        at = 0
        for k, w in enumerate(want):
            n = int(counts[k])
            assert sorted(got[at:at + n]) == sorted(w), (round1, k)
            at += n
        assert at == len(got)
        if round1:  # round 1 == K2's round 1 (rounds12 with no round 2)
            assert torch.equal(rows, rows1)
        else:
            assert counts[-2:].tolist() == [0, 0] and len(rid) > 0


@pytest.fixture(scope="module")
def references(genomes):
    """What the modes are held to, each computed once for the cases that
    share it: tpubwa's mode on JAX-CPU (its index is the same for both of
    the port's rank types) by (mode, genome, max_mem_intv); the oracle's
    rows read by read by (genome, max_mem_intv); the port's host mode by
    (genome, rank type, max_mem_intv)."""
    cache = {}

    def get(kind, *key):
        if (kind, *key) not in cache:
            cache[(kind, *key)] = _reference(genomes, kind, *key)
        return cache[(kind, *key)]
    return get


def _reference(genomes, kind, *key):
    if kind == "tpubwa":
        mode, name, max_mem_intv = key
        _, jfmi, reads = genomes[name]
        _, jopt = _opts(max_mem_intv=max_mem_intv)
        flat, frid = jsmem.collect_intv_device(
            jopt, JaxIndex.from_fmindex(jfmi), *_pack(reads), fmi=jfmi,
            mode=mode, return_flat=True)
        return np.asarray(flat).tolist(), np.asarray(frid).tolist()
    if kind == "oracle":
        name, max_mem_intv = key
        _, jfmi, reads = genomes[name]
        _, jopt = _opts(max_mem_intv=max_mem_intv)
        return [[(m.x0, m.x1, m.size, m.qb, m.qe)
                 for m in collect_intv(jopt, jfmi, r)] for r in reads]
    name, idt, max_mem_intv = key
    fmi, _, reads = genomes[name]
    opt, _ = _opts(max_mem_intv=max_mem_intv)
    return smem.collect_intv_device(opt, _didx(fmi, idt), *_pack(reads),
                                    fmi)[:2]


@pytest.mark.parametrize("max_mem_intv", [20, 0])
@pytest.mark.parametrize("name,idt", CASES)
@pytest.mark.parametrize("mode", MODES)
def test_modes_equal_tpubwa_and_the_oracle(genomes, references, mode, name,
                                           idt, max_mem_intv):
    """collect_intv_device(mode=...) == tpubwa's in the same mode
    (``return_flat=True``), rows and read ids in order; == ref.smem.
    collect_intv read by read; == the port's host mode; and with
    ``return_sa`` no fused walk (``sa`` None), the first three outputs
    being those without it."""
    fmi, _, reads = genomes[name]
    arr, lens = _pack(reads)
    opt, _ = _opts(max_mem_intv=max_mem_intv)
    flat, frid, qd, sa = smem.collect_intv_device(
        opt, _didx(fmi, idt), arr, lens, fmi, mode=mode, return_sa=True)
    assert sa is None
    assert flat.dtype == frid.dtype == np.int64
    assert torch.equal(qd, torch.from_numpy(arr))
    jflat, jfrid = references("tpubwa", mode, name, max_mem_intv)
    assert flat.tolist() == jflat
    assert frid.tolist() == jfrid
    for i, want in enumerate(references("oracle", name, max_mem_intv)):
        assert list(map(tuple, flat[frid == i].tolist())) == want, i
    host = references("host", name, idt, max_mem_intv)
    assert np.array_equal(flat, host[0]) and np.array_equal(frid, host[1])


# each mode's rounds 1 and 2: {function: calls} on the "test" genome
OWN_ROUNDS = {"reach": {"rightmost_reach": 2},
              "cursor": {"run_smem_jobs": 2}, "fused": {"run_smem_jobs": 2},
              "mega": {"rounds12_megaq": 1},
              "split": {"run_fwd": 2, "run_bwd": 2}}


@pytest.mark.parametrize("mode", MODES)
def test_modes_run_their_own_rounds(genomes, mode, monkeypatch):
    """reach seeds through rightmost_reach (round 1 every (read, start)
    of the chunk, round 2 all its jobs: two calls), cursor and fused
    through run_smem_jobs (two calls), mega through K2's rounds12_megaq
    (one call for both rounds), split through run_fwd and run_bwd (each
    once a round); none calls the native seeder or another mode's
    function, and each runs K3 once."""
    fmi, _, reads = genomes["test"]
    arr, lens = _pack(reads)
    calls = {}
    own = OWN_ROUNDS[mode]

    def spy(mod, name):
        real = getattr(mod, name)

        def counted(*a, **k):
            calls[name] = calls.get(name, 0) + 1
            return real(*a, **k)
        monkeypatch.setattr(mod, name, counted)

    def banned(*a, **k):
        raise AssertionError("a mode seeded through another's function")

    for mod, name in ((smem, "rightmost_reach"), (smem, "run_smem_jobs"),
                      (smem, "rounds12_megaq"), (smem_split, "run_fwd"),
                      (smem_split, "run_bwd")):
        if name in own:
            spy(mod, name)
        else:
            monkeypatch.setattr(mod, name, banned)
    spy(smem, "_seed_strategy_scan")
    monkeypatch.setattr(smem, "smem_collect_batch_native", banned)
    smem.collect_intv_device(MemOpt(), _didx(fmi, "int32"), arr, lens, fmi,
                             mode=mode)
    assert calls == {**own, "_seed_strategy_scan": 1}


@pytest.fixture(scope="module")
def corpus():
    """The cursor genome's index in both packages, 40 SE reads (SNPs and
    indels) with a read of N inside and a repeat read, and 16 pairs."""
    fmi, jfmi, _, codes = _cursor_genome()
    rng = np.random.default_rng(31)
    se = [(n, s) for n, s, *_ in simulate_reads(codes, 40, 100, rng,
                                                snp_rate=0.02,
                                                indel_rate=0.004)]
    se += [("withn", se[0][1][:40] + "NNNN" + se[0][1][44:]),
           ("rep", "".join("ACGT"[c] for c in codes[20100:20200]))]
    pe = [x for n, s1, s2, *_ in simulate_pairs(codes, 16, 100, rng)
          for x in ((n, s1), (n, s2))]
    return fmi, jfmi, {False: _reads(se), True: _reads(pe)}


def _sam(opt, fmi, reads, mode, dp=None):
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("TPUBWA_SEED_MODE", mode)
        aligner = tp.make_device_aligner(opt, fmi, device="cpu", dp=dp)
    assert aligner.seed_mode == mode
    return process_seqs(opt, fmi, reads, 0, align_fn=aligner)


def _mem_opts(paired, max_mem_intv=20):
    """The port's and tpubwa's MemOpt for `mem` SE or PE."""
    kw = {"max_mem_intv": max_mem_intv}
    return _opts(flag=MEM_F_PE, **kw) if paired else _opts(**kw)


@pytest.fixture(scope="module")
def one_device_sam(corpus):
    """The port's SAM on one CPU device by (mode, paired, max_mem_intv),
    each computed once for the tests that compare with it."""
    cache = {}

    def get(mode, paired, max_mem_intv=20):
        key = (mode, paired, max_mem_intv)
        if key not in cache:
            fmi, _, recs = corpus
            opt, _ = _mem_opts(paired, max_mem_intv)
            cache[key] = _sam(opt, fmi, recs[paired][0], mode)
        return cache[key]
    return get


@pytest.mark.parametrize("paired", [False, True])
@pytest.mark.parametrize("mode", MODES)
def test_mem_sam_equals_tpubwa_and_host(corpus, one_device_sam, mode,
                                        paired, monkeypatch):
    """`mem`'s path with TPUBWA_SEED_MODE=mode, SE and PE: SAM == tpubwa's
    aligner in the same mode (on JAX-CPU) == the port's host mode."""
    _held_to_tpubwa_and_host(corpus, one_device_sam, mode, paired, 20,
                             monkeypatch)


def _held_to_tpubwa_and_host(corpus, one_device_sam, mode, paired,
                             max_mem_intv, monkeypatch):
    """`mem`'s SAM in ``mode`` == tpubwa's aligner in the mode (JAX-CPU)
    == the port's host mode."""
    _, jfmi, recs = corpus
    reads, jreads = recs[paired]
    _, jopt = _mem_opts(paired, max_mem_intv)
    got = one_device_sam(mode, paired, max_mem_intv)
    monkeypatch.setenv("TPUBWA_SEED_MODE", mode)
    jax = jax_aligner(jopt, jfmi, platform="cpu")
    assert jax.seed_mode == mode
    assert got == tpubwa.host.pipeline.process_seqs(jopt, jfmi, jreads, 0,
                                                    align_fn=jax)
    assert got == one_device_sam("host", paired, max_mem_intv)
    assert len(got) >= len(reads)


@pytest.mark.parametrize("mode", MODES)
def test_mem_over_two_replicas_equals_one_device(corpus, one_device_sam,
                                                 mode):
    """The aligner over DataParallel([cpu, cpu]) in each mode (the chunk's
    reads split between the replicas, each seeding its part): PE SAM ==
    one device's, and both replicas seeded reads."""
    _replicas_held_to_one_device(corpus, one_device_sam, mode, 20)


def _replicas_held_to_one_device(corpus, one_device_sam, mode,
                                 max_mem_intv):
    """PE SAM over DataParallel([cpu, cpu]) == one device's; both
    replicas seeded reads."""
    fmi, _, recs = corpus
    reads, _ = recs[True]
    dp = DataParallel(["cpu", "cpu"])
    try:
        opt, _ = _mem_opts(True, max_mem_intv)
        multi = _sam(opt, fmi, reads, mode, dp=dp)
        assert all(t.get("reads", 0) > 0 for t in dp.tally)
    finally:
        dp.close()
    assert multi == one_device_sam(mode, True, max_mem_intv)


@pytest.mark.parametrize("paired", [False, True])
@pytest.mark.parametrize("mode", MODES)
def test_mem_sam_without_round3(corpus, one_device_sam, mode, paired,
                                monkeypatch):
    """As above at max_mem_intv 0 (no round 3, K3 not run): SAM ==
    tpubwa's aligner in the same mode == the port's host mode; PE over
    two CPU replicas == one device."""
    _held_to_tpubwa_and_host(corpus, one_device_sam, mode, paired, 0,
                             monkeypatch)
    if paired:
        _replicas_held_to_one_device(corpus, one_device_sam, mode, 0)

"""The SA walk fused into megaq seeding (device/smem.py: collect_intv_device(
..., return_sa=True), sa_ranks, merge_rounds' segments; device/pipeline.py:
DeviceAligner._sa_merge) on the CPU, where K-sa is occ.sa_lookup's plain
walk.  The fused (cnt, pos) of a chunk equal the port's classic SA stage
(DeviceAligner._sa_positions), ref.smem.sa_positions row by row and
tpubwa's DeviceAligner._seed_chunk in megaq on JAX-CPU, on the marked and
the stock-bwa index, int32 and int64 ranks, -c 500 / 3 / 0, with and
without round 3; the host SA stage is not called.  Tolerance 0."""
import dataclasses
import types

import numpy as np
import pytest
import torch

import tpubwa.device  # noqa: F401  (x64, as the JAX package runs)
import tpubwa.index
import tpubwa.io.fastq
import tpubwa.opts
from tpubwa.device.pipeline import DeviceAligner as JaxAligner
from tpubwa_torch.device import pipeline as tp
from tpubwa_torch.device import smem
from tpubwa_torch.device.smem import HybridSplit, sa_counts, sa_ranks
from tpubwa_torch.host.pipeline import process_seqs
from tpubwa_torch.index import FMIndex
from tpubwa_torch.io.fastq import Read
from tpubwa_torch.opts import MemOpt
from tpubwa_torch.ref.smem import BwtIntv, sa_positions

N_READS, READ_LEN = 48, 80
# the (index, -c) pairs held to tpubwa on JAX-CPU too: each costs its own
# compile of tpubwa's seeding machine (about 6 s), and the file keeps
# under a minute; -c 0 gives no position on either side
JAX_CASES = {("marked", None), ("marked", 3), ("stock", None)}


@pytest.fixture(scope="module")
def genome(tmp_path_factory):
    """A 10 kb genome with a 37-base unit 8 times (seed 21), so that
    round 3's seeds occur up to 8 times and -c 3 subsamples with step 2;
    its marked index and its stock-bwa files, each loaded by both
    packages; 48 reads of 80 bases (seed 5): mutated windows of the
    doubled text, 4 tiled repeat units, an all-N read and a 12-base
    one."""
    rng = np.random.default_rng(21)
    unit = rng.integers(0, 4, 37).astype(np.uint8)
    codes = np.concatenate([
        rng.integers(0, 4, 5000).astype(np.uint8), np.tile(unit, 8),
        rng.integers(0, 4, 5000).astype(np.uint8)])
    d = tmp_path_factory.mktemp("tsafuse")
    fa = str(d / "g.fa")
    with open(fa, "w") as fh:
        fh.write(">g\n" + "".join("ACGT"[c] for c in codes) + "\n")
    fmi = FMIndex.from_fasta(fa)
    stock = str(d / "stock")
    fmi.save_bwa(stock)
    indexes = {"marked": (fmi, tpubwa.index.FMIndex.from_fasta(fa)),
               "stock": (FMIndex.load_bwa(stock),
                         tpubwa.index.FMIndex.load_bwa(stock))}
    assert fmi.sa_mark_D and not indexes["stock"][0].sa_mark_D
    text = fmi.bnt.doubled()
    rng = np.random.default_rng(5)
    seqs = []
    for _ in range(N_READS - 6):
        start = int(rng.integers(0, len(text) - 90))
        q = text[start:start + READ_LEN].copy()
        for _ in range(int(rng.integers(0, 4))):
            q[int(rng.integers(0, READ_LEN))] = int(rng.integers(0, 5))
        seqs.append(q)
    seqs += [np.tile(unit, 4)[s:s + READ_LEN].copy()
             for s in (0, 5, 11, 30)]
    seqs += [np.full(READ_LEN, 4, np.uint8), text[6000:6012].copy()]
    reads = [Read(name=f"r{i}", seq=q.copy(), qual=None)
             for i, q in enumerate(seqs)]
    jreads = [tpubwa.io.fastq.Read(name=f"r{i}", seq=q.copy(), qual=None)
              for i, q in enumerate(seqs)]
    return indexes, reads, jreads, {}


def _opts(max_occ, max_mem_intv):
    kw = {} if max_occ is None else {"max_occ": max_occ}
    kw["max_mem_intv"] = max_mem_intv
    opt, jopt = MemOpt(**kw), tpubwa.opts.MemOpt(**kw)
    assert vars(opt) == vars(jopt)
    return opt, jopt


def _aligner(opt, fmi, idt, mode="megaq", monkeypatch=None):
    monkeypatch.setenv("TPUBWA_SEED_MODE", mode)
    aligner = tp.make_device_aligner(opt, fmi, device="cpu")
    assert aligner.seed_mode == mode
    if idt == "int64":
        aligner.didx = dataclasses.replace(aligner.didx, idt=torch.int64,
                                           _fm=None)
    return aligner


def _jax_positions(genome, kind, max_occ, max_mem_intv, monkeypatch):
    """tpubwa's DeviceAligner._seed_chunk in megaq on JAX-CPU (its fused
    SA, return_sa=True), once per index and options: rows and (pos, cnt)."""
    indexes, _, jreads, cache = genome
    key = (kind, max_occ, max_mem_intv)
    if key not in cache:
        with monkeypatch.context() as mp:
            mp.setenv("TPUBWA_SEED_MODE", "megaq")
            jal = JaxAligner(_opts(max_occ, max_mem_intv)[1],
                             indexes[kind][1], platform="cpu")
            assert jal.seed_mode == "megaq"
            (flat, counts), positions, _ = jal._seed_chunk(jreads)
        cache[key] = (np.asarray(flat), np.asarray(counts),
                      tuple(np.asarray(x) for x in positions))
    return cache[key]


def _per_read(flat, counts, pos, cnt):
    """Per read, the sorted (row, its positions) pairs: tpubwa's machine
    returns rows of equal (qb, qe) in its own order."""
    ends = np.cumsum(cnt)
    segs = [tuple(pos[e - c:e].tolist()) for e, c in zip(ends, cnt)]
    rows = list(zip(map(tuple, np.asarray(flat).tolist()), segs))
    bounds = np.concatenate([[0], np.cumsum(counts)])
    return [sorted(rows[a:b]) for a, b in zip(bounds[:-1], bounds[1:])]


class _Spy:
    """Counts K-sa's fused calls (smem.sa_lookup) and fails any call of
    the classic SA stage."""

    def __init__(self, monkeypatch, aligner):
        self.calls = []
        real = smem.sa_lookup

        def walk(didx, ranks):
            assert ranks.dtype == didx.idt
            self.calls.append(len(ranks))
            return real(didx, ranks)

        def host_stage(*a, **k):
            raise AssertionError("the classic SA stage ran")

        monkeypatch.setattr(smem, "sa_lookup", walk)
        monkeypatch.setattr(tp, "sa_positions_native", host_stage)
        monkeypatch.setattr(aligner, "_sa_positions", host_stage)


@pytest.mark.parametrize("max_mem_intv", [20, 0])
@pytest.mark.parametrize("max_occ", [None, 3, 0])
@pytest.mark.parametrize("idt", ["int32", "int64"])
@pytest.mark.parametrize("kind", ["marked", "stock"])
def test_fused_equals_classic_ref_and_tpubwa(genome, monkeypatch, kind,
                                             idt, max_occ, max_mem_intv):
    """The aligner's chunk in megaq takes every position from one K-sa
    call on device-built ranks (none at -c 0), and no host SA stage
    runs; the positions equal the classic stage's, ref.smem's row by
    row, and (``JAX_CASES``) tpubwa's fused ones."""
    indexes, reads, _, _ = genome
    fmi = indexes[kind][0]
    opt, _ = _opts(max_occ, max_mem_intv)
    aligner = _aligner(opt, fmi, idt, monkeypatch=monkeypatch)
    with monkeypatch.context() as mp:
        spy = _Spy(mp, aligner)
        (flat, counts), (pos, cnt), _ = aligner._seed_chunk(reads)
    assert pos.dtype == cnt.dtype == np.int64
    assert spy.calls == ([] if opt.max_occ == 0 else [len(pos)])
    assert len(cnt) == len(flat) > len(reads) and (cnt >= 0).all()
    if opt.max_occ == 3:
        assert (flat[:, 2] >= 6).any()       # a step of 2 or more
    if max_mem_intv == 0:
        assert len(flat) < 2 * len(reads)    # no round-3 rows
    want_pos, want_cnt = aligner._sa_positions((flat, None))
    assert np.array_equal(cnt, want_cnt) and np.array_equal(pos, want_pos)
    ref = [[p for p, _ in sa_positions(fmi, BwtIntv(*map(int, row)),
                                       opt.max_occ)]
           for row in flat] if opt.max_occ else [[] for _ in flat]
    assert cnt.tolist() == [len(r) for r in ref]
    assert pos.tolist() == [p for r in ref for p in r]
    if (kind, max_occ) not in JAX_CASES:
        return
    jflat, jcounts, (jpos, jcnt) = _jax_positions(
        genome, kind, max_occ, max_mem_intv, monkeypatch)
    assert np.array_equal(jcounts, counts)
    assert (_per_read(flat, counts, pos, cnt)
            == _per_read(jflat, jcounts, jpos, jcnt))


@pytest.mark.parametrize("kind", ["marked", "stock"])
def test_hybrid_takes_the_host_share_from_the_native_walk(genome,
                                                          monkeypatch, kind):
    """Hybrid on one device: the device share's rows come with K-sa's
    positions, the host share's with the native walk's on the marked
    index and with -1 on the stock one, which the aligner then walks
    through its classic stage; the chunk's positions equal the classic
    stage's on every row."""
    indexes, reads, _, _ = genome
    fmi = indexes[kind][0]
    opt = MemOpt()
    aligner = _aligner(opt, fmi, "int32", "hybrid", monkeypatch)
    aligner.hybrid = HybridSplit(f=0.5, auto=False, k_floor=4)
    arr, lens = aligner._pack(reads, 64)
    flat, frid, _, (cnt, pos) = smem.collect_intv_device(
        opt, aligner.didx, arr, lens, fmi, mode="hybrid",
        split=aligner.hybrid, return_sa=True)
    dev = frid < 32
    assert (cnt[dev] >= 0).all()
    assert ((cnt[~dev] == -1).all() if kind == "stock"
            else (cnt[~dev] >= 0).all())
    walked = []
    real = aligner._sa_positions

    def classic(intv):
        walked.append(len(intv[0]))
        return real(intv)

    monkeypatch.setattr(aligner, "_sa_positions", classic)
    (flat2, _), (pos2, cnt2), _ = aligner._seed_chunk(reads)
    assert np.array_equal(flat2, flat)
    assert walked == ([int((~dev).sum())] if kind == "stock" else [])
    want_pos, want_cnt = real((flat, None))
    assert np.array_equal(cnt2, want_cnt) and np.array_equal(pos2, want_pos)
    assert np.array_equal(cnt[cnt >= 0], want_cnt[cnt >= 0])


def test_count_mismatch_raises(genome, monkeypatch):
    """A fused count that is not bwa's subsampling of its row, or
    positions that do not fill the counts, raise; nothing recomputes."""
    indexes, reads, _, _ = genome
    opt = MemOpt()
    aligner = _aligner(opt, indexes["marked"][0], "int32",
                       monkeypatch=monkeypatch)
    real = tp.collect_intv_device

    for tamper in ("count", "positions"):
        def tampered(*a, **k):
            flat, frid, qd, (cnt, pos) = real(*a, **k)
            if tamper == "count":
                cnt = cnt.copy()
                cnt[len(cnt) // 2] += 1
            else:
                pos = pos[:-1]
            return flat, frid, qd, (cnt, pos)

        with monkeypatch.context() as mp:
            mp.setattr(tp, "collect_intv_device", tampered)
            _Spy(mp, aligner)
            with pytest.raises(RuntimeError, match="fused SA count mismatch"):
                aligner._seed_chunk(reads)


def test_no_sa_fuse_walks_on_the_host_and_keeps_the_sam(genome,
                                                        monkeypatch):
    """TPUBWA_NO_SA_FUSE=1 (tpubwa's opt-out): sa is None, the classic
    stage walks every row, and the SAM equals the fused run's."""
    indexes, reads, _, _ = genome
    fmi = indexes["marked"][0]
    opt = MemOpt()
    fused = _aligner(opt, fmi, "int32", monkeypatch=monkeypatch)
    sam = process_seqs(opt, fmi, reads, 0, align_fn=fused)
    monkeypatch.setenv("TPUBWA_NO_SA_FUSE", "1")
    plain = _aligner(opt, fmi, "int32", monkeypatch=monkeypatch)
    arr, lens = plain._pack(reads, 64)
    got = smem.collect_intv_device(opt, plain.didx, arr, lens, fmi,
                                   mode="megaq", return_sa=True)
    assert len(got) == 4 and got[3] is None
    walked = []
    real = plain._sa_positions

    def classic(intv):
        walked.append(len(intv[0]))
        return real(intv)

    monkeypatch.setattr(plain, "_sa_positions", classic)
    assert process_seqs(opt, fmi, reads, 0, align_fn=plain) == sam
    assert len(walked) == 1 and walked[0] > len(reads)
    assert len(sam) >= len(reads)


# ---------------------------------------------------------------------
# the pieces, as pure cases

@pytest.mark.parametrize("idt", [torch.int32, torch.int64])
@pytest.mark.parametrize("max_occ", [500, 3, 1, 0])
def test_sa_ranks_equal_the_subsampling(idt, max_occ):
    """sa_ranks against ref.smem's loop on sizes up to 10^6 (steps past
    2^31 / max_occ arithmetic in int64) and rows that are not kept."""
    rng = np.random.default_rng(11)
    n = 64
    rows = np.zeros((n, 5), np.int64)
    rows[:, 2] = np.concatenate([rng.integers(0, 12, n // 2),
                                 rng.integers(1, 10 ** 6, n // 2)])
    top = 2 ** 31 - 2 * 10 ** 6 if idt == torch.int32 else 2 ** 40
    rows[:, 0] = rng.integers(0, top, n)
    keep = rng.random(n) < 0.8
    cnt, ranks = sa_ranks(types.SimpleNamespace(idt=idt), torch.from_numpy(
        rows).to(idt), torch.from_numpy(keep), max_occ)
    assert cnt.dtype == torch.int64 and ranks.dtype == idt
    want = []
    for (x0, _, size, _, _), k in zip(rows.tolist(), keep):
        if not k or max_occ <= 0:
            want.append([])
            continue
        step = size // max_occ if size > max_occ else 1
        want.append([x0 + j for j in range(0, size, step)][:max_occ])
    assert cnt.tolist() == [len(w) for w in want]
    assert ranks.tolist() == [r for w in want for r in w]
    assert np.array_equal(sa_counts(rows[:, 2], max_occ)[1][keep],
                          cnt.numpy()[keep])


def test_merge_rounds_carries_the_segments():
    """The segments follow the stable lexsort by (rid, qb, qe), ties in
    their concatenation order, as tpubwa's _permute_segments."""
    rows12 = np.array([[10, 0, 2, 0, 30], [20, 0, 1, 40, 90],
                       [30, 0, 3, 0, 50]], np.int64)
    rids12 = np.array([0, 0, 1])
    hits = np.zeros((2, 2, 5), np.int64)
    hits[0, 0] = [40, 0, 2, 0, 30]       # ties K2's first row: after it
    hits[0, 1] = [50, 0, 1, 10, 45]
    hits[1, 0] = [99, 0, 9, 0, 1]        # past n_hits: not a row
    n_hits = np.array([2, 0])
    cnt = np.array([2, 1, 3, 2, 1])
    pos = np.array([100, 101, 200, 300, 301, 302, 400, 401, 500])
    flat, frid, (c2, p2) = smem.merge_rounds(rows12, rids12, hits, n_hits,
                                             sa=(cnt, pos))
    assert flat[:, 0].tolist() == [10, 40, 50, 20, 30]
    assert frid.tolist() == [0, 0, 0, 0, 1]
    assert c2.tolist() == [2, 2, 1, 1, 3]
    assert p2.tolist() == [100, 101, 400, 401, 500, 200, 300, 301, 302]
    with pytest.raises(RuntimeError, match="do not cover"):
        smem.merge_rounds(rows12, rids12, hits, n_hits, sa=(cnt, pos[1:]))

"""csrc/smem.cu's kernels (K2, rounds 1+2, a warp a read from a read
queue, and K3, round 3, a group of lanes a read from a read queue, over
csrc/smem.cuh and csrc/fm.cuh), compiled for the host against
csrc/warp_host.h under ASan/UBSan (csrc/smem_host.cpp), against their
plain versions (device/smem_fused.py:rounds12_plain, device/smem.py:
_seed_strategy_scan_plain) and, merged as mode megaq merges them,
against tpubwa's scalar oracle ref.smem.collect_intv.  K2 goes through
the wrapper's own two-launch protocol (smem_fused.collect12), with one
row slot a read too, so that most reads take the second launch, with
its warps' lanes in both orders; its rows, counts, bwt_extend steps and
chain (forward steps plus backward strips) a read must equal the plain
version's, also on reads whose backward stack passes a strip of 32
intervals inside a run of equal sizes, and on an index whose counts do
not nest, where a failing interval follows a survivor.  It refuses
reads too long for a block's shared memory.  K3's hits, counts, steps,
chain (one step a round of its group) and longest scan a read must
equal the plain version's in both lane orders, on reads with N at their
edges and inside a scan, reads no longer than min_seed_len, scans that
run to a read's end, max_mem_intv 0, chunks that leave a warp's last
groups without a read, and a grid capped so that groups take several
reads from the queue.  K-cur (seed mode cursor, a warp a job from a job
queue) through the same two-launch protocol == its plain version
(device/smem_cursor.py:run_smem_jobs_plain) on round-1 and round-2
jobs, at 64 and 1 row slots a job, in both lane orders, on the edge
reads of tests/test_smem_cursor.py, one-shot jobs at an N and past a
read's end, the run genome's strip edges and a capped grid; it refuses
reads too long for a block's shared memory, and its occ rows (the
smoke's bound) are the plain version's.  int32 and int64 ranks.
Tolerance 0.  What the GPU's compiler makes of the source shows only on
a card."""
import dataclasses

import numpy as np
import pytest
import torch

from tpubwa.ref.smem import collect_intv
from tpubwa_torch.device import smem, smem_cursor, smem_fused, warp_host
from tpubwa_torch.device.occ import DeviceIndex
from tpubwa_torch.index import FMIndex
from tpubwa_torch.index.build import BntSeq, SeqAnn
from tpubwa_torch.opts import MemOpt
from test_torch_smem import L, _pack, _sim_genome, _test_genome


@pytest.fixture(scope="module")
def genomes(tmp_path_factory):
    return {"test": _test_genome(tmp_path_factory.mktemp("tsmemh")),
            "sim1m": _sim_genome()}


def _didx(fmi, idt):
    didx = DeviceIndex.from_fmindex(fmi, "cpu")
    return didx if idt == "int32" else dataclasses.replace(
        didx, idt=torch.int64, _fm=None)


def host_arrays(didx):
    """The index mapping smem_host takes, from the port's index."""
    fm = didx.upload_fm()
    return {"occ_blocks": fm["occ_blocks"].numpy().view(np.uint32),
            "L2": fm["L2"].numpy(), "primary": didx.primary,
            "seq_len": didx.seq_len}


def params(opt):
    return (opt.min_seed_len, smem_fused.split_len_of(opt), opt.split_width,
            opt.max_mem_intv, smem.max_hits(L, opt.min_seed_len))


def k2_launch(didx, arr, lens, opt, reverse=False):
    """collect12's launch through the harness: K2's C entry on the host,
    each warp's lanes 31..0 where ``reverse``."""
    arrays = host_arrays(didx)

    def launch(rids, slots):
        rows, counts, steps, chain = warp_host.smem_host(
            arrays, arr, lens, 0, params(opt), rids=rids.numpy(), slots=slots,
            reverse=reverse)
        return (torch.from_numpy(rows).to(didx.idt),
                torch.from_numpy(counts).int(), torch.from_numpy(steps).int(),
                torch.from_numpy(chain).int())

    return launch


CASES = [(g, i) for g in ("test", "sim1m") for i in ("int32", "int64")]


@pytest.mark.parametrize("slots", [smem_fused.K2_SLOTS, 1])
@pytest.mark.parametrize("name,idt", CASES)
def test_k2_equals_plain(genomes, name, idt, slots):
    """K2 through the wrapper's launches == rounds12_plain, in order, with
    the same bwt_extend steps a read; with one slot a read the first
    launch's counts are still exact, and every read of more than one row
    takes the second launch."""
    fmi, _, reads = genomes[name]
    arr, lens = _pack(reads)
    opt = MemOpt()
    didx = _didx(fmi, idt)
    want_stats, stats = {}, {}
    want = smem_fused.rounds12_plain(opt, didx, torch.from_numpy(arr),
                                     torch.from_numpy(lens), stats=want_stats)
    launch = k2_launch(didx, arr, lens, opt)
    got = smem_fused.collect12(launch, len(reads), slots,
                               torch.device("cpu"), stats=stats)
    assert got[0].dtype == didx.idt
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert torch.equal(stats["steps"], want_stats["steps"])
    assert torch.equal(stats["chain"], want_stats["chain"])
    counts = torch.bincount(want[1], minlength=len(reads))
    assert stats["second_launch_reads"] == int((counts > slots).sum())
    if slots == 1:
        assert stats["second_launch_reads"] >= 4
        _, first_counts, _, _ = launch(torch.arange(len(reads),
                                                 dtype=torch.int32), 1)
        assert torch.equal(first_counts.long(), counts)


def held_to_plain(didx, arr, lens, opt, reverse):
    """K2 through the wrapper's launches on the host == rounds12_plain:
    rows, read ids, and each read's count, steps and chain.  Returns the
    plain version's stats."""
    want_stats, stats = {}, {}
    want = smem_fused.rounds12_plain(opt, didx, torch.from_numpy(arr),
                                     torch.from_numpy(lens), stats=want_stats)
    got = smem_fused.collect12(k2_launch(didx, arr, lens, opt, reverse),
                               len(lens), smem_fused.K2_SLOTS,
                               torch.device("cpu"), stats=stats)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    for key in ("steps", "chain"):
        assert torch.equal(stats[key], want_stats[key]), key
    return want_stats


@pytest.mark.parametrize("name,idt", CASES)
def test_k2_lanes_reversed(genomes, name, idt):
    """K2 with each warp's lanes run 31..0 == rounds12_plain: no lane
    reads what another writes before a __syncwarp."""
    fmi, _, reads = genomes[name]
    arr, lens = _pack(reads)
    held_to_plain(_didx(fmi, idt), arr, lens, MemOpt(), reverse=True)


A, C, G, T = 0, 1, 2, 3


@pytest.fixture(scope="module")
def run_genome():
    """A genome with a run of 70 A after C G, and elsewhere a 20-base
    unique P before G T; the reads P G A^k.  Round 1 stops P G at the A
    (P G occurs, P G A does not), so the next SMEM starts at the run's
    first A with G before it: its forward stack holds A^1..A^k (each
    step shrinks the run's count), and the backward step by G extends
    them all, G A^j occurring once (at the run's start) for every j
    past a few, so the survivors of equal size run across the strip edge
    at 32 (and 64) intervals."""
    rng = np.random.default_rng(5)
    p = rng.integers(0, 4, 20).astype(np.uint8)
    p[-1] = T  # the run's C G is not P's
    codes = np.concatenate([
        rng.integers(0, 4, 3000), [C, G], np.full(70, A), [T],
        rng.integers(0, 4, 1000), p, [G, T],
        rng.integers(0, 4, 1000)]).astype(np.uint8)
    fmi = FMIndex.build(BntSeq(l_pac=len(codes), anns=[SeqAnn(
        name="g", anno="", offset=0, length=len(codes), n_ambs=0)], ambs=[],
        seed=11, codes=codes))
    reads = [np.concatenate([p, [G], np.full(k, A)]).astype(np.uint8)
             for k in (40, 65)]
    return fmi, reads


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("idt", ["int32", "int64"])
def test_k2_strip_edge_in_equal_sizes(run_genome, idt, reverse):
    fmi, reads = run_genome
    arr, lens = _pack(reads)
    want = held_to_plain(_didx(fmi, idt), arr, lens, MemOpt(), reverse)
    assert want["widest"].tolist() == [40, 65]


def scrambled(fmi, idt, seed=9):
    """``fmi``'s index on the CPU with the BWT words of half its occ rows
    XORed with random bits: its counts no longer nest, so a longer
    match's extension can survive where a shorter one's fails."""
    didx = _didx(fmi, idt)
    occ = didx.upload_fm()["occ_blocks"].numpy().view(np.uint32)
    rng = np.random.default_rng(seed)
    pick = rng.random(len(occ)) < 0.5
    occ[pick, 4:] ^= rng.integers(0, 1 << 32, (int(pick.sum()), 8),
                                  dtype=np.uint64).astype(np.uint32)
    return didx


@pytest.mark.parametrize("idt", ["int32", "int64"])
def test_k2_failure_after_a_survivor_emits_nothing(run_genome, idt):
    """On an index whose counts do not nest a backward step's first
    failing interval can follow a survivor; the scalar loop emits nothing
    for it, and neither may the warp (both lane orders).  min_seed_len 5
    keeps the short rows such an emission would add."""
    fmi, _ = run_genome
    didx = scrambled(fmi, idt)
    text = fmi.bnt.doubled()
    rng = np.random.default_rng(9)
    reads = [text[s:s + 100].copy()
             for s in rng.integers(0, len(text) - 100, 8)]
    arr, lens = _pack(reads)
    for reverse in (False, True):
        want = held_to_plain(didx, arr, lens, MemOpt(min_seed_len=5),
                             reverse)
    assert int(want["late"].sum()) >= 4


@pytest.mark.parametrize("idt", ["int32", "int64"])
def test_k2_refuses_reads_too_long_for_shared_memory(run_genome, idt):
    """K2 keeps 4 (L + 1) intervals a warp in shared memory: at the
    longest L an H100 block holds it == plain, one base more and the
    entry refuses before anything runs."""
    fmi, reads = run_genome
    didx = _didx(fmi, idt)
    most = smem_fused.k2_max_len(didx.idt)
    assert most == {"int32": 2904, "int64": 1451}[idt]
    text = fmi.bnt.doubled()
    read = np.tile(text[:700], 5)[:most]
    arr = np.full((1, most), 4, np.uint8)
    arr[0] = read
    lens = np.array([most], np.int32)
    held_to_plain(didx, arr, lens, MemOpt(), reverse=False)
    wide = np.full((1, most + 1), 4, np.uint8)
    wide[0, :most] = read
    with pytest.raises(RuntimeError, match="kernel 0 returned 1"):
        warp_host.smem_host(host_arrays(didx), wide, lens, 0,
                            params(MemOpt()), slots=smem_fused.K2_SLOTS)


def k3_held_to_plain(didx, arr, lens, opt, reverse=False, card=(0, 0)):
    """K3's C entry on the host == _seed_strategy_scan_plain: hits,
    n_hits, steps and longest scan a read, and chain == steps (a group
    makes one step a round).  Returns the plain version's (n_hits,
    stats)."""
    stats = {}
    hits, n_hits = smem._seed_strategy_scan_plain(
        didx, torch.from_numpy(arr), torch.from_numpy(lens),
        opt.min_seed_len, opt.max_mem_intv, stats=stats)
    got, got_n, steps, chain, longest = warp_host.smem_host(
        host_arrays(didx), arr, lens, 1, params(opt), reverse=reverse,
        card=card)
    assert np.array_equal(got, hits.numpy())
    assert np.array_equal(got_n, n_hits.numpy())
    assert np.array_equal(steps, stats["steps"].numpy())
    assert np.array_equal(chain, steps)
    assert np.array_equal(longest, stats["longest"].numpy())
    return n_hits, stats


@pytest.mark.parametrize("name,idt", CASES)
def test_k3_equals_plain(genomes, name, idt):
    fmi, _, reads = genomes[name]
    arr, lens = _pack(reads)
    n_hits, _ = k3_held_to_plain(_didx(fmi, idt), arr, lens, MemOpt())
    assert n_hits.sum() > 0


@pytest.mark.parametrize("name,idt", CASES)
def test_k3_lanes_reversed(genomes, name, idt):
    """K3 with each warp's lanes run 31..0 == plain: the group's sums do
    not depend on the order its lanes arrive in."""
    fmi, _, reads = genomes[name]
    arr, lens = _pack(reads)
    k3_held_to_plain(_didx(fmi, idt), arr, lens, MemOpt(), reverse=True)


def k3_edge_reads(fmi, run_reads, kind):
    """(reads, opt) of one edge of K3's loop (min_seed_len 19)."""
    text = fmi.bnt.doubled()
    rng = np.random.default_rng(17)
    win = [text[s:s + 100].copy()
           for s in rng.integers(0, len(text) - 100, 6)]
    opt = MemOpt()
    if kind == "n-at-start":
        reads = [np.concatenate([[4, 4], w[:98]]) for w in win]
        reads.append(np.concatenate([[4], win[0][:40], [4, 4], win[1][:50]]))
    elif kind == "n-at-end":
        reads = [np.concatenate([w[:97], [4]]) for w in win]
        reads.append(np.concatenate([win[2][:60], [4, 4, 4]]))
    elif kind == "n-inside-a-scan":
        # an N 5, 10 and 18 bases into the first scan, and one after a hit
        reads = []
        for j, w in enumerate(win):
            w = w.copy()
            w[[5, 10, 18, 45][j % 4]] = 4
            reads.append(w)
    elif kind == "no-longer-than-min-len":
        reads = [win[0][:0], win[1][:1], win[2][:19], win[3][:20],
                 win[4][:21], np.full(19, 4, np.uint8)]
    elif kind == "scan-to-the-end":
        reads = list(run_reads)
    elif kind == "max-intv-0":
        reads, opt = win, MemOpt(max_mem_intv=0)
    elif kind == "fewer-reads-than-groups":
        reads = win[:5]  # no multiple of 2, 4 or 32 reads a warp
    return [np.asarray(r, np.uint8) for r in reads], opt


K3_EDGES = ["n-at-start", "n-at-end", "n-inside-a-scan",
            "no-longer-than-min-len", "scan-to-the-end", "max-intv-0",
            "fewer-reads-than-groups"]


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("kind", K3_EDGES)
def test_k3_edges(genomes, run_genome, kind, reverse):
    """K3 == plain on reads that take each path of its lockstep loop:
    a restart past N (no step), a scan ended by an N, reads too short
    for a hit, a scan that runs to the read's end in a run of A (the
    run genome, whose own index it uses), no hit at all, and a launch
    whose last warp has groups with no read."""
    if kind == "scan-to-the-end":
        fmi, reads = run_genome
    else:
        fmi = genomes["test"][0]
    reads, opt = k3_edge_reads(fmi, run_genome[1], kind)
    arr, lens = _pack(reads)
    for idt in ("int32", "int64"):
        n_hits, stats = k3_held_to_plain(_didx(fmi, idt), arr, lens, opt,
                                         reverse=reverse)
    if kind == "max-intv-0":
        assert n_hits.sum() == 0 and stats["steps"].sum() > 0
    if kind == "scan-to-the-end":  # a scan reaches the read's last base
        assert bool((stats["longest"] > 40).any())
    if kind == "no-longer-than-min-len":
        assert n_hits[:3].sum() == 0 and n_hits[4] == 1


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("idt", ["int32", "int64"])
def test_k3_capped_grid_takes_reads_from_the_queue(genomes, idt, reverse):
    """On a card of one SM holding one block (128 threads: at most 128
    groups), K3's groups take reads from the read queue as theirs end:
    160 reads, == plain."""
    fmi = genomes["sim1m"][0]
    text = fmi.bnt.doubled()
    rng = np.random.default_rng(23)
    reads = [text[s:s + 100].copy()
             for s in rng.integers(0, len(text) - 100, 160)]
    for r in reads[:40]:
        r[rng.integers(0, 100, 2)] = 4
    arr, lens = _pack(reads)
    k3_held_to_plain(_didx(fmi, idt), arr, lens, MemOpt(), reverse=reverse,
                     card=(1, 1))


def test_k3_fast_build_equals_the_sanitized_one(genomes):
    """smem_host without the sanitizers (as chip_smoke.py counts the occ
    rows of 5c's K3 launch with it) == the sanitized build: K3's hits,
    counts, steps, chain, longest scan and the occ rows it reads."""
    fmi, _, reads = genomes["sim1m"]
    arr, lens = _pack(reads)
    arrays, p = host_arrays(_didx(fmi, "int32")), params(MemOpt())
    got, want = (warp_host.smem_host(arrays, arr, lens, 1, p,
                                     count_rows=True, sanitize=s)
                 for s in (False, True))
    assert all(np.array_equal(a, b) for a, b in zip(got, want))
    assert len(got) == 6 and len(got[-1]) > 0


@pytest.mark.parametrize("max_mem_intv", [20, 0])
@pytest.mark.parametrize("name", ["test", "sim1m"])
def test_kernels_merged_equal_the_oracle(genomes, name, max_mem_intv):
    """K2's and K3's host runs merged as mode megaq merges them ==
    tpubwa's ref.smem.collect_intv, read by read, in order."""
    fmi, jfmi, reads = genomes[name]
    arr, lens = _pack(reads)
    opt = MemOpt(max_mem_intv=max_mem_intv)
    didx = _didx(fmi, "int32")
    rows12 = smem_fused.collect12(k2_launch(didx, arr, lens, opt), len(reads),
                                  smem_fused.K2_SLOTS, torch.device("cpu"))
    round3 = ()
    if max_mem_intv > 0:
        round3 = warp_host.smem_host(host_arrays(didx), arr, lens, 1,
                                     params(opt))[:2]
    flat, frid = smem.merge_rounds(*rows12, *round3)
    for i, r in enumerate(reads):
        want = [(m.x0, m.x1, m.size, m.qb, m.qe)
                for m in collect_intv(opt, jfmi, r)]
        assert list(map(tuple, flat[frid == i].tolist())) == want, i


def test_rows_read_are_the_plain_versions(genomes, monkeypatch):
    """count_rows (chip_smoke.py's bytes bound) reports the distinct occ
    rows K2 and K3 read: those of the plain versions' extensions."""
    fmi, _, reads = genomes["sim1m"]
    arr, lens = _pack(reads)
    opt = MemOpt()
    didx = _didx(fmi, "int32")
    seen = []
    plain = smem_fused.bwt_extend_plain

    def spy(didx, ik, is_back, stats=None):
        stats = {}
        out = plain(didx, ik, is_back, stats)
        seen.append(stats["occ_rows"])
        return out

    monkeypatch.setattr(smem_fused, "bwt_extend_plain", spy)
    q, ld = torch.from_numpy(arr), torch.from_numpy(lens)
    for kernel in (0, 1):
        seen.clear()
        if kernel == 0:
            smem_fused.rounds12_plain(opt, didx, q, ld)
        else:
            smem._seed_strategy_scan_plain(didx, q, ld, opt.min_seed_len,
                                           opt.max_mem_intv)
        want = np.unique(torch.cat(seen).numpy())
        *_, rows = warp_host.smem_host(
            host_arrays(didx), arr, lens, kernel, params(opt),
            slots=smem_fused.K2_SLOTS, count_rows=True)
        assert np.array_equal(rows, want)
        assert 0 < len(rows) < len(host_arrays(didx)["occ_blocks"])


def test_fast_build_equals_the_sanitized_one(genomes):
    """smem_host without the sanitizers (its lanes switched by _longjmp,
    as chip_smoke.py counts a chunk's rows with it) == the sanitized
    build (swapcontext): K2's rows, counts, steps and chain, and the
    occ rows it reads."""
    fmi, _, reads = genomes["sim1m"]
    arr, lens = _pack(reads)
    arrays, p = host_arrays(_didx(fmi, "int32")), params(MemOpt())
    got, want = (warp_host.smem_host(arrays, arr, lens, 0, p,
                                     slots=smem_fused.K2_SLOTS,
                                     count_rows=True, sanitize=s)
                 for s in (False, True))
    assert all(np.array_equal(a, b) for a, b in zip(got, want))
    assert len(got) == 5 and len(got[-1]) > 0


def test_k2_forms_edit_the_sources_once():
    """scripts/exp_k2_forms.py's forms are the sources with named edits,
    each of which must find its text exactly once (the script refuses
    otherwise, on the card)."""
    from tpubwa_torch.device import _build
    from tpubwa_torch.scripts import exp_k2_forms
    assert exp_k2_forms.FORMS["current"] == []
    for form, edits in exp_k2_forms.FORMS.items():
        for name, old, new in edits:
            text = (_build.CSRC / name).read_text()
            assert name in exp_k2_forms.SOURCES, form
            assert text.count(old) == 1 and new not in text, (form, old)


def test_k3_forms_edit_the_sources_once():
    """scripts/exp_k3_forms.py's forms are the sources with named edits,
    each of which must find its text exactly once (the script refuses
    otherwise, on the card); the form the package ships has none."""
    from tpubwa_torch.device import _build
    from tpubwa_torch.scripts import exp_k3_forms
    assert exp_k3_forms.FORMS[exp_k3_forms.SHIPPED] == []
    assert set(exp_k3_forms.FORMS) == {"thread", "g4", "g8", "g16", "g32"}
    for form, edits in exp_k3_forms.FORMS.items():
        for name, old, new in edits:
            text = (_build.CSRC / name).read_text()
            assert name in exp_k3_forms.SOURCES, form
            assert text.count(old) == 1 and new not in text, (form, old)


# --------------------------------------------------------------- K-cur
def kcur_launch(didx, arr, lens, jobs, opt, reverse=False, card=(0, 0),
                sanitize=True):
    """collect12's launch through the harness: K-cur's C entry
    (``tpubwa_smem_jobs``) on the host over ``jobs``."""
    arrays = host_arrays(didx)
    jobs = [x.numpy() for x in jobs]

    def launch(ids, slots):
        rows, counts, steps, chain = warp_host.smem_host(
            arrays, arr, lens, 2, params(opt), rids=ids.numpy(), slots=slots,
            jobs=jobs, reverse=reverse, card=card, sanitize=sanitize)
        return (torch.from_numpy(rows).to(didx.idt),
                *(torch.from_numpy(x).int() for x in (counts, steps, chain)))

    return launch


def kcur_plain(didx, arr, lens, jobs, opt):
    """The plain version (smem_cursor.run_smem_jobs_plain) on ``jobs``:
    (rows, counts, stats)."""
    stats = {}
    rows, counts = smem_cursor.run_smem_jobs_plain(
        didx, torch.from_numpy(arr), torch.from_numpy(lens), jobs,
        opt.min_seed_len, stats=stats)
    return rows, counts, stats


def kcur_held_to_plain(didx, arr, lens, jobs, opt, slots=smem_fused.K2_SLOTS,
                       reverse=False, card=(0, 0), want=None):
    """K-cur through the wrapper's launches on the host == the plain
    version (``want``, ``kcur_plain``'s on these jobs where given, else
    run here): rows, each job's count, steps and chain.  Returns (the
    plain version's counts, the launches' stats)."""
    stats = {}
    want_rows, want_counts, want_stats = (
        want or kcur_plain(didx, arr, lens, jobs, opt))
    rows, job = smem_fused.collect12(
        kcur_launch(didx, arr, lens, jobs, opt, reverse, card),
        len(jobs[0]), slots, torch.device("cpu"), stats=stats)
    assert rows.dtype == didx.idt and torch.equal(rows, want_rows)
    assert torch.equal(torch.bincount(job, minlength=len(jobs[0])).int(),
                       want_counts)
    for key in ("steps", "chain"):
        assert torch.equal(stats[key], want_stats[key]), key
    return want_counts, stats


def cursor_jobs(didx, arr, lens, opt):
    """Mode cursor's two job sets on these reads, each with the plain
    version's (rows, counts, stats) on it: [(round-1 jobs, plain), (the
    round-2 jobs of the plain round-1 rows, plain)]."""
    r1 = smem_cursor.round1_jobs(len(lens), didx.idt, "cpu")
    p1 = kcur_plain(didx, arr, lens, r1, opt)
    r2 = smem_cursor.round2_jobs(opt, *p1[:2])
    return [(r1, p1), (r2, kcur_plain(didx, arr, lens, r2, opt))]


@pytest.fixture(scope="module")
def cursor_cases(genomes):
    """``cursor_jobs`` on each genome's reads in each rank type, run once
    for the tests that hold K-cur to them: {(name, idt): (didx, arr,
    lens, [(jobs, plain)] a round)}."""
    cache = {}

    def get(name, idt):
        if (name, idt) not in cache:
            fmi, _, reads = genomes[name]
            arr, lens = _pack(reads)
            didx = _didx(fmi, idt)
            cache[name, idt] = (didx, arr, lens,
                                cursor_jobs(didx, arr, lens, MemOpt()))
        return cache[name, idt]
    return get


@pytest.mark.parametrize("slots", [smem_fused.K2_SLOTS, 1])
@pytest.mark.parametrize("name,idt", CASES)
def test_kcur_equals_plain(cursor_cases, name, idt, slots):
    """K-cur on round-1 and round-2 jobs == its plain version, with the
    same steps and chain a job; at one row slot a job the first launch's
    counts are exact and every job of more rows takes the second."""
    didx, arr, lens, rounds = cursor_cases(name, idt)
    for jobs, want in rounds:
        counts, stats = kcur_held_to_plain(didx, arr, lens, jobs, MemOpt(),
                                           slots, want=want)
        assert stats["second_launch_reads"] == int((counts > slots).sum())
        assert len(counts) > 0 and int(counts.sum()) > 0
    if slots == 1:
        assert stats["second_launch_reads"] >= 1


@pytest.mark.parametrize("name,idt", CASES)
def test_kcur_lanes_reversed(cursor_cases, name, idt):
    """K-cur with each warp's lanes run 31..0 == plain: no lane reads
    what another writes before a __syncwarp."""
    didx, arr, lens, rounds = cursor_cases(name, idt)
    for jobs, want in rounds:
        kcur_held_to_plain(didx, arr, lens, jobs, MemOpt(), reverse=True,
                           want=want)


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("idt", ["int32", "int64"])
def test_kcur_edges(genomes, run_genome, idt, reverse):
    """K-cur == plain on the edge reads of tests/test_smem_cursor.py
    (:141-175: shorter than min_seed_len, all N, N at the cursor's start,
    a full 128-base match), an empty read, N at a read's end, and one-shot
    jobs at an N, at the read's end and past it (no rows), at x0 0 and
    at min_intv 3; and on the run genome's reads, whose backward stack
    passes a strip of 32 intervals inside a run of equal sizes."""
    fmi = genomes["test"][0]
    text = fmi.bnt.doubled()
    reads = [text[100:110].copy(), np.full(60, 4, np.uint8),
             np.concatenate([[4, 4], text[200:300]]), text[500:628].copy(),
             text[:0].copy(), np.concatenate([text[800:897], [4, 4, 4]])]
    arr, lens = _pack([np.asarray(r, np.uint8) for r in reads])
    didx = _didx(fmi, idt)
    (r1, want), _ = cursor_jobs(didx, arr, lens, MemOpt())
    counts, _ = kcur_held_to_plain(didx, arr, lens, r1, MemOpt(),
                                   reverse=reverse, want=want)
    assert counts[[0, 1, 4]].tolist() == [0, 0, 0] and counts[3] > 0
    # one-shot: at an N, at the end, past it, x0 0, a round-2 min_intv
    one = (torch.tensor([2, 5, 3, 3, 3, 3], dtype=torch.int32),
           torch.tensor([0, 97, 128, 0, 64, 64], dtype=torch.int32),
           torch.tensor([1, 1, 1, 1, 1, 3], dtype=didx.idt),
           torch.ones(6, dtype=torch.bool))
    arr[3, :] = text[500:628]
    counts, _ = kcur_held_to_plain(didx, arr, lens, one, MemOpt(),
                                   reverse=reverse)
    assert counts[:3].tolist() == [0, 0, 0] and counts[3] > 0
    fmi, reads = run_genome
    arr, lens = _pack(reads)
    didx = _didx(fmi, idt)
    for jobs, want in cursor_jobs(didx, arr, lens, MemOpt()):
        kcur_held_to_plain(didx, arr, lens, jobs, MemOpt(), reverse=reverse,
                           want=want)


@pytest.mark.parametrize("idt", ["int32", "int64"])
def test_kcur_capped_grid_takes_jobs_from_the_queue(cursor_cases, idt):
    """On a card of one SM holding one block (at most 4 warps), K-cur's
    warps take job after job from the queue: 40 round-1 jobs, == plain,
    in both lane orders."""
    didx, arr, lens, ((r1, want), _) = cursor_cases("sim1m", idt)
    for reverse in (False, True):
        kcur_held_to_plain(didx, arr, lens, r1, MemOpt(), reverse=reverse,
                           card=(1, 1), want=want)


@pytest.mark.parametrize("idt", ["int32", "int64"])
def test_kcur_refuses_reads_too_long_for_shared_memory(run_genome, idt):
    """K-cur keeps 3 (L + 1) intervals a warp in shared memory: at the
    longest L an H100 block holds it == plain, one base more and the
    entry refuses before anything runs."""
    fmi, _ = run_genome
    didx = _didx(fmi, idt)
    most = smem_cursor.kcur_max_len(didx.idt)
    assert most == {"int32": 3873, "int64": 1936}[idt]
    read = np.tile(fmi.bnt.doubled()[:700], 6)[:most]
    arr = read[None, :].copy()
    lens = np.array([most], np.int32)
    r1 = smem_cursor.round1_jobs(1, didx.idt, "cpu")
    kcur_held_to_plain(didx, arr, lens, r1, MemOpt())
    wide = np.full((1, most + 1), 4, np.uint8)
    wide[0, :most] = read
    with pytest.raises(RuntimeError, match="kernel 2 returned 1"):
        warp_host.smem_host(host_arrays(didx), wide, lens, 2,
                            params(MemOpt()), slots=smem_fused.K2_SLOTS,
                            jobs=[x.numpy() for x in r1])
    with pytest.raises(RuntimeError, match=f"at most {most} bases"):
        smem_cursor.run_smem_jobs(didx, torch.from_numpy(wide),
                                  torch.from_numpy(lens), r1, 19)


def test_kcur_rows_read_are_the_plain_versions(genomes, monkeypatch):
    """count_rows (chip_smoke.py's bytes bound for K-cur) reports the
    distinct occ rows K-cur reads on round-1 jobs: those of the plain
    version's extensions; and the build without the sanitizers (as the
    smoke counts a chunk's rows) == the sanitized one."""
    fmi, _, reads = genomes["sim1m"]
    arr, lens = _pack(reads)
    opt = MemOpt()
    didx = _didx(fmi, "int32")
    r1 = smem_cursor.round1_jobs(len(lens), didx.idt, "cpu")
    seen = []
    plain = smem_fused.bwt_extend_plain

    def spy(didx, ik, is_back, stats=None):
        stats = {}
        out = plain(didx, ik, is_back, stats)
        seen.append(stats["occ_rows"])
        return out

    monkeypatch.setattr(smem_fused, "bwt_extend_plain", spy)
    smem_cursor.run_smem_jobs_plain(didx, torch.from_numpy(arr),
                                    torch.from_numpy(lens), r1,
                                    opt.min_seed_len)
    want = np.unique(torch.cat(seen).numpy())
    got, fast = (warp_host.smem_host(
        host_arrays(didx), arr, lens, 2, params(opt),
        slots=smem_fused.K2_SLOTS, jobs=[x.numpy() for x in r1],
        count_rows=True, sanitize=s) for s in (True, False))
    assert np.array_equal(got[-1], want) and 0 < len(want)
    assert len(got) == 5 and all(np.array_equal(a, b)
                                 for a, b in zip(got, fast))

"""csrc/smem.cu's K-fwd and K-bwd (seed mode split: bwt_smem1a's forward
passes a group of lanes a job, several jobs a warp in lockstep, from a
job queue, and their backward passes a warp a recorded call from a call
queue: the two halves of csrc/smem.cuh:smem1a) compiled for the host
against csrc/warp_host.h under ASan/UBSan (csrc/smem_host.cpp), against
K-cur's plain version (device/smem_cursor.py:run_smem_jobs_plain) and
the halves' own plain versions (device/smem_split.py), with K-fwd in two
forms: the shipped one and g32 (a warp a job, the first design's layout;
``warp_host.SPLIT_FORMS``).

K-fwd goes through the wrapper's two-launch protocol
(``smem_split.collect_calls``), also at one stack interval a job, so
that every job of more takes the second launch; K-bwd runs on every call
K-fwd recorded, its rows sized by the calls' stack sizes.  Merged, their
rows and each job's count, steps and chain equal K-cur's plain
version's, K-fwd's calls and stacks and K-bwd's rows equal the plain
halves', each with its steps and chain, on round-1 and round-2 jobs,
with each warp's lanes in both orders, on a grid capped so that groups
take several jobs and warps several calls from the queues, on the edge
reads of tests/test_smem_cursor.py (N bases, one-shot jobs), the run
genome's backward stacks of 40 and 65 intervals (past a strip of 32),
and warps whose groups end at different turns; K-bwd writes at most m
rows a call.  K-bwd refuses reads too long for a block's shared memory,
K-fwd takes them, and the occ rows each reads (the smoke's bound) are
the plain halves'.  int32 and int64 ranks.  K-cur's smem1a keeps its own
body (so that K2's, K2-tp's and K-cur's SASS stay as they were), and the
halves repeat its phases: K-cur itself runs on the harness beside them.
Tolerance 0.  What the GPU's compiler makes of the source shows only on
a card."""
import numpy as np
import pytest
import torch

from tpubwa_torch.device import smem_cursor, smem_fused, smem_split, warp_host
from tpubwa_torch.opts import MemOpt
from test_torch_smem import _pack
from test_torch_smem_host import (CASES, _didx, cursor_jobs,  # noqa: F401
                                  cursor_cases, genomes, host_arrays,
                                  kcur_launch, run_genome)

FORMS = ("shipped", "g32")


@pytest.fixture(scope="module")
def form_csrc(tmp_path_factory):
    """{form: its sources}: the package's for the shipped form, an edited
    copy for another (``warp_host.form_sources``), written once."""
    cache = {"shipped": warp_host.CSRC}

    def get(form):
        if form not in cache:
            cache[form] = warp_host.form_sources(
                form, tmp_path_factory.mktemp(form))
        return cache[form]
    return get


@pytest.fixture(scope="module")
def halves():
    """The plain halves on a set of jobs, run once a key: (K-fwd's calls
    and stats, K-bwd's rows, counts and stats)."""
    cache = {}

    def get(key, didx, arr, lens, jobs):
        if key not in cache:
            q, ld = torch.from_numpy(arr), torch.from_numpy(lens)
            fst, bst = {}, {}
            calls = smem_split.run_fwd_plain(didx, q, ld, jobs, stats=fst)
            rows, n = smem_split.run_bwd_plain(
                didx, q, ld, *smem_split.bwd_calls(jobs, calls), calls.stack,
                19, stats=bst)
            cache[key] = (calls, fst, rows, n, bst)
        return cache[key]
    return get


def split_host(didx, arr, lens, jobs, slots=smem_split.FWD_SLOTS,
               reverse=False, card=(0, 0), csrc=warp_host.CSRC):
    """K-fwd through collect_calls on the host, then K-bwd on the host
    over every call: (rows, counts a job, steps a job, chain a job, the
    calls, K-fwd's stats, K-bwd's (counts, steps, chain) a call)."""
    arrays = host_arrays(didx)
    njobs = [x.numpy() for x in jobs]

    def launch(ids, width):
        got = warp_host.fwd_host(arrays, arr, lens, njobs, width,
                                 ids=ids.numpy(), reverse=reverse, card=card,
                                 csrc=csrc)
        return (torch.from_numpy(got[0]).to(didx.idt),
                *(torch.from_numpy(x).int() for x in got[1:]))

    fst = {}
    calls = smem_split.collect_calls(launch, len(jobs[0]), slots,
                                     torch.device("cpu"), stats=fst)
    bcalls = smem_split.bwd_calls(jobs, calls)
    rows, counts, steps, chain = (torch.from_numpy(x) for x in
                                  warp_host.bwd_host(
                                      arrays, arr, lens,
                                      [x.numpy() for x in bcalls],
                                      calls.stack.numpy(), 19,
                                      reverse=reverse, card=card))
    per_job = [torch.zeros(len(jobs[0]), dtype=torch.int64).index_add_(
        0, calls.job, x) for x in (counts, steps, chain)]
    rows = smem_split.call_rows(rows.to(didx.idt), counts.int(), calls.m)
    return (rows, per_job[0].int(), fst["steps"].long() + per_job[1],
            fst["chain"].long() + per_job[2], calls, fst,
            (counts, steps, chain))


def held_to_kcur(didx, arr, lens, jobs, want, plain, kcur=False,
                 csrc=warp_host.CSRC, **kw):
    """``split_host`` == K-cur's plain (rows, counts, stats) ``want`` and,
    with ``kcur``, == K-cur itself on the harness (csrc/smem.cuh:smem1a,
    whose phases the halves repeat): rows in order, each job's count,
    steps and chain; == the plain halves ``plain`` (``halves``): K-fwd's
    calls, stacks, steps and chain, K-bwd's rows, counts, steps and
    chain; at most m rows a call.  Returns (the calls, K-fwd's
    stats)."""
    (rows, counts, steps, chain, calls, fst,
     (bn, bsteps, bchain)) = split_host(didx, arr, lens, jobs, csrc=csrc,
                                        **kw)
    want_rows, want_counts, want_stats = want
    pcalls, pfst, prows, pn, pbst = plain
    if kcur:
        kst = {}
        krows, kjob = smem_fused.collect12(
            kcur_launch(didx, arr, lens, jobs, MemOpt(),
                        kw.get("reverse", False), kw.get("card", (0, 0))),
            len(jobs[0]), smem_fused.K2_SLOTS, torch.device("cpu"),
            stats=kst)
        assert torch.equal(rows, krows)
        assert torch.equal(counts, torch.bincount(
            kjob, minlength=len(jobs[0])).int())
        assert torch.equal(steps, kst["steps"].long())
        assert torch.equal(chain, kst["chain"].long())
    assert rows.dtype == didx.idt and torch.equal(rows, want_rows)
    assert torch.equal(counts, want_counts)
    assert torch.equal(steps, want_stats["steps"].long())
    assert torch.equal(chain, want_stats["chain"].long())
    for key in ("job", "x", "m", "ret", "stack"):
        assert torch.equal(getattr(calls, key), getattr(pcalls, key)), key
    for key in ("steps", "chain"):
        assert torch.equal(fst[key], pfst[key]), key
    assert torch.equal(bn.int(), pn) and torch.equal(rows, prows)
    assert torch.equal(bsteps.int(), pbst["steps"])
    assert torch.equal(bchain.int(), pbst["chain"])
    assert bool((bn <= calls.m.long()).all())
    return calls, fst


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("slots", [smem_split.FWD_SLOTS, 1])
@pytest.mark.parametrize("name,idt", CASES)
@pytest.mark.parametrize("form", FORMS)
def test_split_equals_kcur(cursor_cases, form_csrc, halves, form, name, idt,
                           slots, reverse):
    """K-fwd then K-bwd on round-1 and round-2 jobs == K-cur's plain
    version and the plain halves, in both lane orders, and == K-cur on
    the harness (smem1a itself) at FWD_SLOTS in the shipped form; at one
    stack interval a job every job that pushed more takes the second
    launch, with exact counts."""
    didx, arr, lens, rounds = cursor_cases(name, idt)
    csrc = form_csrc(form)
    for r, (jobs, want) in enumerate(rounds):
        plain = halves((name, idt, r), didx, arr, lens, jobs)
        calls, fst = held_to_kcur(
            didx, arr, lens, jobs, want, plain, slots=slots, reverse=reverse,
            kcur=slots > 1 and form == "shipped", csrc=csrc)
        per_job = torch.bincount(calls.job, weights=calls.m.double(),
                                 minlength=len(jobs[0]))
        assert fst["second_launch_jobs"] == int((per_job > slots).sum())
    if slots == 1:
        assert fst["second_launch_jobs"] >= 1


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("idt", ["int32", "int64"])
@pytest.mark.parametrize("form", FORMS)
def test_split_edges(genomes, run_genome, form_csrc, form, idt, reverse):
    """K-fwd and K-bwd == K-cur's plain version and the plain halves on
    the edge reads of tests/test_smem_cursor.py (:141-175: shorter than
    min_seed_len, all N, N at the cursor's start, a full 128-base
    match), an empty read, N at a read's end, one-shot jobs at an N, at
    the read's end and past it (no call), at x0 0 and at min_intv 3, and
    the run genome's reads (backward stacks of 40 and 65 intervals, past
    a strip, of equal sizes across the strip edges), on a grid of one SM
    holding one block, whose groups take several jobs and calls from the
    queues."""
    csrc = form_csrc(form)

    def held(didx, arr, lens, jobs, want, **kw):
        plain = smem_split.run_fwd_plain(
            didx, torch.from_numpy(arr), torch.from_numpy(lens), jobs,
            stats=(fst := {}))
        rows, n = smem_split.run_bwd_plain(
            didx, torch.from_numpy(arr), torch.from_numpy(lens),
            *smem_split.bwd_calls(jobs, plain), plain.stack, 19,
            stats=(bst := {}))
        return held_to_kcur(didx, arr, lens, jobs, want,
                            (plain, fst, rows, n, bst), reverse=reverse,
                            csrc=csrc, **kw)

    fmi = genomes["test"][0]
    text = fmi.bnt.doubled()
    reads = [text[100:110].copy(), np.full(60, 4, np.uint8),
             np.concatenate([[4, 4], text[200:300]]), text[500:628].copy(),
             text[:0].copy(), np.concatenate([text[800:897], [4, 4, 4]])]
    arr, lens = _pack([np.asarray(r, np.uint8) for r in reads])
    didx = _didx(fmi, idt)
    for jobs, want in cursor_jobs(didx, arr, lens, MemOpt()):
        held(didx, arr, lens, jobs, want, card=(1, 1), kcur=True)
    one = (torch.tensor([2, 5, 3, 3, 3, 3], dtype=torch.int32),
           torch.tensor([0, 97, 128, 0, 64, 64], dtype=torch.int32),
           torch.tensor([1, 1, 1, 1, 1, 3], dtype=didx.idt),
           torch.ones(6, dtype=torch.bool))
    want = smem_cursor.run_smem_jobs_plain(
        didx, torch.from_numpy(arr), torch.from_numpy(lens), one, 19,
        stats=(st := {}))
    calls, _ = held(didx, arr, lens, one, (*want, st))
    assert calls.job.tolist() == [3, 4, 5] and want[1][3] > 0
    fmi, reads = run_genome
    arr, lens = _pack(reads)
    didx = _didx(fmi, idt)
    for jobs, want in cursor_jobs(didx, arr, lens, MemOpt()):
        calls, _ = held(didx, arr, lens, jobs, want, kcur=True)
        assert int(calls.m.max()) > 32


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("idt", ["int32", "int64"])
def test_split_groups_end_at_different_turns(genomes, idt, reverse):
    """A warp's groups take jobs and calls of very different lengths (an
    empty read, one base, a 10-base read, all N, 40 and 128 bases, reads
    with N inside), so that they end at different turns and take the
    next from the queue while the others step on, on a grid of one block
    (16 groups of 8 lanes, fewer than the jobs): == K-cur's plain version
    and the plain halves."""
    fmi = genomes["test"][0]
    text = fmi.bnt.doubled()
    rng = np.random.default_rng(27)
    reads = []
    for k in range(48):
        s = int(rng.integers(0, len(text) - 160))
        r = text[s:s + [0, 1, 10, 40, 128, 75][k % 6]].copy()
        if k % 5 == 1 and len(r) > 20:
            r[rng.integers(0, len(r), 2)] = 4
        reads.append(r if k % 7 != 3 else np.full(30, 4, np.uint8))
    arr, lens = _pack([np.asarray(r, np.uint8) for r in reads])
    didx = _didx(fmi, idt)
    q, ld = torch.from_numpy(arr), torch.from_numpy(lens)
    for jobs, want in cursor_jobs(didx, arr, lens, MemOpt()):
        fst, bst = {}, {}
        calls = smem_split.run_fwd_plain(didx, q, ld, jobs, stats=fst)
        rows, n = smem_split.run_bwd_plain(
            didx, q, ld, *smem_split.bwd_calls(jobs, calls), calls.stack, 19,
            stats=bst)
        held_to_kcur(didx, arr, lens, jobs, want,
                     (calls, fst, rows, n, bst), reverse=reverse,
                     card=(1, 1))
        # the first warp's four jobs end at different turns
        assert len(set(fst["steps"][:4].tolist())) > 1 or len(jobs[0]) < 4


@pytest.mark.parametrize("idt", ["int32", "int64"])
def test_split_refuses_reads_too_long_for_shared_memory(run_genome, idt):
    """At the longest L an H100 block holds K-bwd's three stacks, K-fwd
    and K-bwd == K-cur's plain version and the plain halves; one base
    more and K-bwd's entry refuses before anything runs, while K-fwd,
    which keeps no stack in shared memory, takes it and records the same
    calls."""
    fmi, _ = run_genome
    didx = _didx(fmi, idt)
    most = smem_split.ksplit_max_len(didx.idt)
    assert most == {"int32": 3873, "int64": 1936}[idt]
    read = np.tile(fmi.bnt.doubled()[:700], 6)[:most]
    arr = read[None, :].copy()
    lens = np.array([most], np.int32)
    q, ld = torch.from_numpy(arr), torch.from_numpy(lens)
    r1 = smem_cursor.round1_jobs(1, didx.idt, "cpu")
    want = smem_cursor.run_smem_jobs_plain(didx, q, ld, r1, 19,
                                           stats=(st := {}))
    fst, bst = {}, {}
    calls = smem_split.run_fwd_plain(didx, q, ld, r1, stats=fst)
    bcalls = smem_split.bwd_calls(r1, calls)
    rows, n = smem_split.run_bwd_plain(didx, q, ld, *bcalls, calls.stack, 19,
                                       stats=bst)
    held_to_kcur(didx, arr, lens, r1, (*want, st),
                 (calls, fst, rows, n, bst))
    wide = np.full((1, most + 1), 4, np.uint8)
    wide[0, :most] = read
    arrays = host_arrays(didx)
    longer = warp_host.fwd_host(arrays, wide, lens, [x.numpy() for x in r1],
                                smem_split.FWD_SLOTS)
    assert np.array_equal(longer[3], calls.m.numpy().sum(keepdims=True))
    with pytest.raises(RuntimeError, match="kernel 4 returned 1"):
        warp_host.bwd_host(arrays, wide, lens, [x.numpy() for x in bcalls],
                           calls.stack.numpy(), 19)


def test_split_rows_read_are_the_plain_versions(genomes, monkeypatch):
    """count_rows (chip_smoke.py's bytes bounds for K-fwd and K-bwd)
    reports the distinct occ rows each launch reads on round-1 jobs: the
    plain halves' extensions'; and the build without the sanitizers (as
    the smoke counts a chunk's rows) == the sanitized one."""
    fmi, _, reads = genomes["sim1m"]
    arr, lens = _pack(reads)
    didx = _didx(fmi, "int32")
    q, ld = torch.from_numpy(arr), torch.from_numpy(lens)
    r1 = smem_cursor.round1_jobs(len(lens), didx.idt, "cpu")
    seen = []
    plain = smem_fused.bwt_extend_plain

    def spy(didx, ik, is_back, stats=None):
        stats = {}
        out = plain(didx, ik, is_back, stats)
        seen.append(stats["occ_rows"])
        return out

    monkeypatch.setattr(smem_fused, "bwt_extend_plain", spy)
    calls = smem_split.run_fwd_plain(didx, q, ld, r1)
    fwd_rows = np.unique(torch.cat(seen).numpy())
    seen.clear()
    smem_split.run_bwd_plain(didx, q, ld, *smem_split.bwd_calls(r1, calls),
                             calls.stack, 19)
    bwd_rows = np.unique(torch.cat(seen).numpy())
    arrays = host_arrays(didx)
    fwd, fwd_fast = (warp_host.fwd_host(
        arrays, arr, lens, [x.numpy() for x in r1], smem_split.FWD_SLOTS,
        count_rows=True, sanitize=s) for s in (True, False))
    bwd, bwd_fast = (warp_host.bwd_host(
        arrays, arr, lens, [x.numpy() for x in smem_split.bwd_calls(
            r1, calls)], calls.stack.numpy(), 19, count_rows=True,
        sanitize=s) for s in (True, False))
    assert np.array_equal(fwd[-1], fwd_rows) and len(fwd_rows) > 0
    assert np.array_equal(bwd[-1], bwd_rows) and len(bwd_rows) > 0
    assert len(fwd) == 7 and len(bwd) == 5
    assert all(np.array_equal(a, b) for a, b in zip(fwd, fwd_fast))
    assert all(np.array_equal(a, b) for a, b in zip(bwd, bwd_fast))


def test_split_constants_are_the_sources(tmp_path):
    """The harness's view of K-fwd == csrc/smem.cu's constants
    (SPLIT_SHIPPED); its pin holds every job of a 16,384-read chunk's
    round 1 on an H100 at once (132 SMs of kFwdMinBlocks blocks of 128
    threads); every form's edits apply once and set its constants."""
    k = warp_host.split_constants()
    assert all(k[c] == v for c, v in warp_host.SPLIT_SHIPPED.items())
    assert 132 * k["kFwdMinBlocks"] * 128 // k["kFwdGroup"] >= 16384
    for form, edits in warp_host.SPLIT_FORMS.items():
        got = warp_host.split_constants(
            warp_host.form_sources(form, tmp_path / form))
        assert len(edits) == sum(got[c] != v for c, v in
                                 warp_host.SPLIT_SHIPPED.items())
    assert warp_host.split_constants(
        warp_host.form_sources("g32", tmp_path / "g32"))["kFwdGroup"] == 32

"""csrc/smem.cu's K-fwd and K-bwd (seed mode split: bwt_smem1a's forward
passes a warp a job from a job queue, their backward passes a warp a
recorded call from a call queue, the two halves of csrc/smem.cuh:smem1a)
compiled for the host against csrc/warp_host.h under ASan/UBSan
(csrc/smem_host.cpp), against K-cur's plain version
(device/smem_cursor.py:run_smem_jobs_plain) and the halves' own plain
versions (device/smem_split.py).

K-fwd goes through the wrapper's two-launch protocol
(``smem_split.collect_calls``), also at one stack interval a job, so
that every job of more takes the second launch; K-bwd runs on every call
K-fwd recorded, its rows sized by the calls' stack sizes.  Merged, their
rows and each job's count, steps and chain equal K-cur's plain
version's on round-1 and round-2 jobs, with each warp's lanes in both
orders, on a grid capped so that warps take several jobs and calls from
the queues, on the edge reads of tests/test_smem_cursor.py and the run
genome's strip edges; K-bwd writes at most m rows a call.  Both refuse
reads too long for a block's shared memory, and the occ rows each reads
(the smoke's bound) are the plain halves'.  int32 and int64 ranks.
K-cur's smem1a keeps its own body (so that K2's, K2-tp's and K-cur's SASS
stay as they were), and the halves repeat its phases: K-cur itself runs
on the harness beside them.  Tolerance 0.  What the GPU's compiler
makes of the source shows only on a card."""
import numpy as np
import pytest
import torch

from tpubwa_torch.device import smem_cursor, smem_fused, smem_split, warp_host
from tpubwa_torch.opts import MemOpt
from test_torch_smem import _pack
from test_torch_smem_host import (CASES, _didx, cursor_jobs,  # noqa: F401
                                  cursor_cases, genomes, host_arrays,
                                  kcur_launch, run_genome)


def split_host(didx, arr, lens, jobs, slots=smem_split.FWD_SLOTS,
               reverse=False, card=(0, 0)):
    """K-fwd through collect_calls on the host, then K-bwd on the host
    over every call: (rows, counts a job, steps a job, chain a job, the
    calls, K-bwd's counts a call, K-fwd's stats)."""
    arrays = host_arrays(didx)
    njobs = [x.numpy() for x in jobs]

    def launch(ids, width):
        got = warp_host.fwd_host(arrays, arr, lens, njobs, width,
                                 ids=ids.numpy(), reverse=reverse, card=card)
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
            fst["chain"].long() + per_job[2], calls, counts, fst)


def held_to_kcur(didx, arr, lens, jobs, want, kcur=False, **kw):
    """``split_host`` == K-cur's plain (rows, counts, stats) ``want`` and,
    with ``kcur``, == K-cur itself on the harness (csrc/smem.cuh:smem1a,
    whose phases the halves repeat): rows in order, each job's count,
    steps and chain; at most m rows a call.  Returns (the calls, K-fwd's
    stats)."""
    rows, counts, steps, chain, calls, per_call, fst = split_host(
        didx, arr, lens, jobs, **kw)
    want_rows, want_counts, want_stats = want
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
    assert bool((per_call <= calls.m.long()).all())
    return calls, fst


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("slots", [smem_split.FWD_SLOTS, 1])
@pytest.mark.parametrize("name,idt", CASES)
def test_split_equals_kcur(cursor_cases, name, idt, slots, reverse):
    """K-fwd then K-bwd on round-1 and round-2 jobs == K-cur's plain
    version, in both lane orders, and == K-cur on the harness (smem1a
    itself) at FWD_SLOTS; at one stack interval a job every job that
    pushed more takes the second launch, with exact counts."""
    didx, arr, lens, rounds = cursor_cases(name, idt)
    for jobs, want in rounds:
        calls, fst = held_to_kcur(didx, arr, lens, jobs, want, slots=slots,
                                  reverse=reverse, kcur=slots > 1)
        per_job = torch.bincount(calls.job, weights=calls.m.double(),
                                 minlength=len(jobs[0]))
        assert fst["second_launch_jobs"] == int((per_job > slots).sum())
    if slots == 1:
        assert fst["second_launch_jobs"] >= 1


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("idt", ["int32", "int64"])
def test_split_edges(genomes, run_genome, idt, reverse):
    """K-fwd and K-bwd == K-cur's plain version on the edge reads of
    tests/test_smem_cursor.py (:141-175: shorter than min_seed_len, all
    N, N at the cursor's start, a full 128-base match), an empty read, N
    at a read's end, one-shot jobs at an N, at the read's end and past it
    (no call), at x0 0 and at min_intv 3, and the run genome's reads
    (backward stacks past a strip of 32 intervals of equal sizes), on a
    grid of one SM holding one block, whose warps take several jobs and
    calls from the queues."""
    fmi = genomes["test"][0]
    text = fmi.bnt.doubled()
    reads = [text[100:110].copy(), np.full(60, 4, np.uint8),
             np.concatenate([[4, 4], text[200:300]]), text[500:628].copy(),
             text[:0].copy(), np.concatenate([text[800:897], [4, 4, 4]])]
    arr, lens = _pack([np.asarray(r, np.uint8) for r in reads])
    didx = _didx(fmi, idt)
    for jobs, want in cursor_jobs(didx, arr, lens, MemOpt()):
        held_to_kcur(didx, arr, lens, jobs, want, reverse=reverse,
                     card=(1, 1), kcur=True)
    one = (torch.tensor([2, 5, 3, 3, 3, 3], dtype=torch.int32),
           torch.tensor([0, 97, 128, 0, 64, 64], dtype=torch.int32),
           torch.tensor([1, 1, 1, 1, 1, 3], dtype=didx.idt),
           torch.ones(6, dtype=torch.bool))
    want = smem_cursor.run_smem_jobs_plain(
        didx, torch.from_numpy(arr), torch.from_numpy(lens), one, 19,
        stats=(st := {}))
    calls, _ = held_to_kcur(didx, arr, lens, one, (*want, st),
                            reverse=reverse)
    assert calls.job.tolist() == [3, 4, 5] and want[1][3] > 0
    fmi, reads = run_genome
    arr, lens = _pack(reads)
    didx = _didx(fmi, idt)
    for jobs, want in cursor_jobs(didx, arr, lens, MemOpt()):
        held_to_kcur(didx, arr, lens, jobs, want, reverse=reverse,
                     kcur=True)


@pytest.mark.parametrize("idt", ["int32", "int64"])
def test_split_refuses_reads_too_long_for_shared_memory(run_genome, idt):
    """At the longest L an H100 block holds K-bwd's three stacks, K-fwd
    and K-bwd == K-cur's plain version; one base more and K-bwd's entry
    refuses before anything runs, K-fwd's one base past its own two
    stacks' limit."""
    fmi, _ = run_genome
    didx = _didx(fmi, idt)
    most = smem_split.ksplit_max_len(didx.idt)
    read = np.tile(fmi.bnt.doubled()[:700], 6)[:most]
    arr = read[None, :].copy()
    lens = np.array([most], np.int32)
    r1 = smem_cursor.round1_jobs(1, didx.idt, "cpu")
    want = smem_cursor.run_smem_jobs_plain(
        didx, torch.from_numpy(arr), torch.from_numpy(lens), r1, 19,
        stats=(st := {}))
    calls, _ = held_to_kcur(didx, arr, lens, r1, (*want, st))
    fwd_most = smem_split.ksplit_max_len(didx.idt, smem_split.FWD_STACKS)
    assert fwd_most == {"int32": 5810, "int64": 2904}[idt]
    wide = np.full((1, fwd_most + 1), 4, np.uint8)
    wide[0, :most] = read
    with pytest.raises(RuntimeError, match="kernel 3 returned 1"):
        warp_host.fwd_host(host_arrays(didx), wide, lens,
                           [x.numpy() for x in r1], 4)
    wide = wide[:, :most + 1].copy()
    with pytest.raises(RuntimeError, match="kernel 4 returned 1"):
        warp_host.bwd_host(host_arrays(didx), wide, lens,
                           [x.numpy() for x in smem_split.bwd_calls(r1,
                                                                    calls)],
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

"""Seed mode split's module (device/smem_split.py: run_fwd, run_bwd and
rounds12_split, over the plain versions of K-fwd and K-bwd on the CPU)
against tpubwa/device/smem_split.py's two machines on JAX-CPU and
against K-cur's plain version (device/smem_cursor.py).

* ``run_fwd_plain``'s calls (x, m) and stacks == tpubwa's ``run_fwd``
  (its meta, and its snapshots flipped to longest match first), at caps
  where no lane overflows, which the test asserts;
* ``run_bwd_plain``'s rows == tpubwa's ``run_bwd`` decoded, call by
  call (tpubwa emits a call's rows by descending start, the port by
  ascending);
* forward then backward (``run_split``) == ``run_smem_jobs_plain``: rows,
  counts, and each job's steps and chain (its forward's plus its calls'
  backward's);
* the wrappers take the plain versions for CPU tensors, refuse reads
  longer than ``ksplit_max_len`` on the CPU too, and ``rounds12_split``
  == mode cursor's rounds.

Round-1 jobs (a read each, restarting past N) and round 2's one-shot
jobs, on tpubwa's seeding test genome and its cursor genome, int32 and
int64 ranks.  Tolerance 0."""
import dataclasses

import numpy as np
import pytest
import torch

import tpubwa.device  # noqa: F401  (x64, as the JAX package runs)
import jax.numpy as jnp
from tpubwa.device import smem_split as jsplit
from tpubwa.device.occ import DeviceIndex as JaxIndex
from tpubwa_torch.device import smem, smem_cursor, smem_split
from tpubwa_torch.device.occ import DeviceIndex
from tpubwa_torch.opts import MemOpt
from test_torch_seed_modes import _cursor_genome
from test_torch_smem import _pack, _test_genome

# tpubwa's caps for the references: a stack, the calls a job and the
# rows a call; the test asserts that no lane passes them
P, MAXC, MAXM = 48, 16, 32
CASES = [(g, i) for g in ("test", "cursor") for i in ("int32", "int64")]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One torch thread for the plain versions' small tensors (as
    tests/test_torch_seed_modes.py, whose workers share the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def cases(tmp_path_factory):
    """Each genome's reads packed, its port index and tpubwa's, and its
    two job sets, (read, x0, min_intv int64, one_shot) numpy arrays:
    round 1's (a job a read) and round 2's (a one-shot job a re-seeded
    row of K-cur's plain round 1), with one more one-shot job at an N."""
    fmi, jfmi, reads = _test_genome(tmp_path_factory.mktemp("tsplit"))
    out = {"test": (fmi, jfmi, reads), "cursor": _cursor_genome()[:3]}
    for name, (fmi, jfmi, reads) in out.items():
        arr, lens = _pack(reads)
        didx = DeviceIndex.from_fmindex(fmi, "cpu")
        q, ld = torch.from_numpy(arr), torch.from_numpy(lens)
        r1 = smem_cursor.round1_jobs(len(lens), didx.idt, "cpu")
        rows, counts = smem_cursor.run_smem_jobs_plain(didx, q, ld, r1, 19)
        r2 = smem_cursor.round2_jobs(MemOpt(), rows, counts)
        r_n, at_n = np.argwhere(arr == 4)[0]
        r2 = tuple(np.concatenate([x.numpy(), [v]]).astype(t) for x, v, t in
                   zip(r2, (r_n, at_n, 1, True),
                       (np.int32, np.int32, np.int64, bool)))
        out[name] = (fmi, jfmi, arr, lens,
                     [tuple(x.numpy() for x in r1), r2])
    return out


def _didx(fmi, idt):
    didx = DeviceIndex.from_fmindex(fmi, "cpu")
    return didx if idt == "int32" else dataclasses.replace(
        didx, idt=torch.int64, _fm=None)


def _jobs(jobs, idt):
    return tuple(torch.from_numpy(np.ascontiguousarray(x)).to(t) for x, t in
                 zip(jobs, (torch.int32, torch.int32, idt, torch.bool)))


@pytest.fixture(scope="module")
def tpubwa_runs(cases):
    """tpubwa's two machines on each genome's job sets, once for both of
    the port's rank types: {(genome, round): (calls [(job, x, stack
    longest match first)], rows a call)}; no lane overflows."""
    out = {}
    for name, (_, jfmi, arr, lens, rounds) in cases.items():
        jdidx = JaxIndex.from_fmindex(jfmi)
        qd, ld = jnp.asarray(arr), jnp.asarray(lens)
        for k, (read, x0, mi, once) in enumerate(rounds):
            snap, meta, ncalls, ovf = jsplit.run_fwd(
                jdidx, qd, ld, read, x0, mi, once, P, MAXC)
            assert not ovf.any()
            snp = np.asarray(snap)
            calls = [(j, int(meta[j, c, 0]),
                      snp[j, c, :int(meta[j, c, 1])][::-1].tolist())
                     for j in range(len(read)) for c in range(ncalls[j])]
            src = np.array([j * MAXC + c for j in range(len(read))
                            for c in range(ncalls[j])], np.int64)
            bjobs = (src, read[src // MAXC],
                     np.array([x for _, x, _ in calls]),
                     np.array([len(s) for _, _, s in calls]),
                     mi[src // MAXC])
            buf, mpad = jsplit.run_bwd(jdidx, qd, ld, snap, bjobs, P, MAXM, 19)
            rows, eff, ovf = jsplit._decode_bwd(buf, mpad, len(src), MAXM)
            assert not ovf.any()
            ends = np.cumsum(eff)
            out[name, k] = (calls, [rows[e - n:e][::-1].tolist()
                                    for e, n in zip(ends, eff)])
    return out


@pytest.mark.parametrize("name,idt", CASES)
def test_fwd_equals_tpubwa(cases, tpubwa_runs, name, idt):
    """run_fwd_plain's calls, each (job, x, m) and its stack (x0, x1,
    size, qe, longest match first), == tpubwa's smem_fwd_machine's; each
    call returns its stack's first qe; a one-shot job at an N records no
    call; the wrapper on CPU tensors == the plain version."""
    fmi, _, arr, lens, rounds = cases[name]
    didx = _didx(fmi, idt)
    q, ld = torch.from_numpy(arr), torch.from_numpy(lens)
    for k, jobs in enumerate(rounds):
        jobs = _jobs(jobs, didx.idt)
        got = smem_split.run_fwd_plain(didx, q, ld, jobs)
        want, _ = tpubwa_runs[name, k]
        assert got.stack.dtype == didx.idt and len(got.job) == len(want)
        m = got.m.long()
        offs = (torch.cumsum(m, 0) - m).tolist()
        for i, (j, x, stack) in enumerate(want):
            assert (int(got.job[i]), int(got.x[i]), int(got.m[i])) == \
                (j, x, len(stack)), (k, i)
            st = got.stack[offs[i]:offs[i] + len(stack)].tolist()
            assert st == stack and int(got.ret[i]) == st[0][3], (k, i)
        if k == 1:
            assert int(got.job[-1]) < len(jobs[0]) - 1  # the N job: none
        wrapped = smem_split.run_fwd(didx, q, ld, jobs)
        assert all(torch.equal(getattr(wrapped, f.name), getattr(got, f.name))
                   for f in dataclasses.fields(got))


@pytest.mark.parametrize("name,idt", CASES)
def test_bwd_equals_tpubwa(cases, tpubwa_runs, name, idt):
    """run_bwd_plain on the calls run_fwd_plain records: each call's rows
    == tpubwa's smem_bwd_machine's decoded rows, by query start, at most
    m a call; the wrapper on CPU tensors == the plain version."""
    fmi, _, arr, lens, rounds = cases[name]
    didx = _didx(fmi, idt)
    q, ld = torch.from_numpy(arr), torch.from_numpy(lens)
    n_rows = 0
    for k, jobs in enumerate(rounds):
        jobs = _jobs(jobs, didx.idt)
        calls = smem_split.run_fwd_plain(didx, q, ld, jobs)
        args = (*smem_split.bwd_calls(jobs, calls), calls.stack, 19)
        rows, counts = smem_split.run_bwd_plain(didx, q, ld, *args)
        _, want = tpubwa_runs[name, k]
        assert rows.dtype == didx.idt and counts.tolist() == list(map(
            len, want))
        assert bool((counts <= calls.m).all())
        ends = torch.cumsum(counts, 0).tolist()
        for i, w in enumerate(want):
            assert rows[ends[i] - len(w):ends[i]].tolist() == w, (k, i)
        assert all(torch.equal(a, b) for a, b in zip(
            smem_split.run_bwd(didx, q, ld, *args), (rows, counts)))
        n_rows += len(rows)
    assert n_rows > 0


@pytest.mark.parametrize("name,idt", CASES)
def test_fwd_then_bwd_equals_kcur(cases, name, idt):
    """Forward then backward == run_smem_jobs_plain on each job set: the
    rows in order and each job's count; a job's steps and chain == its
    forward's plus its calls' backward's."""
    fmi, _, arr, lens, rounds = cases[name]
    didx = _didx(fmi, idt)
    q, ld = torch.from_numpy(arr), torch.from_numpy(lens)
    n_rows = 0
    for jobs in rounds:
        jobs = _jobs(jobs, didx.idt)
        kst, fst, bst = {}, {}, {}
        want = smem_cursor.run_smem_jobs_plain(didx, q, ld, jobs, 19,
                                               stats=kst)
        assert all(torch.equal(a, b) for a, b in zip(
            smem_split.run_split(didx, q, ld, jobs, 19), want))
        calls = smem_split.run_fwd_plain(didx, q, ld, jobs, stats=fst)
        smem_split.run_bwd_plain(didx, q, ld,
                                 *smem_split.bwd_calls(jobs, calls),
                                 calls.stack, 19, stats=bst)
        for key in ("steps", "chain"):
            per_job = fst[key].long().index_add(0, calls.job,
                                                bst[key].long())
            assert torch.equal(per_job, kst[key].long()), key
        n_rows += len(want[0])
    assert n_rows > 0


@pytest.mark.parametrize("idt", ["int32", "int64"])
def test_rounds12_split_equals_cursor(cases, idt):
    """rounds12_split (round 1 a job a read, round 2 a one-shot job a
    re-seeded row) == mode cursor's rounds, rows and read ids in order."""
    fmi, _, arr, lens, _ = cases["cursor"]
    didx = _didx(fmi, idt)
    q, ld = torch.from_numpy(arr), torch.from_numpy(lens)
    got = smem_split.rounds12_split(MemOpt(), didx, q, ld)
    want = smem._rounds12_cursor(MemOpt(), didx, q, ld)
    assert got[0].dtype == didx.idt and got[1].dtype == torch.int64
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert len(got[0]) > len(lens)


@pytest.mark.parametrize("idt", ["int32", "int64"])
def test_reads_too_long_are_refused(cases, idt):
    """K-bwd keeps 3 (L + 1) intervals a warp in shared memory: reads one
    base past ksplit_max_len raise RuntimeError on the CPU route too,
    before anything runs, in both halves; so do calls whose stacks
    cannot come from a forward pass (empty, or longer than the read past
    x), with ValueError."""
    fmi, _, arr, lens, rounds = cases["test"]
    didx = _didx(fmi, idt)
    most = smem_split.ksplit_max_len(didx.idt)
    assert most == {"int32": 3873, "int64": 1936}[idt]
    wide = torch.full((len(lens), most + 1), 4, dtype=torch.uint8)
    wide[:, :arr.shape[1]] = torch.from_numpy(arr)
    ld = torch.from_numpy(lens)
    jobs = _jobs(rounds[0], didx.idt)
    with pytest.raises(RuntimeError, match=f"at most {most} bases"):
        smem_split.run_fwd(didx, wide, ld, jobs)
    q = torch.from_numpy(arr)
    calls = smem_split.run_fwd_plain(didx, q, ld, jobs)
    read, x, m, mi = smem_split.bwd_calls(jobs, calls)
    with pytest.raises(RuntimeError, match=f"at most {most} bases"):
        smem_split.run_bwd(didx, wide, ld, read, x, m, mi, calls.stack, 19)
    # a stack longer than its read past x, or empty, is refused too
    for bad in (ld[read.long()] - x + 1, torch.zeros_like(m)):
        bad = bad.int()
        stack = torch.zeros((int(bad.sum()), 4), dtype=didx.idt)
        with pytest.raises(ValueError, match="longer than its read"):
            smem_split.run_bwd(didx, q, ld, read, x, bad, mi, stack, 19)

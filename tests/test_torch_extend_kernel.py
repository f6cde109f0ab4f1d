"""tpubwa_torch's banded-SW extension (extend_kernel.py) vs tpubwa's
Pallas kernel (interpret mode) and the scalar ref.ksw oracle, on the
same numpy-seeded jobs.  Tolerance 0: every output is an exact
integer."""
import numpy as np
import pytest
import torch

import tpubwa.device  # noqa: F401  (x64, as the JAX package runs)
import jax.numpy as jnp
from tpubwa.device import extend_pallas as jx
from tpubwa.opts import MemOpt
from tpubwa.ref.ksw import ksw_extend
from tpubwa_torch.device import extend_kernel as tk
from tpubwa_torch.scripts import exp_kernel_floor as xf
from test_device_extend import _mk_jobs


def _pack(jobs, W, tmax):
    """Jobs -> (q [N, W], t [N, tmax], params [N, 128]) int32, padded
    with N codes; lane layout of extend_batch_pallas."""
    n = len(jobs)
    q = np.full((n, W), 4, np.int32)
    t = np.full((n, tmax), 4, np.int32)
    p = np.zeros((n, 128), np.int32)
    for i, j in enumerate(jobs):
        ql, tl = len(j["q"]), len(j["t"])
        q[i, :ql] = j["q"]
        t[i, :tl] = j["t"]
        p[i, :5] = (ql, tl, j["h0"], j["w"], j["end_bonus"])
    return q, t, p


def _edge_jobs(rng):
    """Empty targets, empty queries and N codes on both sides."""
    jobs = _mk_jobs(rng, 12, None)
    for k, j in enumerate(jobs):
        if k % 4 == 0:
            j["t"] = j["t"][:0]                       # tlen = 0
        elif k % 4 == 1:
            j["q"] = j["q"][:0]                       # qlen = 0
        else:
            j["q"] = j["q"].copy()
            j["q"][::7] = 4                           # N in the query
            j["t"] = j["t"].copy()
            j["t"][3::11] = 4                         # N in the target
    return jobs


def _oracle(jobs, mat, opt, zdrop):
    out = []
    for j in jobs:
        r = ksw_extend(len(j["q"]), j["q"], len(j["t"]), j["t"], mat,
                       opt.o_del, opt.e_del, opt.o_ins, opt.e_ins,
                       j["w"], j["end_bonus"], zdrop, j["h0"])
        out.append((r.score, r.qle, r.tle, r.gtle, r.gscore, r.max_off))
    return np.asarray(out, np.int64)


@pytest.mark.parametrize("W,tmax", [(128, 256), (256, 512)])
@pytest.mark.parametrize("zdrop", [0, 100])
def test_plain_equals_pallas_and_oracle(W, tmax, zdrop):
    opt = MemOpt()
    mat = opt.scoring_matrix().astype(np.int32)
    rng = np.random.default_rng(1000 + W + zdrop)
    jobs = _mk_jobs(rng, 52, opt) + _edge_jobs(rng)
    if W == 256:
        # queries wider than the 128-lane bucket
        for j in jobs[:8]:
            j["q"] = rng.integers(0, 4, 200).astype(np.int32)
            j["t"] = np.concatenate([j["q"][:150], rng.integers(
                0, 4, 300).astype(np.int32)])
    q, t, p = _pack(jobs, W, tmax)
    got = tk.extend_batch(torch.from_numpy(q), torch.from_numpy(t),
                          torch.from_numpy(p), opt.a, opt.b, opt.o_del,
                          opt.e_del, opt.o_ins, opt.e_ins, zdrop)
    assert got.dtype == torch.int32 and got.shape == (len(jobs), 6)
    want = np.asarray(jx.extend_batch_pallas(
        jnp.asarray(q), jnp.asarray(t), jnp.asarray(p), opt.a, opt.b,
        opt.o_del, opt.e_del, opt.o_ins, opt.e_ins, zdrop, tmax,
        interpret=True))[:, :6]
    assert got.numpy().tolist() == want.tolist()
    assert got.numpy().tolist() == _oracle(jobs, mat, opt, zdrop).tolist()


@pytest.mark.parametrize("gaps", [(6, 1, 9, 2), (12, 2, 3, 1)])
def test_plain_asymmetric_gaps(gaps):
    """Asymmetric gap costs reach the z-drop's e_del/e_ins split."""
    od, ed, oi, ei = gaps
    mat = MemOpt(b=2).scoring_matrix().astype(np.int32)
    rng = np.random.default_rng(7)
    jobs = _mk_jobs(rng, 40, None)
    q, t, p = _pack(jobs, 128, 128)
    got = tk.extend_batch_plain(torch.from_numpy(q), torch.from_numpy(t),
                                torch.from_numpy(p), 1, 2, od, ed, oi, ei,
                                50)
    for i, j in enumerate(jobs):
        r = ksw_extend(len(j["q"]), j["q"], len(j["t"]), j["t"], mat,
                       od, ed, oi, ei, j["w"], j["end_bonus"], 50, j["h0"])
        assert got[i].tolist() == [r.score, r.qle, r.tle, r.gtle,
                                   r.gscore, r.max_off], (i, gaps)


def test_helpers_match_jax():
    for n in (0, 1, 99, 127, 128, 255, 256, 510, 511, 600):
        assert tk.width_for(n) == jx.width_for(n)
    for w in (128, 256, 512):
        assert tk.chunk_for(w) == jx.chunk_for(w)
    for m in (MemOpt().scoring_matrix(),
              MemOpt(a=2, b=9).scoring_matrix()):
        assert tk._mat_ab(m) == jx._mat_ab(m)
    m = MemOpt().scoring_matrix().astype(np.int32)
    m[1, 2] = 7
    assert tk._mat_ab(m) is None and jx._mat_ab(m) is None


def test_wrapper_routes_cpu_to_plain_and_checks_inputs():
    rng = np.random.default_rng(3)
    q, t, p = (torch.from_numpy(x) for x in
               _pack(_mk_jobs(rng, 6, None), 128, 128))
    before = tk.extend_batch.launches
    a = tk.extend_batch(q, t, p, 1, 4, 6, 1, 6, 1, 100)
    b = tk.extend_batch_plain(q, t, p, 1, 4, 6, 1, 6, 1, 100)
    assert torch.equal(a, b)
    # the launch count is the kernel's: the plain version adds nothing
    assert tk.extend_batch.launches == before
    with pytest.raises(TypeError):
        tk.extend_batch(q.long(), t, p, 1, 4, 6, 1, 6, 1, 100)
    with pytest.raises(ValueError):
        tk.extend_batch(q, t[:3], p, 1, 4, 6, 1, 6, 1, 100)
    with pytest.raises(ValueError):
        tk.extend_batch(q, t, p[:, :4], 1, 4, 6, 1, 6, 1, 100)
    for bad_qlen in (128, -1):
        bad = p.clone()
        bad[2, 0] = bad_qlen
        with pytest.raises(ValueError, match="qlen"):
            tk.extend_batch(q, t, bad, 1, 4, 6, 1, 6, 1, 100)


@pytest.mark.parametrize("W", [128, 256, 512])
def test_a_score_past_the_packed_row_max_raises(W):
    """The row max travels as (H << sh) | column, 2^sh >= W, in int32.
    No H exceeds h0 + a * qlen: the largest such sum that fits runs, and
    is right (the plain version and the oracle agree on a job whose
    score reaches it); one more raises, in both versions."""
    hmax = (1 << 31) // W - 1
    a, qlen = 2, W - 1
    rng = np.random.default_rng(W)
    seq = rng.integers(0, 4, qlen).astype(np.int32)
    job = {"q": seq, "t": seq, "h0": hmax - a * qlen, "w": 10,
           "end_bonus": 0}
    q, t, p = (torch.from_numpy(x) for x in _pack([job], W, W))
    got = tk.extend_batch(q, t, p, a, 4, 6, 1, 6, 1, 100)
    opt = MemOpt(a=a)
    mat = opt.scoring_matrix().astype(np.int32)
    assert got[0, 0] == hmax and got[0, 1] == qlen
    assert got.tolist() == _oracle([job], mat, opt, 100).tolist()
    p[0, 2] += 1
    for fn in (tk.extend_batch, tk.extend_batch_plain):
        with pytest.raises(ValueError, match=f"exceed {hmax} at W {W}"):
            fn(q, t, p, a, 4, 6, 1, 6, 1, 100)
    # a shorter query leaves the same h0 inside
    p[0, 0] -= 1
    tk.extend_batch(q, t, p, a, 4, 6, 1, 6, 1, 100)


# ---- the strip-edge jobs (exp_kernel_floor.strip_edge_jobs) ----

STRIP_SETS = ("ins_run", "del_run", "tie32", "tie64", "residues", "closed",
              "qlen_edges")
_strip_cache = {}


def _strip(W, tmax):
    """The strip-edge sets of one tile shape with the plain version's,
    the Pallas kernel's (interpret mode, one call a shape) and the
    tracer's results for each job."""
    if (W, tmax) not in _strip_cache:
        sets = xf.strip_edge_jobs(W, tmax)
        q, t, p5 = (np.concatenate([s[k] for s in sets.values()])
                    for k in range(3))
        p = np.zeros((len(q), 128), np.int32)
        p[:, :5] = p5
        pen = (*xf.SCORING, xf.ZDROP)
        plain = tk.extend_batch_plain(
            torch.from_numpy(q), torch.from_numpy(t), torch.from_numpy(p),
            *pen).numpy()
        pallas = np.asarray(jx.extend_batch_pallas(
            jnp.asarray(q), jnp.asarray(t), jnp.asarray(p), *pen, tmax,
            interpret=True))[:, :6]
        traces = [xf.band_trace(q[k], t[k], p[k], *pen)
                  for k in range(len(q))]
        rows, lo = {}, 0
        for name, s in sets.items():
            rows[name] = slice(lo, lo + len(s[0]))
            lo += len(s[0])
        _strip_cache[W, tmax] = (sets, rows, plain, pallas, traces)
    return _strip_cache[W, tmax]


def test_strip_edge_jobs_name_their_sets():
    for W, tmax in xf.STRIP_SHAPES:
        sets = xf.strip_edge_jobs(W, tmax)
        assert tuple(sets) == STRIP_SETS
        for q, t, p in sets.values():
            assert q.shape[1] == W and t.shape[1] == tmax
            assert q.dtype == t.dtype == p.dtype == np.int32
            tk._check(*(torch.from_numpy(x) for x in (q, t, p)))
        # the same jobs on every call: the card runs what the tests hold
        again = xf.strip_edge_jobs(W, tmax)
        assert all((a == b).all() for name in sets
                   for a, b in zip(sets[name], again[name]))


@pytest.mark.parametrize("W,tmax", xf.STRIP_SHAPES)
@pytest.mark.parametrize("name", STRIP_SETS)
def test_strip_edges_plain_equals_pallas_oracle_and_trace(W, tmax, name):
    sets, rows, plain, pallas, traces = _strip(W, tmax)
    q, t, p = sets[name]
    got = plain[rows[name]]
    assert got.tolist() == pallas[rows[name]].tolist()
    assert got.tolist() == [out for out, _ in traces[rows[name]]]
    opt = MemOpt()
    assert (opt.a, opt.b, opt.o_del, opt.e_del, opt.o_ins,
            opt.e_ins) == xf.SCORING
    mat = opt.scoring_matrix().astype(np.int32)
    jobs = [{"q": q[k, :p[k, 0]], "t": t[k, :p[k, 1]], "h0": int(p[k, 2]),
             "w": int(p[k, 3]), "end_bonus": int(p[k, 4])}
            for k in range(len(q))]
    assert got.tolist() == _oracle(jobs, mat, opt, xf.ZDROP).tolist()


@pytest.mark.parametrize("W,tmax", xf.STRIP_SHAPES)
def test_strip_edges_have_what_they_are_built_for(W, tmax):
    sets, rows, plain, _, traces = _strip(W, tmax)
    facts = {name: [f for _, f in traces[rows[name]]] for name in sets}
    out = {name: plain[rows[name]] for name in sets}
    # F wins a cell 33 and more columns from where it opened, in every
    # job, and two strip edges away in some
    runs = [f["f_run"] for f in facts["ins_run"]]
    assert min(runs) >= 33 and max(runs) >= 64
    if W > 128:   # the tile has room for a tail that makes the run pay
        assert (out["ins_run"][:, 1] - out["ins_run"][:, 2]).tolist() == [
            33, 33, 47, 47, 64, 64, 70, 70]
    assert (out["del_run"][:, 2] - out["del_run"][:, 1]).tolist() == [
        33, 33, 47, 47, 64, 64, 70, 70]
    assert {int(w) for w in sets["del_run"][2][:, 3]} == {100, 200}
    for d in (32, 64):
        name = f"tie{d}"
        assert all(d in f["tie_gaps"] for f in facts[name])
        for k, tlen in enumerate(sets[name][2][:, 1]):
            if tlen > d + 7:    # the later column of the tie is the result
                assert out[name][k, 1] - out[name][k, 2] == d
        assert any(tlen > d + 7 for tlen in sets[name][2][:, 1]) or W == 128
    res = facts["residues"]
    begs = {b % 32 for f in res for b in f["beg"]}
    ends = {e % 32 for f in res for e in f["end"]}
    widths = {(e - b) % 32 for f in res for b, e in zip(f["beg"], f["end"])}
    assert begs == ends == widths == set(range(32))
    assert all(f["closed"] for f in facts["closed"])
    qlens = sets["qlen_edges"][2][:, 0].tolist()
    assert 1 in qlens and W - 1 in qlens
    widest = max(e - b for f in facts["qlen_edges"]
                 for b, e in zip(f["beg"], f["end"]))
    assert widest == min(W - 1, 401)    # up to 13 strips a row


@pytest.mark.parametrize("zdrop", [0, 100])
def test_band_trace_equals_plain_on_make_jobs(zdrop):
    """The tracer that shows what the strip-edge sets have is itself held
    to the plain version: SNPs, small indels, N codes, empty sides."""
    from chip_smoke import make_jobs
    q, t, p = make_jobs(np.random.default_rng(9 + zdrop), 48, 128, 256)
    pen = (*xf.SCORING, zdrop)
    want = tk.extend_batch_plain(
        *(torch.from_numpy(np.ascontiguousarray(x)) for x in (q, t, p)),
        *pen).numpy()
    cells = 0
    for k in range(len(q)):
        out, facts = xf.band_trace(q[k], t[k], p[k], *pen)
        assert out == want[k].tolist(), k
        cells += sum(e - b for b, e in zip(facts["beg"], facts["end"]))
    # its open rows are the rows whose band cells the plain version counts
    stats = {}
    tk.extend_batch_plain(
        *(torch.from_numpy(np.ascontiguousarray(x)) for x in (q, t, p)),
        *pen, stats=stats)
    assert cells == stats["cells"] > 0

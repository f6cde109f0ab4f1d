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

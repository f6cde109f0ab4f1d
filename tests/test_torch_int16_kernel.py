"""tpubwa_torch's int16 extension (tpubwa_torch/scripts/exp_int16_kernel.py)
against the JAX experiment's int16 Pallas kernel (scripts/
exp_int16_kernel.py, interpret mode), K1's Pallas kernel (interpret mode)
and the scalar ref.ksw oracle, on the same numpy-seeded jobs.  Tolerance
0: every output is an exact integer."""
import os
import sys

import numpy as np
import pytest
import torch

import tpubwa.device  # noqa: F401  (x64, as the JAX package runs)
import jax.numpy as jnp
from tpubwa.device import extend_pallas as jx
from tpubwa.opts import MemOpt
from tpubwa.ref.ksw import ksw_extend
from tpubwa_torch.device import extend_kernel as tk
from tpubwa_torch.scripts import exp_int16_kernel as x16
from test_device_extend import _mk_jobs
from test_torch_extend_kernel import _edge_jobs, _pack

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PEN = (1, 4, 6, 1, 6, 1)          # a, b, o_del, e_del, o_ins, e_ins


@pytest.fixture(scope="module")
def pallas16():
    """The JAX experiment's int16 kernel wrapper, imported from scripts/."""
    with pytest.MonkeyPatch.context() as mp:
        mp.syspath_prepend(os.path.join(ROOT, "scripts"))
        from exp_int16_kernel import extend_batch_pallas16
    return extend_batch_pallas16


def _jax(fn, q, t, p, pen, zdrop):
    return np.asarray(fn(jnp.asarray(q), jnp.asarray(t), jnp.asarray(p),
                         *pen, zdrop, t.shape[1], interpret=True))[:, :6]


def _oracle(q, t, p, pen, zdrop):
    a, b, od, ed, oi, ei = pen
    mat = MemOpt(a=a, b=b).scoring_matrix().astype(np.int32)
    out = []
    for qi, ti, pi in zip(q, t, p):
        ql, tl, h0, w, eb = (int(x) for x in pi[:5])
        r = ksw_extend(ql, qi[:ql], tl, ti[:tl], mat, od, ed, oi, ei, w,
                       eb, zdrop, h0)
        out.append((r.score, r.qle, r.tle, r.gtle, r.gscore, r.max_off))
    return np.asarray(out, np.int64)


def _plain16(q, t, p, pen, zdrop):
    return x16.extend_batch16_plain(torch.from_numpy(q), torch.from_numpy(t),
                                    torch.from_numpy(p), *pen, zdrop)


@pytest.mark.parametrize("W,tmax", [(128, 256), (256, 512)])
@pytest.mark.parametrize("zdrop", [0, 100])
def test_plain16_equals_pallas16_k1_and_oracle(pallas16, W, tmax, zdrop):
    """Seeded jobs, the edge jobs of the K1 tests (empty targets, empty
    queries, N codes) and, at W = 256, queries wider than 128 lanes."""
    rng = np.random.default_rng(2000 + W + zdrop)
    jobs = _mk_jobs(rng, 40, None) + _edge_jobs(rng)
    if W == 256:
        for j in jobs[:8]:
            j["q"] = rng.integers(0, 4, 200).astype(np.int32)
            j["t"] = np.concatenate([j["q"][:150], rng.integers(
                0, 4, 300).astype(np.int32)])
    q, t, p = _pack(jobs, W, tmax)
    got = _plain16(q, t, p, PEN, zdrop)
    assert got.dtype == torch.int32 and got.shape == (len(jobs), 6)
    got = got.numpy().tolist()
    assert got == _jax(pallas16, q, t, p, PEN, zdrop).tolist()
    assert got == _jax(jx.extend_batch_pallas, q, t, p, PEN, zdrop).tolist()
    assert got == _oracle(q, t, p, PEN, zdrop).tolist()


def test_plain16_equals_pallas16_on_script_fuzz(pallas16):
    """Two trials of the script's own equality fuzz, in one batch."""
    rng = np.random.default_rng(0)
    q, t, p = (np.concatenate(x) for x in zip(*(x16.fuzz_jobs(rng)
                                                  for _ in range(2))))
    got = _plain16(q, t, p, x16.SCORING, x16.ZDROP).numpy().tolist()
    assert got == _jax(pallas16, q, t, p, x16.SCORING, x16.ZDROP).tolist()
    assert got == _jax(jx.extend_batch_pallas, q, t, p, x16.SCORING,
                       x16.ZDROP).tolist()
    assert got == _oracle(q, t, p, x16.SCORING, x16.ZDROP).tolist()


def _edge_case(side):
    """Jobs at the int16 bound (h0 + a*(qlen + 1) + W*e_ins = 32767, or
    max(b, 8192) + o_del + e_del = 32768) when side is "in", one step
    past it when side is "out"."""
    rng = np.random.default_rng(77)
    q, t, p = _pack(_mk_jobs(rng, 24, None), 128, 128)
    step = int(side == "out")
    pen = list(PEN)
    a, e_ins = pen[0], pen[5]
    p[::3, 2] = 32767 - a * (p[::3, 0] + 1) - 128 * e_ins + step
    gap = list(PEN)
    gap[2] = 32768 - 8192 - gap[3] + step            # o_del
    return q, t, p, tuple(pen), tuple(gap)


def test_int16_bound_inside_is_equal(pallas16):
    q, t, p, pen, gap = _edge_case("in")
    assert int((p[:, 2] + p[:, 0] + 1 + 128).max()) == 32767
    for pn in (pen, gap):
        got = _plain16(q, t, p, pn, 100).numpy().tolist()
        assert got == _jax(pallas16, q, t, p, pn, 100).tolist()
        assert got == _oracle(q, t, p, pn, 100).tolist()
    # scores near the top of int16 do occur
    assert max(r[0] for r in got) > 32000


@pytest.mark.parametrize("fn", [x16.extend_batch16,
                                x16.extend_batch16_plain])
def test_int16_bound_outside_raises(fn):
    q, t, p, pen, gap = _edge_case("out")
    args = [torch.from_numpy(x) for x in (q, t, p)]
    with pytest.raises(ValueError, match="int16 domain"):
        fn(*args, *pen, 100)
    with pytest.raises(ValueError, match="int16 domain"):
        fn(*args[:2], torch.from_numpy(p.clip(0, 60)), *gap, 100)
    ok = torch.from_numpy(p.clip(0, 60))
    with pytest.raises(ValueError, match="int16 domain"):
        fn(*args[:2], ok, 1, -4, 6, 1, 6, 1, 100)       # a negative b
    neg_h0 = ok.clone()
    neg_h0[1, 2] = -1
    with pytest.raises(ValueError, match="int16 domain"):
        fn(*args[:2], neg_h0, *PEN, 100)
    big_code = args[1].clone()
    big_code[0, 0] = 1 << 15
    with pytest.raises(ValueError, match="int16 domain"):
        fn(args[0], big_code, ok, *PEN, 100)


def test_wrapper16_routes_cpu_to_plain_and_checks_inputs():
    rng = np.random.default_rng(3)
    q, t, p = (torch.from_numpy(x) for x in
               _pack(_mk_jobs(rng, 6, None), 128, 128))
    before = x16.extend_batch16.launches
    got = x16.extend_batch16(q, t, p, *PEN, 100)
    assert torch.equal(got, x16.extend_batch16_plain(q, t, p, *PEN, 100))
    assert torch.equal(got, tk.extend_batch_plain(q, t, p, *PEN, 100))
    # the launch count is the kernel's: the plain version adds nothing
    assert x16.extend_batch16.launches == before
    with pytest.raises(TypeError):
        x16.extend_batch16(q.long(), t, p, *PEN, 100)
    with pytest.raises(ValueError):
        x16.extend_batch16(q, t[:3], p, *PEN, 100)
    bad = p.clone()
    bad[2, 0] = 128
    with pytest.raises(ValueError, match="qlen"):
        x16.extend_batch16(q, t, bad, *PEN, 100)
    empty = x16.extend_batch16(q[:0], t[:0], p[:0], *PEN, 100)
    assert empty.shape == (0, 6)


def test_main_runs_timing_and_fuzz_on_cpu(capsys, monkeypatch):
    # 1 timed call and 2 fuzz trials instead of 20 and 30 keep it short
    monkeypatch.setattr(x16, "REPS", 1)
    monkeypatch.setattr(x16, "FUZZ_TRIALS", 2)
    res = x16.main(["--device", "cpu", "--jobs", "64"])
    out = capsys.readouterr().out
    assert "equality fuzz: 0 mismatching jobs / 128" in out
    assert "not band cells" in out
    assert res["fuzz_mismatches"] == 0 and res["fuzz_jobs"] == 128
    (row,) = res["timing"]
    assert row["N"] == 64 and row["i32_ms"] > 0 and row["i16_ms"] > 0


def test_main_cuda_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        x16.main(["--device", "cuda", "--jobs", "8"])


def test_script_jobs_match_the_jax_script_layout():
    """The vectorised job builder gives the JAX script's per-row loop."""
    n = 9
    q, t, p = x16.script_jobs(np.random.default_rng(4), n)
    tpl = np.random.default_rng(4).integers(0, 4, x16.TL + n)
    for i in range(n):
        assert (t[i, :x16.TL] == tpl[i:i + x16.TL]).all()
        assert (q[i, :x16.QL] == tpl[i:i + x16.QL]).all()
        assert (q[i, x16.QL:] == 4).all() and (t[i, x16.TL:] == 4).all()
        assert p[i, :5].tolist() == [x16.QL, x16.TL, 60, 100, 5]


def test_plain16_counts_rows_and_strips_as_the_row_loop_runs():
    """The plain version's ``stats`` against upstream's row loop run a
    row at a time (exp_kernel_floor.band_trace): open rows, band cells,
    and the strips of 32 columns from beg and of 64 from beg & ~1 that
    cover [beg, end] on each."""
    from tpubwa_torch.scripts import exp_kernel_floor as xf
    rng = np.random.default_rng(12)
    q, t, p = _pack(_mk_jobs(rng, 12, None) + _edge_jobs(rng), 256, 256)
    stats = {}
    x16.extend_batch16_plain(torch.from_numpy(q), torch.from_numpy(t),
                             torch.from_numpy(p), *PEN, 100, stats=stats)
    want = {"rows": 0, "cells": 0, "strips32": 0, "strips64": 0}
    for k in range(len(q)):
        _, f = xf.band_trace(q[k], t[k], p[k], *PEN, 100)
        for b, e in zip(f["beg"], f["end"]):
            want["rows"] += 1
            want["cells"] += e - b
            want["strips32"] += (e - b) // 32 + 1
            want["strips64"] += (e - (b & ~1)) // 64 + 1
    assert stats == want and want["strips64"] < want["strips32"]

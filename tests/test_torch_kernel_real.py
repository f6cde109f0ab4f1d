"""tpubwa_torch's K1-real (tpubwa_torch/scripts/exp_kernel_real.py)
against the JAX experiment's kernels (scripts/exp_kernel_real.py:
build_kernel, every variant, interpret mode), K1's Pallas kernel
(interpret mode) and the scalar ref.ksw oracle, on the same
numpy-seeded jobs.  Tolerance 0: every output is an exact integer."""
import functools
import math
import os

import numpy as np
import pytest
import torch

import tpubwa.device  # noqa: F401  (x64, as the JAX package runs)
import jax.experimental.pallas as jpl
import jax.numpy as jnp
from tpubwa.device import extend_pallas as jx
from tpubwa.opts import MemOpt
from tpubwa.ref.ksw import ksw_extend
from tpubwa_torch.scripts import exp_kernel_real as xr
from chip_smoke import make_jobs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HMAX = ((1 << 31) - xr.NL) // xr.NL       # largest h0 + a*qlen allowed


@pytest.fixture(scope="module")
def jobs():
    """56 jobs: make_jobs' adversarial set (SNPs, indels, N codes, empty
    sides), the script's own jobs, and jobs built to tell no-zdrop and
    no-wbmask from full."""
    rng = np.random.default_rng(5)
    parts = [make_jobs(rng, 32, 128, 256), xr.script_jobs(rng, 8),
             xr.zdrop_jobs(rng, 8), xr.wbmask_jobs(rng, 8)]
    q = np.concatenate([x[0] for x in parts])
    t = np.concatenate([x[1] for x in parts])
    p = np.zeros((len(q), 128), np.int32)
    p[:, :5] = np.concatenate([x[2][:, :5] for x in parts])
    return q, t, p


def _plain(q, t, p, variant):
    return xr.extend_real_plain(torch.from_numpy(q), torch.from_numpy(t),
                                torch.from_numpy(p), variant).numpy()


def _k1_pallas(q, t, p):
    return np.asarray(jx.extend_batch_pallas(
        jnp.asarray(q), jnp.asarray(t), jnp.asarray(p), *xr.SCORING,
        xr.ZDROP, t.shape[1], interpret=True))[:, :6]


@pytest.fixture(scope="module")
def jax_real():
    """build_kernel(variant) of scripts/exp_kernel_real.py, run in
    interpret mode: the script calls pl.pallas_call without interpret=,
    so pallas_call is patched here (K1's reference, which passes
    interpret itself, is computed outside the patch)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.syspath_prepend(os.path.join(ROOT, "scripts"))
        from exp_kernel_real import build_kernel
    cache = {}

    def run(variant, q, t, p):
        key = (variant, q.tobytes(), t.tobytes(), p.tobytes())
        if key not in cache:
            with pytest.MonkeyPatch.context() as mp:
                mp.setattr(jpl, "pallas_call", functools.partial(
                    jpl.pallas_call, interpret=True))
                cache[key] = np.asarray(build_kernel(variant)(
                    jnp.asarray(q), jnp.asarray(t), jnp.asarray(p)))
        return cache[key]
    return run


@pytest.mark.parametrize("variant", xr.VARIANTS)
def test_plain_equals_jax_variant(jobs, jax_real, variant):
    q, t, p = jobs
    got = _plain(q, t, p, variant)
    assert got.dtype == np.int32 and got.shape == (len(q), 128)
    assert (got[:, 6:] == 0).all()
    want = jax_real(variant, q, t, p)
    assert got.tolist() == want.tolist()
    if variant.startswith("no-"):
        # no comparison is vacuous: the stripped feature shows
        full = jax_real("full", q, t, p)
        assert (want[:, :6] != full[:, :6]).any(1).sum() >= 1


def test_full_equals_k1_pallas_and_oracle(jobs):
    q, t, p = jobs
    got = _plain(q, t, p, "full")[:, :6]
    assert got.tolist() == _k1_pallas(q, t, p).tolist()
    mat = MemOpt().scoring_matrix().astype(np.int32)
    want = []
    for qi, ti, pi in zip(q, t, p):
        ql, tl, h0, w, eb = (int(x) for x in pi[:5])
        r = ksw_extend(ql, qi[:ql], tl, ti[:tl], mat, 6, 1, 6, 1, w, eb,
                       xr.ZDROP, h0)
        want.append([r.score, r.qle, r.tle, r.gtle, r.gscore, r.max_off])
    assert got.tolist() == want


def _edge(step):
    """Jobs on the domain's edges (tlen = the tile's rows, h0 + a*qlen =
    HMAX) when step is 0, one step past them when step is 1."""
    rng = np.random.default_rng(9)
    q, t, p = make_jobs(rng, 16, 128, 256)
    p = np.ascontiguousarray(p)
    p[::4, 1] = 256 + step
    p[1::4, 2] = HMAX - p[1::4, 0] + step
    return q, t, p


@pytest.mark.parametrize("variant", ["full", "rollred-fused-u4"])
def test_domain_edge_inside_is_equal(jax_real, variant):
    q, t, p = _edge(0)
    assert int(p[:, 1].max()) == 256
    assert int((p[:, 2] + p[:, 0]).max()) == HMAX
    assert (_plain(q, t, p, variant).tolist()
            == jax_real(variant, q, t, p).tolist())


@pytest.mark.parametrize("fn", [xr.extend_real, xr.extend_real_plain])
def test_domain_outside_raises(fn):
    q, t, p = _edge(1)
    qt, tt, pt = (torch.from_numpy(x) for x in (q, t, p))
    tl = pt.clone()
    tl[:, 2] = 10                            # only tlen past the edge
    with pytest.raises(ValueError, match="tlen <= 256"):
        fn(qt, tt, tl, "full")
    h0 = pt.clone()
    h0[:, 1] = 200                           # only h0 past the edge
    with pytest.raises(ValueError, match="K1-real domain"):
        fn(qt, tt, h0, "full")
    # 129 query lanes: not a power of two
    q129 = torch.cat([qt, torch.full((len(qt), 1), 4, dtype=torch.int32)],
                     1)
    ok = h0.clone()
    ok[:, 2] = 10
    with pytest.raises(ValueError, match="power of two"):
        fn(q129, tt, ok, "full")
    with pytest.raises(ValueError, match="unknown variant"):
        fn(qt, tt, ok, "no-such")


def test_wrapper_routes_cpu_to_plain_and_checks_inputs():
    rng = np.random.default_rng(3)
    q, t, p = (torch.from_numpy(np.ascontiguousarray(x))
               for x in make_jobs(rng, 8, 128, 256))
    before = xr.extend_real.launches
    for variant in ("full", "no-trim"):
        got = xr.extend_real(q, t, p, variant)
        assert torch.equal(got, xr.extend_real_plain(q, t, p, variant))
    # the launch count is the kernel's: the plain version adds nothing
    assert xr.extend_real.launches == before
    with pytest.raises(TypeError):
        xr.extend_real(q.long(), t, p)
    with pytest.raises(ValueError):
        xr.extend_real(q, t[:3], p)
    empty = xr.extend_real(q[:0], t[:0], p[:0])
    assert empty.shape == (0, 128)


def test_main_runs_timing_and_fuzz_on_cpu(capsys):
    res = xr.main(["--device", "cpu", "--jobs", "16", "--k1", "1", "--k2",
                   "2", "--trials", "1", "--fuzz", "1"])
    out = capsys.readouterr().out
    assert "equality fuzz: 0 mismatching" in out
    assert out.count("out == real") == 4
    assert res["fuzz_mismatches"] == 0 and res["fuzz_jobs"] == 64
    (row,) = res["timing"]
    # a difference of two host-clock windows: finite, of either sign
    assert row["N"] == 16 and math.isfinite(row["full_ms"])
    assert set(row) == {"N", "real-import_ms", *(f"{v}_ms" for v in
                                                   xr.TIMED)}


def test_main_cuda_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        xr.main(["--device", "cuda", "--jobs", "8"])


def test_adversarial_jobs_lie_in_the_domain():
    q, t, p = xr.adversarial_jobs(np.random.default_rng(1))
    assert q.shape == (xr.FUZZ_JOBS, xr.NL) and t.shape[1] == xr.TMAX
    xr.check_real(*(torch.from_numpy(x) for x in (q, t, p)))

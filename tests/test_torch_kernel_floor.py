"""tpubwa_torch's K1-floor (extend_kernel.py with ``ablate``/``trees``,
and tpubwa_torch/scripts/exp_kernel_floor.py) against the JAX kernel's
own ablations (extend_pallas.extend_batch_pallas(..., interpret=True,
trees=..., ablate=...)) on the same numpy-seeded jobs.  Tolerance 0:
every output is an exact integer."""
import numpy as np
import pytest
import torch

import tpubwa.device  # noqa: F401  (x64, as the JAX package runs)
import jax.numpy as jnp
from tpubwa.device import extend_pallas as jx
from tpubwa_torch.device import extend_kernel as tk
from tpubwa_torch.scripts import exp_kernel_floor as xf
from tpubwa_torch.scripts import exp_kernel_real as xr
from chip_smoke import make_jobs

SCORING, ZDROP = xr.SCORING, xr.ZDROP
# (trees, ablate): the five exact layouts, then every ablation
SPECS = ([(trees, ()) for trees in tk.TREES]
         + [("split", (x,)) for x in ("scan", "pk", "hopen", "trim",
                                      "trees")]
         + [("split", ("scan", "trees"))])


def insertion_jobs(rng, n):
    """n jobs whose query carries 1-6 inserted bases: only the F gap
    (along the query) crosses them, so -scan differs from full."""
    q = np.full((n, 128), 4, np.int32)
    t = np.full((n, 256), 4, np.int32)
    p = np.zeros((n, 128), np.int32)
    for i in range(n):
        ql = int(rng.integers(40, 120))
        base = rng.integers(0, 4, 300)
        cut = int(rng.integers(5, ql - 5))
        ins = rng.integers(0, 4, int(rng.integers(1, 7)))
        q[i, :ql] = np.concatenate([base[:cut], ins, base[cut:]])[:ql]
        tl = int(rng.integers(ql, 256))
        t[i, :tl] = base[:tl]
        p[i, :5] = (ql, tl, int(rng.integers(10, 80)),
                    int(rng.choice([10, 25, 100])), 5)
    return q, t, p


@pytest.fixture(scope="module")
def jobs():
    """56 jobs: make_jobs' adversarial set (SNPs, indels, N codes, empty
    sides), the script's perfect matches, jobs that z-drop stops, and
    jobs with insertions."""
    rng = np.random.default_rng(5)
    parts = [make_jobs(rng, 32, 128, 256), xf.floor_jobs(8),
             xr.zdrop_jobs(rng, 8), insertion_jobs(rng, 8)]
    q = np.concatenate([x[0] for x in parts])
    t = np.concatenate([x[1] for x in parts])
    p = np.zeros((len(q), 128), np.int32)
    p[:, :5] = np.concatenate([x[2][:, :5] for x in parts])
    return q, t, p


@pytest.fixture(scope="module")
def jax_floor(jobs):
    cache = {}

    def run(trees, ablate):
        if (trees, ablate) not in cache:
            q, t, p = jobs
            cache[trees, ablate] = np.asarray(jx.extend_batch_pallas(
                jnp.asarray(q), jnp.asarray(t), jnp.asarray(p), *SCORING,
                ZDROP, t.shape[1], interpret=True, trees=trees,
                ablate=ablate))[:, :6]
        return cache[trees, ablate]
    return run


def _plain(jobs, **kw):
    q, t, p = (torch.from_numpy(x) for x in jobs)
    return tk.extend_batch_plain(q, t, p, *SCORING, ZDROP, **kw).numpy()


@pytest.mark.parametrize("trees,ablate", SPECS)
def test_plain_equals_jax_floor(jobs, jax_floor, trees, ablate):
    got = _plain(jobs, ablate=ablate, trees=trees)
    want = jax_floor(trees, ablate)
    assert got.tolist() == want.tolist()
    full = jax_floor("split", ())
    if ablate:
        # no comparison is vacuous: the ablation shows on some job
        assert (want != full).any(1).sum() >= 1
    else:
        assert want.tolist() == full.tolist()


@pytest.mark.parametrize("fn", [tk.extend_batch, tk.extend_batch_plain])
def test_unknown_names_raise(fn):
    rng = np.random.default_rng(3)
    q, t, p = (torch.from_numpy(np.ascontiguousarray(x))
               for x in make_jobs(rng, 4, 128, 256))
    with pytest.raises(ValueError, match="unknown ablate"):
        fn(q, t, p, *SCORING, ZDROP, ablate=("scan", "nope"))
    with pytest.raises(ValueError, match="unknown trees"):
        fn(q, t, p, *SCORING, ZDROP, trees="nope")


def test_ablate_mask_bits():
    assert tk.ablate_mask() == 0 and tk.ablate_mask((), "mxuscan") == 0
    assert tk.ablate_mask(("scan",)) == 1
    assert tk.ablate_mask(("trees",)) == tk.ablate_mask(("pk", "hopen",
                                                         "trim")) == 14
    assert tk.ablate_mask(("scan", "trees")) == 15


def test_wrapper_routes_cpu_to_plain():
    rng = np.random.default_rng(3)
    q, t, p = (torch.from_numpy(np.ascontiguousarray(x))
               for x in make_jobs(rng, 8, 128, 256))
    before = (tk.extend_batch.launches, tk.extend_batch.floor_launches)
    for ablate in ((), ("scan",), ("scan", "trees")):
        got = tk.extend_batch(q, t, p, *SCORING, ZDROP, ablate=ablate)
        assert torch.equal(got, tk.extend_batch_plain(
            q, t, p, *SCORING, ZDROP, ablate=ablate))
    # the launch counts are the kernels': the plain version adds nothing
    assert (tk.extend_batch.launches,
            tk.extend_batch.floor_launches) == before


def test_floor_jobs_are_the_scripts():
    """scripts/exp_kernel_floor.py:make_variant's jobs (:41-50)."""
    rng = np.random.default_rng(0)
    N, QL, TL = 64, 100, 200
    tpl = rng.integers(0, 4, TL + N).astype(np.int32)
    q, t, p = xf.floor_jobs(N)
    for i in range(N):
        assert (t[i, :TL] == tpl[i:i + TL]).all() and (t[i, TL:] == 4).all()
        assert (q[i, :QL] == tpl[i:i + QL]).all() and (q[i, QL:] == 4).all()
        assert p[i, :5].tolist() == [QL, TL, 60, 100, 5]


def test_main_prints_the_seven_rows_on_cpu(capsys):
    res = xf.main(["--device", "cpu", "--jobs", "16", "--passes", "1",
                   "--reps", "2"])
    out = capsys.readouterr().out
    for label, _, _ in xf.SPECS:
        assert f"N=16 {label:16s}:" in out
    assert "ONE binary" in out and "caveat" in out
    assert "scan marginal" in out and "full/* spread" in out
    (row,) = res["timing"]
    assert row["N"] == 16 and set(row["ms"]) == {s[0] for s in xf.SPECS}
    cells = row["cells"]
    assert len({cells[x] for x in xf.FULL}) == 1
    # -scan trims its band sooner on the same jobs; -hopen keeps the loop
    assert 0 < cells["-scan"] < cells["full/split"] == cells["-hopen"]


def test_main_cuda_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        xf.main(["--device", "cuda", "--jobs", "8"])

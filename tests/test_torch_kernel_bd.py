"""tpubwa_torch's K1-bd (tpubwa_torch/scripts/exp_kernel_breakdown.py)
against the JAX experiment's kernel (scripts/exp_kernel_breakdown.py:
build_kernel, every variant, interpret mode) on the same numpy-seeded
jobs.  Tolerance 0: every output is an exact integer.  The sets hold
launches whose jobs' results depend on each other: jobs that die at
different rows, alone and beside a job that survives."""
import functools
import math
import os

import numpy as np
import pytest
import torch

import tpubwa.device  # noqa: F401  (x64, as the JAX package runs)
import jax.experimental.pallas as jpl
import jax.numpy as jnp
from tpubwa_torch.scripts import exp_kernel_breakdown as xb
from chip_smoke import make_jobs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cat(*parts):
    q = np.concatenate([x[0] for x in parts])
    t = np.concatenate([x[1] for x in parts])
    p = np.zeros((len(q), 128), np.int32)
    p[:, :5] = np.concatenate([x[2][:, :5] for x in parts])
    return q, t, p


@pytest.fixture(scope="module")
def sets():
    """Five launches: 16 jobs that each die at a row of their own; the
    same beside one of the script's jobs, which survives; 40 mixed jobs
    (make_jobs' SNPs, indels and N codes, one with qlen 0, two with
    tlen <= 0, the script's jobs, dying jobs: N = 40 < max tlen, where
    tdot's row cap bites); 16 jobs on a 252-row tile, where t8-slice's
    clipped strip and unroll2's extra row show; 5 jobs whose frozen trim
    reads columns above their last live row's end_i."""
    rng = np.random.default_rng(17)
    dying = xb.dying_jobs(rng, 16)
    mixed = _cat(make_jobs(rng, 16, 128, 256), xb.bd_jobs(8),
                 xb.dying_jobs(rng, 16))
    mixed[2][0, 0] = 0
    mixed[2][1, 1] = 0
    mixed[2][2, 1] = -2
    return {"dying": dying,
            "dying+survivor": _cat(dying, xb.bd_jobs(1)),
            "mixed": mixed,
            "clip252": xb.clip_jobs(rng, 16),
            "frozen_edge": xb.frozen_edge_jobs(rng, 4)}


def _plain(q, t, p, variant, stats=None):
    return xb.extend_bd_plain(
        *(torch.from_numpy(np.ascontiguousarray(x)) for x in (q, t, p)),
        variant, stats=stats).numpy()


@pytest.fixture(scope="module")
def jax_bd():
    """build_kernel(variant, tmax) of scripts/exp_kernel_breakdown.py,
    run in interpret mode: the script calls pl.pallas_call without
    interpret=, so pallas_call is patched here."""
    with pytest.MonkeyPatch.context() as mp:
        mp.syspath_prepend(os.path.join(ROOT, "scripts"))
        from exp_kernel_breakdown import build_kernel
    cache = {}

    def run(variant, q, t, p):
        key = (variant, q.tobytes(), t.tobytes(), p.tobytes())
        if key not in cache:
            with pytest.MonkeyPatch.context() as mp:
                mp.setattr(jpl, "pallas_call", functools.partial(
                    jpl.pallas_call, interpret=True))
                cache[key] = np.asarray(build_kernel(variant, t.shape[1])(
                    jnp.asarray(q), jnp.asarray(t), jnp.asarray(p)))
        return cache[key]
    return run


@pytest.mark.parametrize("variant", xb.VARIANTS)
def test_plain_equals_jax_variant(sets, jax_bd, variant):
    for name, (q, t, p) in sets.items():
        got = _plain(q, t, p, variant)
        assert got.dtype == np.int32 and got.shape == (len(q), 128)
        assert (got[:, 4:] == 0).all()
        assert got.tolist() == jax_bd(variant, q, t, p).tolist(), name


@pytest.mark.parametrize("variant", xb.VARIANTS[1:])
def test_variant_differs_from_baseline(sets, jax_bd, variant):
    """No comparison is vacuous: each variant's removed piece shows on
    at least one job of the sets."""
    differs = sum(int((jax_bd(variant, *s)[:, :4]
                       != jax_bd("baseline", *s)[:, :4]).any(1).sum())
                  for s in sets.values())
    assert differs >= 1


def test_jobs_are_coupled_across_the_launch(sets, jax_bd):
    """A dying job run alone stops where it dies; in the launch it runs
    on, frozen, while others live, and its trim and best move: its
    result differs.  Both versions agree job by job, alone too."""
    q, t, p = sets["dying"]
    launch = jax_bd("baseline", q, t, p)
    assert launch[:, 3].tolist() == [1] * len(q)
    assert _plain(q, t, p, "baseline").tolist() == launch.tolist()
    differ = 0
    for k in range(4):
        one = tuple(x[k:k + 1] for x in (q, t, p))
        alone = jax_bd("baseline", *one)
        assert _plain(*one, "baseline").tolist() == alone.tolist()
        differ += alone[0, :4].tolist() != launch[k, :4].tolist()
    assert differ >= 1


def test_frozen_rows_read_above_the_last_live_end(sets):
    """Frozen rows read columns above the end_i of a job's last live
    row, which the JAX kernel holds at h 0: baseline's frozen trim moves
    end there on frozen_edge_jobs and on make_jobs (the mixed launch),
    and the sets reach it under every variant but no-transpose and
    no-roll (whose last live row leaves h 0 on column end_i); no-trim's
    window goes there by itself.  All equal the JAX kernel
    (test_plain_equals_jax_variant)."""
    reached = set()
    for name, (q, t, p) in sets.items():
        for v in xb.VARIANTS:
            stats = {}
            _plain(q, t, p, v, stats)
            assert stats["cells"] == (stats["live_cells"]
                                      + stats["frozen_cells"])
            if stats["frozen_above_live_end"]:
                reached.add((name, v))
    assert {("frozen_edge", "baseline"), ("mixed", "baseline")} <= reached
    assert {v for _, v in reached} == set(xb.VARIANTS) - {"no-transpose",
                                                          "no-roll"}


def test_job_sets_do_what_they_say():
    rng = np.random.default_rng(2)
    q, t, p = xb.dying_jobs(rng, 8)
    alone = [_plain(q[k:k + 1], t[k:k + 1], p[k:k + 1], "baseline")[0]
             for k in range(8)]
    assert [int(a[3]) for a in alone] == [1] * 8
    q, t, p = xb.clip_jobs(rng, 8)
    assert t.shape == (8, 252)
    pad = np.concatenate([t, np.full((8, 4), 4, np.int32)], 1)
    clipped = _plain(q, t, p, "t8-slice")
    unclipped = _plain(q, pad, p, "t8-slice")
    assert (clipped[:, :4] != unclipped[:, :4]).any(1).sum() >= 1
    base = _plain(q, t, p, "baseline")[:, :4]
    assert (_plain(q, t, p, "unroll2")[:, :4] != base).any(1).sum() >= 1
    q, t, p = xb.bd_jobs(4)
    assert _plain(q, t, p, "baseline")[:, :4].tolist() == \
        [[160, 99, 100, 0]] * 4


@pytest.mark.parametrize("fn", [xb.extend_bd, xb.extend_bd_plain])
def test_domain_outside_raises(fn):
    q, t, p = (torch.from_numpy(x.copy()) for x in xb.bd_jobs(4))
    edge = p.clone()
    edge[0, 1] = 256
    edge[1, 2] = xb.PARAM_LIMIT
    edge[2, 3] = -xb.PARAM_LIMIT
    assert fn(q, t, edge, "baseline").shape == (4, 128)
    for lane, value in ((1, 257), (2, xb.PARAM_LIMIT + 1),
                        (3, -xb.PARAM_LIMIT - 1)):
        bad = p.clone()
        bad[3, lane] = value
        with pytest.raises(ValueError, match="K1-bd domain"):
            fn(q, t, bad, "baseline")
    short = torch.clamp(p, max=7)
    with pytest.raises(ValueError, match="8 rows"):
        fn(q, t[:, :7], short, "t8-slice")
    assert fn(q, t[:, :7], short, "baseline").shape == (4, 128)
    t5 = t.clone()
    t5[0, 0] = 5
    with pytest.raises(ValueError, match="tdot"):
        fn(q, t5, p, "tdot")
    assert fn(q, t5, p, "baseline").shape == (4, 128)
    with pytest.raises(ValueError, match="qlen"):
        big = p.clone()
        big[0, 0] = 128
        fn(q, t, big, "baseline")
    with pytest.raises(TypeError):
        fn(q.long(), t, p, "baseline")
    with pytest.raises(ValueError, match="unknown variant"):
        fn(q, t, p, "no-such")


def test_wrapper_routes_cpu_to_plain_and_counts_launches():
    rng = np.random.default_rng(3)
    q, t, p = (torch.from_numpy(np.ascontiguousarray(x))
               for x in make_jobs(rng, 8, 128, 256))
    before = xb.extend_bd.launches
    for variant in ("baseline", "tdot", "no-trim"):
        got = xb.extend_bd(q, t, p, variant)
        assert torch.equal(got, xb.extend_bd_plain(q, t, p, variant))
    # the launch count is the kernel's: the plain version adds nothing
    assert xb.extend_bd.launches == before
    stats = {}
    xb.extend_bd_plain(q, t, p, stats=stats)
    assert stats["cells"] > 0
    assert xb.extend_bd(q[:0], t[:0], p[:0]).shape == (0, 128)


def test_main_times_every_variant_on_cpu(capsys):
    res = xb.main(["--device", "cpu", "--jobs", "6", "--passes", "1",
                   "--reps", "2"])
    out = capsys.readouterr().out
    assert out.count("ms/launch") == len(xb.VARIANTS)
    assert out.count("delta vs base") == len(xb.VARIANTS) - 1
    (row,) = res["timing"]
    assert row["N"] == 6 and set(row["ms"]) == set(xb.VARIANTS)
    # a CPU time here is the difference of two host-clock windows (2
    # launches less 1), which noise can turn negative: a run without a
    # card can promise a finite time for each variant, and the cells
    assert all(math.isfinite(ms) for ms in row["ms"].values())
    assert row["cells"]["baseline"] > row["cells"]["no-transpose"] > 0


def test_main_cuda_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        xb.main(["--device", "cuda", "--jobs", "8"])

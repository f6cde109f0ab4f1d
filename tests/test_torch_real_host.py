"""K1-real through csrc/extend.cu's C entry tpubwa_extend_real, compiled
for the host against csrc/warp_host.h (a warp's 32 lanes in lockstep)
under ASan/UBSan, against extend_real_plain, tolerance 0; and the plain
identities that let K1-real's variants share K1's instantiations.  What
the GPU's compiler makes of the source (the unrolled -u2/-u4 loops
among it) shows only on a card."""
import numpy as np
import pytest
import torch

from tpubwa_torch.device import extend_kernel as tk
from tpubwa_torch.device import warp_host
from tpubwa_torch.scripts import exp_kernel_real as xr
from chip_smoke import make_jobs

HMAX = ((1 << 31) - xr.NL) // xr.NL       # largest h0 + a*qlen allowed


@pytest.fixture(scope="module")
def jobs():
    """9 jobs (the lockstep costs a fiber switch a lane a warp
    operation; the card runs the full sets): make_jobs' SNPs, indels, N
    codes and empty sides, a perfect match of the script's, two jobs
    that only z-drop stops and two whose best path needs the band
    write-back.  Each no-* variant differs from full on one at least."""
    rng = np.random.default_rng(5)
    parts = [tuple(x[::4] for x in make_jobs(rng, 16, 128, 256)),
             tuple(x[:1] for x in xr.script_jobs(rng, 4)),
             tuple(x[4:6] for x in xr.zdrop_jobs(rng, 8)),
             tuple(x[:2] for x in xr.wbmask_jobs(rng, 8))]
    return tuple(np.ascontiguousarray(np.concatenate([x[k][:, :w]
                                                     for x in parts]))
                 for k, w in ((0, 128), (1, 256), (2, 5)))


def _plain(arrays, variant):
    return xr.extend_real_plain(*(torch.from_numpy(x) for x in arrays),
                                variant).numpy()


def _host(jobs, variants, reverse=False):
    """{variant: int32 [N, 128]}: one harness run for each scoring the
    variants' launches take (no-zdrop's z-drop is 0)."""
    out = {}
    for scoring in dict.fromkeys(map(xr.launch_scoring, variants)):
        names = [v for v in variants if xr.launch_scoring(v) == scoring]
        got = warp_host.extend_real_host(
            *jobs, [xr.VARIANTS.index(v) for v in names], scoring, reverse)
        out.update(zip(names, got))
    return out


@pytest.fixture(scope="module")
def host(jobs):
    return _host(jobs, xr.VARIANTS)


def _held(got, want, what):
    # lanes 0-5 are the kernel's; it leaves lanes 6-127 as it found them
    assert (got[:, 6:] == -77).all(), what
    bad = np.nonzero((got[:, :6] != want[:, :6]).any(1))[0][:3]
    assert not len(bad), (what, bad.tolist(), got[bad, :6].tolist(),
                          want[bad, :6].tolist())


@pytest.mark.parametrize("variant", xr.VARIANTS)
def test_variant_through_the_new_entry_equals_plain(jobs, host, variant):
    want = _plain(jobs, variant)
    _held(host[variant], want, variant)
    if variant.startswith("no-"):
        # no comparison is vacuous: the stripped feature shows
        assert (want[:, :6] != _plain(jobs, "full")[:, :6]).any(1).sum() >= 1


def test_lane_order_does_not_matter_for_the_write_back(jobs):
    """no-wbmask's full-row pass and full's band pass with each warp's
    lanes run 31..0."""
    for v, out in _host(jobs, ("full", "no-wbmask"), reverse=True).items():
        _held(out, _plain(jobs, v), v)


@pytest.mark.parametrize("variant", [-1, len(xr.VARIANTS)])
def test_an_unknown_variant_launches_nothing(jobs, variant):
    with pytest.raises(RuntimeError, match=f"variant {variant} returned 1 "
                       "after 0 launches"):
        warp_host.extend_real_host(*jobs, (variant,),
                                   xr.launch_scoring("full"))


def test_packed_argmax_edge():
    """h0 + a*qlen = HMAX, the largest row max whose (H << 7) | j fits
    int32: the host kernel equals plain there; one past it, check_real
    and K1's own _check both refuse the jobs."""
    rng = np.random.default_rng(9)
    q, t, p = (np.ascontiguousarray(x[:4]) for x in make_jobs(rng, 16, 128,
                                                              256))
    p[:, 2] = HMAX - p[:, 0]
    assert (p[:, 1] > 0).all() and int((p[:, 0] + p[:, 2]).max()) == HMAX
    got = _host((q, t, p), ("full",))["full"]
    want = _plain((q, t, p), "full")
    _held(got, want, "full at the edge")
    assert (want[:, 0] > HMAX - 200).all()      # the row max is near it
    qt, tt, pt = (torch.from_numpy(x) for x in (q, t, p))
    pt[0, 2] += 1
    with pytest.raises(ValueError, match="K1-real domain"):
        xr.check_real(qt, tt, pt)
    with pytest.raises(ValueError, match="h0 \\+ a \\* qlen must not exceed"):
        tk._check(qt, tt, pt, xr.SCORING[0])


# plain identities behind the shared instantiations, on the jobs of
# tests/test_torch_kernel_real.py's size


@pytest.fixture(scope="module")
def plain_jobs():
    rng = np.random.default_rng(7)
    parts = [make_jobs(rng, 48, 128, 256), xr.script_jobs(rng, 8),
             xr.zdrop_jobs(rng, 8), xr.wbmask_jobs(rng, 8)]
    return tuple(torch.from_numpy(np.ascontiguousarray(
        np.concatenate([x[k][:, :w] for x in parts])))
        for k, w in ((0, 128), (1, 256), (2, 5)))


def test_no_scan_is_k1_floor_scan(plain_jobs):
    """The script's F = he - 1 (:145-146) is K1-floor's F = NEG."""
    got = xr.extend_real_plain(*plain_jobs, "no-scan")[:, :6]
    assert torch.equal(got, tk.extend_batch_plain(
        *plain_jobs, *xr.SCORING, xr.ZDROP, ablate=("scan",)))
    assert not torch.equal(got, xr.extend_real_plain(*plain_jobs)[:, :6])


def test_no_zdrop_is_k1_with_zdrop_0(plain_jobs):
    got = xr.extend_real_plain(*plain_jobs, "no-zdrop")[:, :6]
    assert torch.equal(got, tk.extend_batch_plain(*plain_jobs, *xr.SCORING,
                                                  0))
    assert not torch.equal(got, xr.extend_real_plain(*plain_jobs)[:, :6])


def test_exact_variants_are_one_function(plain_jobs):
    """full, rollred-fused (the roll trees and the packed argmax) and the
    unrolled -u2/-u4 all compute K1."""
    k1 = tk.extend_batch_plain(*plain_jobs, *xr.SCORING, xr.ZDROP)
    for v in xr.TIMED:
        assert torch.equal(xr.extend_real_plain(*plain_jobs, v)[:, :6], k1), v

"""csrc/extend.cu's kernels, compiled for the host against
csrc/warp_host.h (a warp's 32 lanes in lockstep, its shuffles, reductions
and ballots by a loop over the lanes) under ASan/UBSan, against
extend_batch_plain with the same ablation.  Tolerance 0.  What the GPU's
compiler makes of the source shows only on a card; its logic, its
memory accesses and the lockstep of its warp operations show here."""
import numpy as np
import pytest
import torch

from tpubwa_torch.device import extend_kernel as tk
from tpubwa_torch.device import warp_host
from tpubwa_torch.scripts import exp_kernel_floor as xf
from chip_smoke import FLOOR_SPECS, make_jobs

PEN = (*xf.SCORING, xf.ZDROP)
FLOOR_MASKS = tuple(tk.ablate_mask(s) for s in FLOOR_SPECS)


def _ablate(mask):
    return tuple(x for x in ("scan", "pk", "hopen", "trim")
                 if max(mask, 0) & tk.ABLATE_BITS[x])


def _held(arrays, masks, zdrop=xf.ZDROP, reverse=False):
    """Every mask's host kernel == the plain version with its ablation;
    returns {mask: result}."""
    q, t, p = arrays
    pen = (*xf.SCORING, zdrop)
    got = warp_host.extend_host(q, t, p, *pen, masks=masks, reverse=reverse)
    for mask, out in zip(masks, got):
        want = tk.extend_batch_plain(
            *(torch.from_numpy(np.ascontiguousarray(x)) for x in (q, t, p)),
            *pen, ablate=_ablate(mask)).numpy()
        bad = np.nonzero((out != want).any(1))[0][:3]
        assert not len(bad), (mask, bad.tolist(), out[bad].tolist(),
                              want[bad].tolist())
    return dict(zip(masks, got))


def _edges(W, tmax, every=slice(None)):
    sets = xf.strip_edge_jobs(W, tmax)
    return tuple(np.concatenate([s[k] for s in sets.values()])[every]
                 for k in range(3))


def test_k1_and_the_floor_specs_on_the_strip_edges_at_w128():
    """Mask 0, mask 0 through the floor entry (-1) and the six floor
    specs on every sixth job (the lockstep costs two fiber switches a
    lane a warp operation; the card runs every job)."""
    got = _held(_edges(128, 256, slice(0, None, 6)), (0, -1, *FLOOR_MASKS))
    assert (got[0] == got[-1]).all()
    # no comparison is vacuous: each ablation shows on some job
    assert all((got[m] != got[0]).any() for m in FLOOR_MASKS)


@pytest.mark.parametrize("W,tmax", [(256, 512), (512, 512)])
def test_wider_tiles_on_the_strip_edges(W, tmax):
    """Bands of up to 13 strips a row, 4 KB of row a job: gap runs
    under w 100 and 200, band residues, closed bands, qlen W - 1."""
    _held(_edges(W, tmax, slice(2, None, 6)), (0,))


def test_lane_order_does_not_matter():
    """The lanes of a warp run 31..0: a result that moved with the order
    would mean a lane reads what another wrote with no __syncwarp
    between."""
    _held(_edges(128, 256, slice(1, None, 4)), (0, 1), reverse=True)


def test_every_instantiation_on_make_jobs():
    """All 16 masks on SNPs, small indels, N codes, empty targets and
    queries, with a job past the last full block."""
    got = _held(make_jobs(np.random.default_rng(141), 21, 128, 256),
                tuple(range(16)))
    assert all((got[m] != got[0]).any() for m in range(1, 16))


def test_k1_without_zdrop_on_make_jobs():
    _held(make_jobs(np.random.default_rng(41), 13, 128, 256), (0,), zdrop=0)


def test_k1_and_the_floor_specs_on_the_experiments_jobs():
    """The floor script's perfect matches (bands of three strips) and
    jobs that z-drop stops."""
    from tpubwa_torch.scripts import exp_kernel_real as xr
    parts = [xf.floor_jobs(1), xr.zdrop_jobs(np.random.default_rng(8), 4)]
    arrays = tuple(np.concatenate([np.asarray(x[k])[:, :w] for x in parts])
                   for k, w in ((0, 128), (1, 256), (2, 5)))
    _held(arrays, (0, *FLOOR_MASKS))


def test_a_write_past_the_block_is_reported():
    """The harness sees what compute-sanitizer would: a qlen past the
    tile (which the wrapper's _check refuses) runs the last warp of a
    block past its query bytes."""
    q, t, p = make_jobs(np.random.default_rng(5), 4, 128, 256)
    p[3, :2] = (128 + 40, 8)
    with pytest.raises(RuntimeError, match="AddressSanitizer"):
        warp_host.extend_host(q, t, p, *PEN)


def test_an_unknown_mask_launches_nothing():
    q, t, p = make_jobs(np.random.default_rng(5), 4, 128, 256)
    with pytest.raises(RuntimeError, match="mask 16 returned"):
        warp_host.extend_host(q, t, p, *PEN, masks=(16,))

"""csrc/extend_bd.cu's two kernels (K1-bd: a warp per job in the live
and the frozen pass), compiled for the host against csrc/warp_host.h (a
warp's 32 lanes in lockstep, the atomics and the stream's order) under
ASan/UBSan, against extend_bd_plain, tolerance 0, every variant in both
lane orders.  The sets are small (the lockstep costs two fiber switches
a lane a warp operation); the card runs the full ones.  What the GPU's
compiler makes of the source shows only on a card."""
import numpy as np
import pytest
import torch

from tpubwa_torch.device import warp_host
from tpubwa_torch.scripts import exp_kernel_breakdown as xb
from tpubwa_torch.scripts import exp_kernel_floor as xf
from chip_smoke import make_jobs


def _cat(*parts):
    q = np.concatenate([x[0] for x in parts])
    t = np.concatenate([x[1] for x in parts])
    p = np.zeros((len(q), 128), np.int32)
    p[:, :5] = np.concatenate([x[2][:, :5] for x in parts])
    return q, t, p


def _sets():
    """{name: (q, t, p)}: one of the script's jobs (no frozen row), jobs
    that die at rows of their own (alone, and beside a survivor under a
    narrow band, which keeps the launch to its tile), a 252-row tile
    (t8-slice's clip, unroll2's extra row), make_jobs (frozen bands)
    with a job of qlen 0, of tlen 0 and -2, of w -1, of h0 -5 and query
    codes past the bases (N above 3, and negative), strip-edge jobs whose
    bands cross 32-column edges at every residue (w 15-17) and under an
    F run of 33 columns, and jobs whose frozen trim reads above their
    last live row's end_i."""
    rng = np.random.default_rng(11)
    dying = xb.dying_jobs(rng, 4)
    survivor = xb.bd_jobs(1)
    survivor[2][0, 3] = 5
    q, t, p = make_jobs(rng, 8, 128, 256)
    p[0, 0] = 0
    p[1, 1] = 0
    p[2, 1] = -2
    p[3, 3] = -1
    p[4, 2] = -5
    q[5] = np.where(rng.random(128) < 0.1, rng.integers(-3, 7, 128), q[5])
    edges = xf.strip_edge_jobs(128, 256)
    return {"script": xb.bd_jobs(1),
            "dying": dying,
            "dying+survivor": _cat(dying, survivor),
            "clip252": xb.clip_jobs(rng, 2),
            "make_jobs": (q, t, p),
            "strip_edges": _cat(
                tuple(x[1:4] for x in edges["residues"]),
                tuple(x[:1] for x in edges["ins_run"])),
            "frozen_edge": xb.frozen_edge_jobs(rng, 3)}


SETS = _sets()


def _plain(q, t, p, variant, stats=None):
    return xb.extend_bd_plain(
        *(torch.from_numpy(np.ascontiguousarray(x)) for x in (q, t, p)),
        variant, stats=stats).numpy()


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("name", list(SETS))
def test_kernel_equals_plain(name, reverse):
    """Every variant through the C entry, both passes; 31..0 would show
    a lane that reads what another wrote with no __syncwarp between.
    Lanes 4-127 stay as the harness filled them."""
    q, t, p = SETS[name]
    got = warp_host.extend_bd_host(q, t, p, range(len(xb.VARIANTS)),
                                   reverse=reverse)
    for v, out in zip(xb.VARIANTS, got):
        want = _plain(q, t, p, v)
        bad = np.nonzero((out[:, :4] != want[:, :4]).any(1))[0][:3]
        assert not len(bad), (v, bad.tolist(), out[bad, :4].tolist(),
                              want[bad, :4].tolist())
        assert (out[:, 4:] == -77).all(), v


def test_the_sets_reach_what_they_are_for():
    """Frozen rows run (make_jobs, clip252), the frozen trim reads above
    the last live end_i (frozen_edge), the dying jobs alone differ from
    the launch beside a survivor, a query code is negative, and a
    strip-edge band takes every beg and end residue mod 32 (read off the
    plain version one row at a time: a job alone with tlen r stops after
    row r - 1)."""
    stats = {name: {} for name in SETS}
    for name, (q, t, p) in SETS.items():
        _plain(q, t, p, "baseline", stats[name])
    assert stats["make_jobs"]["frozen_cells"] > 0
    assert stats["clip252"]["frozen_cells"] > 0
    assert stats["script"]["frozen_cells"] == 0
    assert stats["frozen_edge"]["frozen_above_live_end"] > 0
    q, t, p = SETS["dying+survivor"]
    launch = _plain(q, t, p, "baseline")
    alone = _plain(q[:4], t[:4], p[:4], "baseline")
    assert (launch[:4, :4] != alone[:, :4]).any()
    assert (SETS["make_jobs"][0] < 0).any()
    q, t, p = (x[2:3] for x in SETS["strip_edges"])     # w 17
    begs, ends = set(), set()
    for r in range(64, 97):
        one = p.copy()
        one[0, 1] = r
        out = _plain(q, t, one, "baseline")[0]
        begs.add(int(out[1]) % 32)
        ends.add(int(out[2]) % 32)
    assert begs == ends == set(range(32))


def test_a_block_past_the_cards_shared_memory_is_refused():
    """NL 8,192: 4 warps of 8,192 (h, e) pairs and query codes need
    393,216 bytes, past an H100 block's 232,448; the entry returns the
    error and launches neither pass."""
    q, t, p = xb.bd_jobs(2)
    wide = np.full((2, 8192), 4, np.int32)
    wide[:, :128] = q
    with pytest.raises(RuntimeError, match=r"returned 1 after 0 launches"):
        warp_host.extend_bd_host(wide, t, p, [0])


def test_an_unknown_variant_launches_nothing():
    q, t, p = xb.bd_jobs(1)
    for v in (-1, len(xb.VARIANTS)):
        with pytest.raises(RuntimeError, match=r"returned 1 after 0"):
            warp_host.extend_bd_host(q, t, p, [v])

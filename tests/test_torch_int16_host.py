"""csrc/extend16.cu's kernel (K1-i16: a warp per job, two columns a lane
in 16-bit halves), compiled for the host against csrc/warp_host.h (a
warp's 32 lanes in lockstep, the 16x2 intrinsics from their documented
meaning) under ASan/UBSan, against extend_batch16_plain, tolerance 0, in
both lane orders; the host intrinsics against a numpy model; and the
64-column strip-edge jobs.  What the GPU's compiler makes of the source
shows only on a card."""
import hashlib

import numpy as np
import pytest
import torch

from tpubwa_torch.device import warp_host
from tpubwa_torch.scripts import exp_int16_kernel as x16
from tpubwa_torch.scripts import exp_kernel_floor as xf
from chip_smoke import CAP_SCORING, capped_band_jobs, make_jobs
from test_torch_int16_kernel import PEN, _edge_case


def _sets():
    """{name: (q, t, p, scoring)}, small: the lockstep costs two fiber
    switches a lane a warp operation (about a second a job at W 512);
    the card runs the full sets."""
    sets = {}
    for W, tmax, n in ((128, 256, 12), (256, 512, 6), (512, 512, 3)):
        sets[f"make_jobs_{W}"] = (*make_jobs(np.random.default_rng(W + 1), n,
                                             W, tmax), PEN)
    sets["fuzz"] = (*x16.fuzz_jobs(np.random.default_rng(0), 24), x16.SCORING)
    q, t, p, pen, gap = _edge_case("in")
    sets["h0_edge"] = (q, t, p, pen)
    sets["gap_edge"] = (q, t, p.clip(0, 60), gap)
    for W, tmax, every in ((128, 256, 1), (256, 512, 3), (512, 512, 5)):
        edges = xf.strip_edge_jobs(W, tmax, strip=64)
        sets[f"strip_edges64_{W}"] = (*(np.concatenate(
            [s[k] for s in edges.values()])[::every] for k in range(3)),
            xf.SCORING)
    # the band's end moves up by 2 at row 14, so the next row reads
    # column end + 1's stale pair, which the boundary store must keep
    sets["end_plus_2"] = (*(x[435:436] for x in make_jobs(
        np.random.default_rng(13), 1500, 128, 256)), PEN)
    # bands of w 1-3, so the cap moves beg to 1 at row w + 1 while column
    # 0 holds (h1, E) from row w; an insertion that opens for e_ins alone
    # would carry that stale h1 into the band, had the column below an
    # odd beg not read as (0, 0)
    sets["beg1_cap"] = (*capped_band_jobs(np.random.default_rng(1), 12),
                        CAP_SCORING)
    # codes past the bases: N above 3, and negative codes, which match
    # only themselves (the profile's sixth row)
    rng = np.random.default_rng(9)
    q, t, p = make_jobs(rng, 8, 128, 256)
    q = np.where(rng.random(q.shape) < 0.1, rng.integers(-3, 7, q.shape), q)
    t = np.where(rng.random(t.shape) < 0.1, rng.integers(-3, 7, t.shape), t)
    sets["odd_codes"] = (q.astype(np.int32), t.astype(np.int32), p, PEN)
    return sets


SETS = _sets()


def _plain(q, t, p, pen, zdrop):
    return x16.extend_batch16_plain(
        *(torch.from_numpy(np.ascontiguousarray(x)) for x in (q, t, p)),
        *pen, zdrop).numpy()


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("name", list(SETS))
def test_kernel_equals_plain(name, reverse):
    """Each set in both lane orders (31..0 would show a lane that reads
    what another wrote with no __syncwarp between), zdrop 100 in one
    order and 0 in the other."""
    q, t, p, pen = SETS[name]
    zdrop = 0 if reverse else 100
    got = warp_host.extend16_host(q, t, p, *pen, zdrop, reverse=reverse)
    want = _plain(q, t, p, pen, zdrop)
    bad = np.nonzero((got != want).any(1))[0][:3]
    assert not len(bad), (bad.tolist(), got[bad].tolist(), want[bad].tolist())


def test_the_sets_reach_the_edges_they_name():
    """The domain-edge jobs reach scores near the top of int16, and the
    odd-code jobs hold negative target codes."""
    q, t, p, pen = SETS["h0_edge"]
    assert _plain(q, t, p, pen, 100)[:, 0].max() > 32000
    assert (SETS["odd_codes"][1] < 0).any()
    q, t, p, pen = SETS["end_plus_2"]
    _, facts = xf.band_trace(q[0], t[0], p[0], *pen, 100)
    ends = facts["end"]
    assert any(b == a + 2 for a, b in zip(ends, ends[1:]))


def test_a_block_past_the_cards_shared_memory_is_refused():
    """W 4,096: 4 warps of 6 profile rows and 2,080 row words need
    263,168 bytes, past an H100 block's 232,448; the entry returns the
    error and launches nothing."""
    q, t, p = make_jobs(np.random.default_rng(5), 4, 128, 256)
    wide = np.full((4, 4096), 4, np.int32)
    wide[:, :128] = q
    with pytest.raises(RuntimeError, match=r"returned 1 after 0 launches"):
        warp_host.extend16_host(wide, t, p, *PEN, 100)


def test_a_write_past_the_block_is_reported():
    """The harness sees what compute-sanitizer would: a qlen past the
    tile (which the wrapper's _check refuses) runs the last warp of a
    block past its row and the row's 31 words of padding, the block's
    last bytes, in the first row."""
    q, t, p = make_jobs(np.random.default_rng(5), 4, 128, 256)
    p[3, :2] = (128 + 80, 8)
    with pytest.raises(RuntimeError, match="AddressSanitizer"):
        warp_host.extend16_host(q, t, p, *PEN, 100)


# ---- the host intrinsics ----

EDGE = np.array([0, 1, -1, 2, -2, 32767, -32768, 32766, -32767, 8192,
                 -8192, 24576, -24576, 100, -100], np.int64)


def _words(lo, hi):
    return ((hi & 0xffff) << 16 | (lo & 0xffff)).astype(np.uint32)


def _halves(x):
    """(lo, hi) signed values of each word's halves."""
    return [((x.astype(np.int64) >> k & 0xffff) ^ 0x8000) - 0x8000
            for k in (0, 16)]


def _wrap(x):
    return ((x + 0x8000) & 0xffff) - 0x8000


def _model(name, a, b, c):
    """The CUDA documentation's meaning, a half at a time: sums wrap
    modulo 2^16, max and min compare signed halves."""
    if name == "__byte_perm":
        eight = a.astype(np.uint64) | b.astype(np.uint64) << np.uint64(32)
        out = np.zeros_like(a)
        for n in range(4):
            sel = (c >> np.uint32(4 * n)) & np.uint32(7)
            byte = (eight >> (sel.astype(np.uint64) * np.uint64(8))) & \
                np.uint64(0xff)
            out |= byte.astype(np.uint32) << np.uint32(8 * n)
        return out
    f = {"__vadd2": lambda x, y, z: _wrap(x + y),
         "__vmaxs2": lambda x, y, z: np.maximum(x, y),
         "__vimin_s16x2_relu": lambda x, y, z: np.maximum(np.minimum(x, y),
                                                          0),
         "__viaddmin_s16x2": lambda x, y, z: np.minimum(_wrap(x + y), z),
         "__viaddmax_s16x2": lambda x, y, z: np.maximum(_wrap(x + y), z),
         "__viaddmax_s16x2_relu": lambda x, y, z: np.maximum(
             np.maximum(_wrap(x + y), z), 0)}[name]
    parts = [f(x, y, z) for x, y, z in zip(_halves(a), _halves(b),
                                           _halves(c))]
    return _words(*parts)


def test_host_intrinsics_equal_the_model_on_edge_values():
    """Every pair of edge values in each half (so both signs across the
    two halves, and sums past 32,767 and -32,768 that wrap), and random
    words; the selectors of __byte_perm include the kernel's three."""
    rng = np.random.default_rng(16)
    lo, hi = (x.ravel() for x in np.meshgrid(EDGE, EDGE))
    n = len(lo)
    a = np.concatenate([_words(lo, hi), rng.integers(0, 1 << 32, 256,
                                                     dtype=np.uint64)])
    b = np.concatenate([_words(hi[::-1], lo), rng.integers(0, 1 << 32, 256,
                                                           dtype=np.uint64)])
    c = np.concatenate([_words(np.roll(lo, 7), np.roll(hi, 3)),
                        rng.integers(0, 1 << 32, 256, dtype=np.uint64)])
    a, b, c = (x.astype(np.uint32) for x in (a, b, c))
    c[:3] = (0x1032, 0x5410, 0x7610)
    got = warp_host.intrinsics16_host(a, b, c)
    assert tuple(got) == warp_host.INTRINSICS16
    for name, out in got.items():
        want = _model(name, a, b, c)
        bad = np.nonzero(out != want)[0][:3]
        assert not len(bad), (name, [(hex(a[k]), hex(b[k]), hex(c[k]),
                                      hex(out[k]), hex(want[k]))
                                     for k in bad])
    # the edges are there: a sum that wraps, and one half of each sign
    s = got["__vadd2"][:n]
    assert ((_halves(s)[0] < 0) & (_halves(a[:n])[0] > 0)
            & (_halves(b[:n])[0] > 0)).any()


# ---- the strip-edge jobs at 64 columns ----

def _hash(sets):
    h = hashlib.sha256()
    for name, arrays in sets.items():
        h.update(name.encode())
        for x in arrays:
            h.update(np.ascontiguousarray(x).tobytes())
    return h.hexdigest()[:16]


@pytest.mark.parametrize("W,tmax,digest", [
    (128, 256, "8f4ad2b01f8e7fdb"), (256, 512, "3daf220bb4ca4427"),
    (512, 512, "5d8a4c6b2d2bfad0")])
def test_strip_edge_jobs_at_32_are_unchanged(W, tmax, digest):
    """K1's tests and smoke run these sets: the strip width leaves them
    byte for byte as they were (digests taken before it existed)."""
    assert _hash(xf.strip_edge_jobs(W, tmax)) == digest
    assert _hash(xf.strip_edge_jobs(W, tmax, strip=32)) == digest
    with pytest.raises(ValueError, match="strip"):
        xf.strip_edge_jobs(W, tmax, strip=48)


@pytest.mark.parametrize("W,tmax", xf.STRIP_SHAPES)
def test_strip_edge_jobs_at_64_have_what_they_are_built_for(W, tmax):
    sets = xf.strip_edge_jobs(W, tmax, strip=64)
    assert tuple(sets) == ("ins_run", "del_run", "tie64", "tie128",
                           "residues", "closed", "qlen_edges")
    facts = {name: [xf.band_trace(q[k], t[k], p[k], *xf.SCORING,
                                  xf.ZDROP)[1] for k in range(len(q))]
             for name, (q, t, p) in sets.items()}
    # F wins 65 and more columns from where its gap opened
    assert max(f["f_run"] for f in facts["ins_run"]) > 64
    # every residue mod 64 of beg (odd ones too), end and end - beg
    res = facts["residues"]
    for key in ("beg", "end"):
        assert {x % 64 for f in res for x in f[key]} == set(range(64))
    assert {(e - b) % 64 for f in res
            for b, e in zip(f["beg"], f["end"])} == set(range(64))
    assert all(f["closed"] for f in facts["closed"])
    assert any(64 in f["tie_gaps"] for f in facts["tie64"])
    if W == 512:
        # the tile holds two periods of 128 only at W 512
        assert any(128 in f["tie_gaps"] for f in facts["tie128"])

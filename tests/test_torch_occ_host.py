"""csrc/occ.cu's kernels (K-sa, the SA walk, and K-ext, the interval
extension), compiled for the host against csrc/warp_host.h under
ASan/UBSan (csrc/occ_host.cpp), against the plain versions of
tpubwa_torch/device/occ.py: both walks (text-position marks, and the
rank-sampled walk of a stock-bwa index), int32 and int64 ranks, both
extension directions.  Tolerance 0.  What the GPU's compiler makes of
the source shows only on a card."""
import numpy as np
import pytest
import torch

from tpubwa_torch.device import occ as tocc
from tpubwa_torch.device import warp_host
from tpubwa_torch.device.occ import DeviceIndex
from tpubwa_torch.index import FMIndex
from tpubwa_torch.index.build import BntSeq, SeqAnn


@pytest.fixture(scope="module")
def indexes(tmp_path_factory):
    """{"marked" | "unmarked": FMIndex}: a 3,000-base random genome and
    its save_bwa/load_bwa round trip (no marks)."""
    rng = np.random.default_rng(11)
    n = 3000
    codes = rng.integers(0, 4, n).astype(np.uint8)
    bnt = BntSeq(l_pac=n, anns=[SeqAnn(name="g", anno="", offset=0,
                                       length=n, n_ambs=0)],
                 ambs=[], seed=11, codes=codes)
    fmi = FMIndex.build(bnt)
    d = tmp_path_factory.mktemp("tocch")
    fmi.save_bwa(str(d / "g"))
    return {"marked": fmi, "unmarked": FMIndex.load_bwa(str(d / "g"))}


def host_arrays(didx):
    """The mapping occ_host takes, from the port's index."""
    out = {k: v.numpy() for k, v in didx.upload_fm().items()}
    for k in ("occ_blocks", "mark_rows"):
        out[k] = out[k].view(np.uint32)
    out.update(primary=didx.primary, seq_len=didx.seq_len,
               mark_D=didx.mark_D)
    return out


def queries(fmi, didx, rng, n=200):
    """Ranks (the ends, primary and its neighbours, block edges, random
    ones) and intervals (each base's, then one and two plain extension
    steps, and the edge intervals)."""
    edges = [0, 1, fmi.primary - 1, fmi.primary, fmi.primary + 1,
             fmi.seq_len - 1, fmi.seq_len, 127, 128, 129, 4095, 4096]
    ranks = np.concatenate([edges, rng.integers(0, fmi.seq_len + 1, n)])
    ik = tocc.set_intv(didx, torch.from_numpy(rng.integers(0, 4, n)))
    steps = [ik]
    for is_back in (True, False):
        ok = tocc.bwt_extend_plain(didx, steps[-1], is_back)
        steps.append(ok[torch.arange(n), torch.from_numpy(
            rng.integers(0, 4, n))])
    return ranks, torch.cat(steps + [torch.from_numpy(
        edge_intervals(fmi)).to(didx.idt)])


def edge_intervals(fmi):
    """Intervals whose occ4 queries (piv - 1 and piv - 1 + size) land on
    -1, primary and its neighbours, and seq_len, in either direction;
    the empty interval and the whole-text one."""
    p, n = fmi.primary, fmi.seq_len
    out = [[1, 1, 0], [0, 0, n + 1]]
    for piv in (0, 1, p - 2, p - 1, p, p + 1, p + 2, n - 2, n - 1, n):
        for sz in (0, 1, 2, 3):
            if piv - 1 + sz <= n:
                out.append([piv, piv, sz])
    return np.asarray(out, np.int64)


@pytest.mark.parametrize("idt", [np.int32, np.int64])
@pytest.mark.parametrize("marks", ["marked", "unmarked"])
def test_kernels_equal_plain(indexes, marks, idt):
    fmi = indexes[marks]
    base = DeviceIndex.from_fmindex(fmi, "cpu")
    arrays = host_arrays(base)
    if idt is np.int64:
        for k in ("sa_sample", "L2", "sa_marked"):
            arrays[k] = arrays[k].astype(np.int64)
    didx = DeviceIndex.from_numpy(dict(arrays, pac_words=np.zeros(
        1, np.uint32), l_pac=fmi.bnt.l_pac), "cpu")
    assert didx.idt == torch.from_numpy(np.zeros(1, idt)).dtype
    assert didx.mark_D == (8 if marks == "marked" else 0)
    ranks, ik = queries(fmi, didx, np.random.default_rng(4))
    ik = ik.to(didx.idt)
    pos, back, fwd = warp_host.occ_host(arrays, ranks, ik.numpy())
    stats = {}
    want = tocc.sa_lookup_plain(didx, torch.from_numpy(ranks.astype(idt)),
                                stats=stats)
    assert pos.dtype == idt and np.array_equal(pos, want.numpy())
    # the walk the kernel took: up to mark_D - 1 steps with marks, a
    # geometric walk (past mark_D steps somewhere) without them
    assert (int(stats["steps"].max()) <= 7) == (marks == "marked")
    for got, is_back in ((back, True), (fwd, False)):
        assert np.array_equal(got, tocc.bwt_extend_plain(
            didx, ik, is_back).numpy()), is_back


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("idt", [np.int32, np.int64])
def test_extension_groups_equal_plain(indexes, idt, reverse):
    """K-ext, one interval on a group of lanes, its result written as
    16-byte chunks by the group's lanes: == the plain extension in both
    directions and both lane orders, on interval counts that leave a
    warp's last groups, or all but one, without an interval (the
    harness's outputs start as -77, so a chunk not written shows)."""
    fmi = indexes["marked"]
    didx = DeviceIndex.from_fmindex(fmi, "cpu")
    arrays = host_arrays(didx)
    if idt is np.int64:
        for k in ("sa_sample", "L2", "sa_marked"):
            arrays[k] = arrays[k].astype(np.int64)
        didx = DeviceIndex.from_numpy(dict(arrays, pac_words=np.zeros(
            1, np.uint32), l_pac=fmi.bnt.l_pac), "cpu")
    _, ik = queries(fmi, didx, np.random.default_rng(6))
    ik = ik.to(didx.idt)
    from tpubwa_torch.scripts.exp_reach_forms import constant
    per_warp = 32 // constant("kExtGroup")
    for n in sorted({1, per_warp - 1, per_warp + 1, 3 * per_warp + 1,
                     len(ik)} - {0}):
        _, back, fwd = warp_host.occ_host(arrays, np.zeros(0, idt),
                                          ik[:n].numpy(), reverse=reverse)
        for got, is_back in ((back, True), (fwd, False)):
            assert got.dtype == idt and got.shape == (n, 4, 3)
            assert np.array_equal(got, tocc.bwt_extend_plain(
                didx, ik[:n], is_back).numpy()), (n, is_back)


def test_extension_reads_counts_past_2_31_as_unsigned():
    """A checkpoint count above 2^31 (GRCh38 scale) is widened in the
    kernel, not read as a negative int32."""
    big = (1 << 31) + 12345
    row = np.zeros((2, 12), np.uint32)
    row[:, :4] = [[big, big + 1, big + 2, big + 3],
                  [big + 32, big + 33, big + 34, big + 35]]
    row[:, 4:] = 0x1B1B1B1B          # ACGT repeated
    arrays = {"occ_blocks": row, "mark_rows": np.zeros((1, 8), np.uint32),
              "sa_sample": np.zeros(1, np.int64),
              "L2": np.asarray([0, 1 << 32, 2 << 32, 3 << 32, 4 << 32],
                               np.int64),
              "sa_marked": np.zeros(1, np.int64), "primary": 1 << 33,
              "seq_len": 1 << 34, "mark_D": 0}
    didx = DeviceIndex.from_numpy(dict(arrays, pac_words=np.zeros(
        1, np.uint32), l_pac=1 << 33), "cpu")
    ik = np.asarray([[1, 2, 0], [5, 7, 40], [0, 3, 200], [130, 9, 100]],
                    np.int64)
    _, back, fwd = warp_host.occ_host(arrays, np.zeros(0, np.int64), ik)
    want = tocc.bwt_extend_plain(didx, torch.from_numpy(ik), True)
    assert np.array_equal(back, want.numpy())
    assert np.array_equal(fwd, tocc.bwt_extend_plain(
        didx, torch.from_numpy(ik), False).numpy())
    # new_piv = L2[c] + 1 + a count past 2^31 (x0 - 1 = -1 reads none)
    assert (want[[0, 1, 3], :, 0] > big).all()


def edge_ranks(fmi, rng, n=160):
    """K-sa's rank set for the queue: 0, primary and its neighbours,
    seq_len, multiples of 32 (walks that end at once), ranks clamped
    from outside [0, seq_len], then random ones."""
    p, sl = fmi.primary, fmi.seq_len
    edges = [0, 1, p - 1, p, p + 1, sl - 1, sl, -1, -40, sl + 1, sl + 33]
    return np.concatenate([edges, np.arange(0, sl + 1, 32)[:40],
                           rng.integers(0, sl + 1, n)])


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("max_blocks", [1, 2])
@pytest.mark.parametrize("marks", ["marked", "unmarked"])
def test_walk_on_a_capped_grid(indexes, marks, max_blocks, reverse):
    """K-sa's rank queue: on a grid of one or two blocks each lane walks
    rank after rank (the thread that walked each rank, ``lanes``), in
    both lane orders, and every position equals the plain walk's, on
    the edge ranks, the multiples of 32 and clamped ranks."""
    fmi = indexes[marks]
    didx = DeviceIndex.from_fmindex(fmi, "cpu")
    ranks = edge_ranks(fmi, np.random.default_rng(5))
    stats = {}
    pos, _, _ = warp_host.occ_host(host_arrays(didx), ranks,
                                   np.zeros((0, 3)), max_blocks=max_blocks,
                                   reverse=reverse, stats=stats)
    want = tocc.sa_lookup_plain(didx, torch.from_numpy(ranks.astype(
        np.int32)))
    assert np.array_equal(pos, want.numpy())
    lanes = stats["lanes"]
    assert lanes.min() >= 0 and lanes.max() < 128 * max_blocks
    taken = np.bincount(lanes)
    taken = taken[taken > 0]
    # the harness runs a launch's warps one after another: the first
    # warp's 32 lanes drain the queue, each taking rank after rank
    assert len(taken) == 32 and len(ranks) == taken.sum()
    assert taken.min() >= 2 and taken.max() >= 6


@pytest.mark.parametrize("idt", [np.int32, np.int64])
def test_sa_lookup_refuses_n_past_the_queue(indexes, idt):
    """An n whose rank queue (an int32 counter, which each warp may pass
    n by one tile) could overflow is refused before anything runs: a
    nonzero return, the queue word not zeroed, no position written.  On
    the harness's H100 a grid holds 132 x 16 blocks of 4 warps."""
    didx = DeviceIndex.from_fmindex(indexes["unmarked"], "cpu")
    arrays = host_arrays(didx)
    for k in ("sa_sample", "L2", "sa_marked"):
        arrays[k] = arrays[k].astype(idt)
    limit = (1 << 31) - 1 - 32 * (132 * 16 * 4 + 1)
    for n_call in (limit + 1, (1 << 31) - 1, 1 << 40):
        rc, queue, pos = warp_host.sa_lookup_refusal(arrays, np.zeros(
            4, idt), n_call)
        assert rc != 0 and queue == -77 and (pos == -77).all(), n_call


def test_ksa_forms_edit_the_sources_once():
    """scripts/exp_ksa_forms.py's forms are the sources with named edits,
    each of which must find its text exactly once (the script refuses
    otherwise, on the card)."""
    from tpubwa_torch.device import _build
    from tpubwa_torch.scripts import exp_ksa_forms
    assert exp_ksa_forms.FORMS["current"] == []
    for form, edits in exp_ksa_forms.FORMS.items():
        for name, old, new in edits:
            text = (_build.CSRC / name).read_text()
            assert name in exp_ksa_forms.SOURCES, form
            assert text.count(old) == 1 and new not in text, (form, old)

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

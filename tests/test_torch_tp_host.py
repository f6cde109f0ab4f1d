"""The TP instantiations of csrc/occ.cu's K-sa (the marked walk) and
K-ext and of csrc/smem.cu's K2, over an index cut into row slabs
(csrc/fm.cuh:Slabs), compiled for the host against csrc/warp_host.h
under ASan/UBSan (csrc/occ_host.cpp, csrc/smem_host.cpp): over 2 and 3
slabs, each slab its own heap block whose boundaries fall on odd rows
(so that a row read past a slab's end is the sanitizer's), they must
equal the flat instantiations and the plain versions, int32 and int64
ranks, in both lane orders.  The entries refuse a mark-less walk, and a
slab on a device the launch's cannot reach; where the two can, they
enable peer access and run.  Tolerance 0.  What the GPU's compiler makes
of the source shows only on a card."""
import numpy as np
import pytest
import torch

from tpubwa_torch.device import occ as tocc
from tpubwa_torch.device import smem_fused, warp_host
from tpubwa_torch.device.occ import DeviceIndex
from tpubwa_torch.index import FMIndex
from tpubwa_torch.index.build import BntSeq, SeqAnn
from tpubwa_torch.opts import MemOpt
from test_torch_occ_host import host_arrays, queries
from test_torch_smem import _pack, _test_genome
from test_torch_smem_host import _didx, params
from test_torch_smem_host import host_arrays as smem_arrays


def odd_cuts(rows, n):
    """The first rows of ``n`` slabs of ``rows`` rows, every boundary
    but 0 an odd row."""
    first = [0] + [(rows * i // n) | 1 for i in range(1, n)]
    assert all(a < b < rows for a, b in zip(first, first[1:]))
    return first


@pytest.fixture(scope="module")
def indexes(tmp_path_factory):
    """{"marked" | "unmarked": FMIndex}: the 3,000-base random genome of
    tests/test_torch_occ_host.py and its stock-bwa round trip."""
    codes = np.random.default_rng(11).integers(0, 4, 3000).astype(np.uint8)
    fmi = FMIndex.build(BntSeq(l_pac=3000, anns=[SeqAnn(
        name="g", anno="", offset=0, length=3000, n_ambs=0)], ambs=[],
        seed=11, codes=codes))
    d = tmp_path_factory.mktemp("ttph")
    fmi.save_bwa(str(d / "g"))
    return {"marked": fmi, "unmarked": FMIndex.load_bwa(str(d / "g"))}


def occ_case(fmi, idt):
    """(arrays for occ_host, the port's index over them, ranks, ik)."""
    arrays = host_arrays(DeviceIndex.from_fmindex(fmi, "cpu"))
    if idt is np.int64:
        for k in ("sa_sample", "L2", "sa_marked"):
            arrays[k] = arrays[k].astype(np.int64)
    didx = DeviceIndex.from_numpy(dict(arrays, pac_words=np.zeros(
        1, np.uint32), l_pac=fmi.bnt.l_pac), "cpu")
    ranks, ik = queries(fmi, didx, np.random.default_rng(5))
    return arrays, didx, ranks.astype(idt), ik.to(didx.idt).numpy()


def slab_cuts(arrays, n):
    """Odd cuts of the occ, the mark and the sa_marked rows."""
    return [odd_cuts(len(arrays[k]), n)
            for k in ("occ_blocks", "mark_rows", "sa_marked")]


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("n", [2, 3])
@pytest.mark.parametrize("idt", [np.int32, np.int64])
def test_ksa_and_kext_tp_equal_flat_and_plain(indexes, idt, n, reverse):
    arrays, didx, ranks, ik = occ_case(indexes["marked"], idt)
    cuts = slab_cuts(arrays, n)
    got = warp_host.occ_host(arrays, ranks, ik, reverse=reverse, slabs=cuts)
    flat = warp_host.occ_host(arrays, ranks, ik, reverse=reverse)
    want = (tocc.sa_lookup_plain(didx, torch.from_numpy(ranks)).numpy(),
            *(tocc.bwt_extend_plain(didx, torch.from_numpy(ik), b).numpy()
              for b in (True, False)))
    for g, f, w in zip(got, flat, want):
        assert g.dtype == idt
        assert np.array_equal(g, f) and np.array_equal(g, w)


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("idt", [np.int32, np.int64])
def test_kext_tp_groups_on_partial_warps(indexes, idt, reverse):
    """K-ext's TP instantiation keeps K-ext's design, an interval on a
    group of lanes: on interval counts that leave a warp's last groups
    without one, over 2 slabs, both directions and lane orders, == the
    flat instantiation and the plain extension."""
    from tpubwa_torch.scripts.exp_reach_forms import constant
    arrays, didx, _, ik = occ_case(indexes["marked"], idt)
    cuts = slab_cuts(arrays, 2)
    per_warp = 32 // constant("kExtGroup")
    for n in sorted({1, per_warp + 1, 5 * per_warp - 1} - {0}):
        none = np.zeros(0, idt)
        got = warp_host.occ_host(arrays, none, ik[:n], reverse=reverse,
                                 slabs=cuts)[1:]
        flat = warp_host.occ_host(arrays, none, ik[:n], reverse=reverse)[1:]
        for g, f, b in zip(got, flat, (True, False)):
            assert g.dtype == idt and g.shape == (n, 4, 3)
            assert np.array_equal(g, f) and np.array_equal(
                g, tocc.bwt_extend_plain(didx, torch.from_numpy(ik[:n]),
                                         b).numpy()), (n, b)


def test_tp_rows_at_every_slab_edge(indexes):
    """Ranks and intervals on the rows either side of every cut, over 3
    slabs whose cuts are odd in each array."""
    arrays, didx, _, _ = occ_case(indexes["marked"], np.int32)
    cuts = slab_cuts(arrays, 3)
    edge = np.asarray([b * 128 + d for b in cuts[0] + cuts[1]
                       for d in (-129, -1, 0, 1, 127, 128)])
    edge = edge[(edge >= 0) & (edge <= didx.seq_len)].astype(np.int32)
    ik = np.stack([edge, edge, np.ones_like(edge)], 1)
    got = warp_host.occ_host(arrays, edge, ik, slabs=cuts)
    assert np.array_equal(got[0], tocc.sa_lookup_plain(
        didx, torch.from_numpy(edge)).numpy())
    for g, b in zip(got[1:], (True, False)):
        assert np.array_equal(g, tocc.bwt_extend_plain(
            didx, torch.from_numpy(ik), b).numpy())


def test_tp_walk_refuses_an_index_without_marks(indexes):
    """tpubwa's TP walk is the marked one: the entry refuses mark_D 0
    before anything runs."""
    arrays, _, ranks, ik = occ_case(indexes["unmarked"], np.int32)
    cuts = [[0, 1]] * 3      # the 1-row mark placeholders
    cuts[0] = odd_cuts(len(arrays["occ_blocks"]), 2)
    with pytest.raises(RuntimeError, match="returned 1"):
        warp_host.occ_host(arrays, ranks, ik, slabs=cuts)


@pytest.mark.parametrize("peers", [True, False])
def test_slabs_on_other_devices_need_peer_access(indexes, peers):
    """Slabs on devices 1 and 2, the launch on 0: where the devices reach
    each other the entry enables peer access and runs; where not, it
    returns cudaErrorPeerAccessUnsupported (217) and nothing runs."""
    arrays, didx, ranks, ik = occ_case(indexes["marked"], np.int32)
    cuts = slab_cuts(arrays, 3)
    if not peers:
        with pytest.raises(RuntimeError, match="returned 217"):
            warp_host.occ_host(arrays, ranks, ik, slabs=cuts,
                               devices=[0, 1, 2], peers=False)
        return
    got = warp_host.occ_host(arrays, ranks, ik, slabs=cuts,
                             devices=[0, 1, 2])
    assert np.array_equal(got[0], tocc.sa_lookup_plain(
        didx, torch.from_numpy(ranks)).numpy())


@pytest.fixture(scope="module")
def k2_genome(tmp_path_factory):
    return _test_genome(tmp_path_factory.mktemp("ttph2"))


def k2_launch(didx, arr, lens, opt, cuts, reverse):
    """collect12's launch through K2's TP entry on the host (the flat
    entry where ``cuts`` is None)."""
    arrays = smem_arrays(didx)

    def launch(rids, slots):
        out = warp_host.smem_host(arrays, arr, lens, 0, params(opt),
                                  rids=rids.numpy(), slots=slots,
                                  reverse=reverse, slabs=cuts)
        return (torch.from_numpy(out[0]).to(didx.idt),
                *(torch.from_numpy(x).int() for x in out[1:]))

    return launch


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("n", [2, 3])
@pytest.mark.parametrize("idt", ["int32", "int64"])
def test_k2_tp_equals_flat_and_plain(k2_genome, idt, n, reverse):
    """K2's TP instantiation through the wrapper's two-launch protocol
    (one row slot a read, so most reads take the second launch) == the
    flat one == rounds12_plain: rows, read ids, steps and chain."""
    fmi, _, reads = k2_genome
    arr, lens = _pack(reads)
    opt = MemOpt()
    didx = _didx(fmi, idt)
    cuts = odd_cuts(len(smem_arrays(didx)["occ_blocks"]), n)
    want_stats = {}
    want = smem_fused.rounds12_plain(opt, didx, torch.from_numpy(arr),
                                     torch.from_numpy(lens),
                                     stats=want_stats)
    for c in (cuts, None):
        stats = {}
        got = smem_fused.collect12(k2_launch(didx, arr, lens, opt, c,
                                             reverse), len(reads), 1,
                                   torch.device("cpu"), stats=stats)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        for key in ("steps", "chain"):
            assert torch.equal(stats[key], want_stats[key]), key
        assert stats["second_launch_reads"] >= 4


def test_k2_tp_refuses_unreachable_slabs(k2_genome):
    fmi, _, reads = k2_genome
    arr, lens = _pack(reads[:4])
    opt = MemOpt()
    didx = _didx(fmi, "int32")
    arrays = smem_arrays(didx)
    with pytest.raises(RuntimeError, match="returned 217"):
        warp_host.smem_host(arrays, arr, lens, 0, params(opt),
                            rids=np.arange(4), slots=8,
                            slabs=odd_cuts(len(arrays["occ_blocks"]), 2),
                            devices=[0, 3], peers=False)

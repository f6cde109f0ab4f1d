"""csrc/smem.cu's kernels (K2, rounds 1+2, and K3, round 3, one read a
thread over csrc/smem.cuh and csrc/fm.cuh), compiled for the host
against csrc/warp_host.h under ASan/UBSan (csrc/smem_host.cpp), against
their plain versions (device/smem_fused.py:rounds12_plain,
device/smem.py:_seed_strategy_scan_plain) and, merged as mode megaq
merges them, against tpubwa's scalar oracle ref.smem.collect_intv.  K2
goes through the wrapper's own two-launch protocol
(smem_fused.collect12), with one row slot a read too, so that most
reads take the second launch.  int32 and int64 ranks.  Tolerance 0.
What the GPU's compiler makes of the source shows only on a card."""
import dataclasses

import numpy as np
import pytest
import torch

from tpubwa.ref.smem import collect_intv
from tpubwa_torch.device import smem, smem_fused, warp_host
from tpubwa_torch.device.occ import DeviceIndex
from tpubwa_torch.opts import MemOpt
from test_torch_smem import L, _pack, _sim_genome, _test_genome


@pytest.fixture(scope="module")
def genomes(tmp_path_factory):
    return {"test": _test_genome(tmp_path_factory.mktemp("tsmemh")),
            "sim1m": _sim_genome()}


def _didx(fmi, idt):
    didx = DeviceIndex.from_fmindex(fmi, "cpu")
    return didx if idt == "int32" else dataclasses.replace(
        didx, idt=torch.int64, _fm=None)


def host_arrays(didx):
    """The index mapping smem_host takes, from the port's index."""
    fm = didx.upload_fm()
    return {"occ_blocks": fm["occ_blocks"].numpy().view(np.uint32),
            "L2": fm["L2"].numpy(), "primary": didx.primary,
            "seq_len": didx.seq_len}


def params(opt):
    return (opt.min_seed_len, smem_fused.split_len_of(opt), opt.split_width,
            opt.max_mem_intv, smem.max_hits(L, opt.min_seed_len))


def k2_launch(didx, arr, lens, opt):
    """collect12's launch through the harness: K2's C entry on the host."""
    arrays = host_arrays(didx)

    def launch(rids, slots):
        rows, counts, steps = warp_host.smem_host(
            arrays, arr, lens, 0, params(opt), rids=rids.numpy(), slots=slots)
        return (torch.from_numpy(rows).to(didx.idt),
                torch.from_numpy(counts).int(), torch.from_numpy(steps).int())

    return launch


CASES = [(g, i) for g in ("test", "sim1m") for i in ("int32", "int64")]


@pytest.mark.parametrize("slots", [smem_fused.K2_SLOTS, 1])
@pytest.mark.parametrize("name,idt", CASES)
def test_k2_equals_plain(genomes, name, idt, slots):
    """K2 through the wrapper's launches == rounds12_plain, in order, with
    the same bwt_extend steps a read; with one slot a read the first
    launch's counts are still exact, and every read of more than one row
    takes the second launch."""
    fmi, _, reads = genomes[name]
    arr, lens = _pack(reads)
    opt = MemOpt()
    didx = _didx(fmi, idt)
    want_stats, stats = {}, {}
    want = smem_fused.rounds12_plain(opt, didx, torch.from_numpy(arr),
                                     torch.from_numpy(lens), stats=want_stats)
    launch = k2_launch(didx, arr, lens, opt)
    got = smem_fused.collect12(launch, len(reads), slots,
                               torch.device("cpu"), stats=stats)
    assert got[0].dtype == didx.idt
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert torch.equal(stats["steps"], want_stats["steps"])
    counts = torch.bincount(want[1], minlength=len(reads))
    assert stats["second_launch_reads"] == int((counts > slots).sum())
    if slots == 1:
        assert stats["second_launch_reads"] >= 4
        _, first_counts, _ = launch(torch.arange(len(reads),
                                                 dtype=torch.int32), 1)
        assert torch.equal(first_counts.long(), counts)


@pytest.mark.parametrize("name,idt", CASES)
def test_k3_equals_plain(genomes, name, idt):
    fmi, _, reads = genomes[name]
    arr, lens = _pack(reads)
    opt = MemOpt()
    didx = _didx(fmi, idt)
    stats = {}
    hits, n_hits = smem._seed_strategy_scan_plain(
        didx, torch.from_numpy(arr), torch.from_numpy(lens),
        opt.min_seed_len, opt.max_mem_intv, stats=stats)
    got, got_n, steps = warp_host.smem_host(host_arrays(didx), arr, lens, 1,
                                            params(opt))
    assert np.array_equal(got, hits.numpy())
    assert np.array_equal(got_n, n_hits.numpy())
    assert np.array_equal(steps, stats["steps"].numpy())
    assert got_n.sum() > 0


@pytest.mark.parametrize("max_mem_intv", [20, 0])
@pytest.mark.parametrize("name", ["test", "sim1m"])
def test_kernels_merged_equal_the_oracle(genomes, name, max_mem_intv):
    """K2's and K3's host runs merged as mode megaq merges them ==
    tpubwa's ref.smem.collect_intv, read by read, in order."""
    fmi, jfmi, reads = genomes[name]
    arr, lens = _pack(reads)
    opt = MemOpt(max_mem_intv=max_mem_intv)
    didx = _didx(fmi, "int32")
    rows12 = smem_fused.collect12(k2_launch(didx, arr, lens, opt), len(reads),
                                  smem_fused.K2_SLOTS, torch.device("cpu"))
    round3 = ()
    if max_mem_intv > 0:
        round3 = warp_host.smem_host(host_arrays(didx), arr, lens, 1,
                                     params(opt))[:2]
    flat, frid = smem.merge_rounds(*rows12, *round3)
    for i, r in enumerate(reads):
        want = [(m.x0, m.x1, m.size, m.qb, m.qe)
                for m in collect_intv(opt, jfmi, r)]
        assert list(map(tuple, flat[frid == i].tolist())) == want, i


def test_rows_read_are_the_plain_versions(genomes, monkeypatch):
    """count_rows (chip_smoke.py's bytes bound) reports the distinct occ
    rows K2 and K3 read: those of the plain versions' extensions."""
    fmi, _, reads = genomes["sim1m"]
    arr, lens = _pack(reads)
    opt = MemOpt()
    didx = _didx(fmi, "int32")
    seen = []
    plain = smem_fused.bwt_extend_plain

    def spy(didx, ik, is_back, stats=None):
        stats = {}
        out = plain(didx, ik, is_back, stats)
        seen.append(stats["occ_rows"])
        return out

    monkeypatch.setattr(smem_fused, "bwt_extend_plain", spy)
    q, ld = torch.from_numpy(arr), torch.from_numpy(lens)
    for kernel in (0, 1):
        seen.clear()
        if kernel == 0:
            smem_fused.rounds12_plain(opt, didx, q, ld)
        else:
            smem._seed_strategy_scan_plain(didx, q, ld, opt.min_seed_len,
                                           opt.max_mem_intv)
        want = np.unique(torch.cat(seen).numpy())
        *_, rows = warp_host.smem_host(
            host_arrays(didx), arr, lens, kernel, params(opt),
            slots=smem_fused.K2_SLOTS, count_rows=True)
        assert np.array_equal(rows, want)
        assert 0 < len(rows) < len(host_arrays(didx)["occ_blocks"])

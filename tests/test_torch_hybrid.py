"""The port's seed mode hybrid on the CPU (device/smem.py:
collect_intv_device(mode="hybrid") and HybridSplit): a chunk's first k
reads through K2's and K3's plain versions on a worker thread, the rest
through the native seeder, merged.  Its rows equal tpubwa's hybrid (on
JAX-CPU, AUTO=0 and K_FLOOR=16, as tests/test_device_smem.py drives it),
the port's host mode and its megaq mode, whatever k is, on int32 and
int64 ranks; the balancer's rule as pure cases; `mem --device cpu` SAM
equal to host mode's across the seam and in the degrade.  Tolerance 0."""
import dataclasses
import io

import numpy as np
import pytest
import torch

import tpubwa.device  # noqa: F401  (x64, as the JAX package runs)
import tpubwa.index
from tpubwa.device import smem as jsmem
from tpubwa.device.occ import DeviceIndex as JaxDeviceIndex
from tpubwa_torch.cli import main_index, main_mem
from tpubwa_torch.device import smem
from tpubwa_torch.device.occ import DeviceIndex
from tpubwa_torch.device.smem import HybridSplit
from tpubwa_torch.index import FMIndex
from tpubwa_torch.opts import MemOpt
from simread import simulate_pairs, write_fastq

B, L = 64, 128


def _edge_reads(text, rng, unit):
    """A read with N inside, a repeat-unit read, a random read, one
    base, all N."""
    q = text[700:800].copy()
    q[50] = 4
    return [q, np.tile(unit, 100 // len(unit) + 1)[:100].copy(),
            rng.integers(0, 4, 100).astype(np.uint8), text[500:501].copy(),
            np.full(100, 4, np.uint8)]


@pytest.fixture(scope="module")
def chunk(tmp_path_factory):
    """A 12 kb genome with a 35-base unit 4 times (seed 21), indexed by
    both packages, and a chunk of 64 reads (seed 7): mutated windows of
    the doubled text, and the edge reads at 0-4, 15-19 (16: the repeat
    unit) and 63, on both sides of the seams at 16 and 63."""
    rng = np.random.default_rng(21)
    unit = rng.integers(0, 4, 35).astype(np.uint8)
    codes = np.concatenate([
        rng.integers(0, 4, 6000).astype(np.uint8), np.tile(unit, 4),
        rng.integers(0, 4, 6000).astype(np.uint8)])
    fa = tmp_path_factory.mktemp("thyb") / "g.fa"
    fa.write_text(">g\n" + "".join("ACGT"[c] for c in codes) + "\n")
    fmi, jfmi = (FMIndex.from_fasta(str(fa)),
                 tpubwa.index.FMIndex.from_fasta(str(fa)))
    assert np.array_equal(fmi.occ_ckpt, jfmi.occ_ckpt)
    text = fmi.bnt.doubled()
    rng = np.random.default_rng(7)
    edges = _edge_reads(text, rng, unit)
    reads = []
    for _ in range(B - 2 * len(edges)):
        start = int(rng.integers(0, len(text) - 110))
        q = text[start:start + 100].copy()
        for _ in range(int(rng.integers(0, 6))):
            q[int(rng.integers(0, 100))] = int(rng.integers(0, 5))
        reads.append(q)
    reads = edges + reads[:10] + edges[::-1] + reads[10:]
    reads[16], reads[63] = edges[1], edges[0]
    arr = np.full((B, L), 4, np.uint8)
    lens = np.array([len(r) for r in reads], np.int32)
    for i, r in enumerate(reads):
        arr[i, :len(r)] = r
    opt = MemOpt()
    host = smem.collect_intv_device(opt, _didx(fmi, "int32"), arr, lens,
                                    fmi)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("TPUBWA_HYBRID_AUTO", "0")
        mp.setenv("TPUBWA_HYBRID_K_FLOOR", "16")
        jax = jsmem.collect_intv_device(
            opt, JaxDeviceIndex.from_fmindex(jfmi), arr, lens, fmi=jfmi,
            mode="hybrid", return_flat=True)
    return {"fmi": fmi, "arr": arr, "lens": lens, "host": host[:2],
            "jax": tuple(np.asarray(x) for x in jax), "megaq": {}}


def _didx(fmi, idt):
    didx = DeviceIndex.from_fmindex(fmi, "cpu")
    return didx if idt == "int32" else dataclasses.replace(
        didx, idt=torch.int64, _fm=None)


def _megaq(chunk, idt):
    if idt not in chunk["megaq"]:
        chunk["megaq"][idt] = smem.collect_intv_device(
            MemOpt(), _didx(chunk["fmi"], idt), chunk["arr"], chunk["lens"],
            chunk["fmi"], mode="megaq")[:2]
    return chunk["megaq"][idt]


def _assert_rows(got, want, what):
    assert got[0].dtype == got[1].dtype == np.int64, what
    assert np.array_equal(got[0], want[0]), what
    assert np.array_equal(got[1], want[1]), what


@pytest.mark.parametrize("idt", ["int32", "int64"])
def test_hybrid_equals_tpubwa_host_and_megaq(chunk, monkeypatch, idt):
    """tpubwa's knobs with its test's values (AUTO=0, K_FLOOR=16): k = 16
    on both sides; the rows equal tpubwa's hybrid, the port's host mode
    and its megaq mode, in order, and qd holds all 64 reads."""
    monkeypatch.setenv("TPUBWA_HYBRID_AUTO", "0")
    monkeypatch.setenv("TPUBWA_HYBRID_K_FLOOR", "16")
    split = HybridSplit.from_env()
    assert (split.f, split.auto, split.k_floor) == (0.25, False, 16)
    flat, frid, qd = smem.collect_intv_device(
        MemOpt(), _didx(chunk["fmi"], idt), chunk["arr"], chunk["lens"],
        chunk["fmi"], mode="hybrid", split=split)
    assert torch.equal(qd, torch.from_numpy(chunk["arr"]))
    assert [h[:2] for h in split.history] == [(B, 16)]
    _assert_rows((flat, frid), chunk["jax"], "tpubwa's hybrid")
    _assert_rows((flat, frid), chunk["host"], "host mode")
    _assert_rows((flat, frid), _megaq(chunk, idt), "megaq")
    assert (frid < 16).any() and (frid >= 16).any()


@pytest.mark.parametrize("idt", ["int32", "int64"])
@pytest.mark.parametrize("want_k", [32, B - 1, 15])
def test_pinned_k(chunk, monkeypatch, idt, want_k):
    """k pinned in the middle, at B - 1, and below the floor (16), where
    the chunk is seeded in host mode: the rows equal host mode's and
    megaq's; the device share gets exactly reads [:k]."""
    seen = []
    k2 = smem.rounds12_megaq

    def spy(opt, didx, qd, ld, **kw):
        assert qd.is_contiguous() and ld.is_contiguous()
        seen.append(len(ld))
        return k2(opt, didx, qd, ld, **kw)

    monkeypatch.setattr(smem, "rounds12_megaq", spy)
    split = HybridSplit(f=(want_k + 0.5) / B, auto=False, k_floor=16)
    assert split.k_for(B) == want_k
    got = smem.collect_intv_device(
        MemOpt(), _didx(chunk["fmi"], idt), chunk["arr"], chunk["lens"],
        chunk["fmi"], mode="hybrid", split=split)
    k = want_k if want_k >= 16 else 0
    assert [h[:2] for h in split.history] == [(B, k)]
    assert seen == ([k] if k else [])
    assert split.chunks == (1 if k else 0)
    _assert_rows(got[:2], chunk["host"], "host mode")
    _assert_rows(got[:2], _megaq(chunk, idt), "megaq")


def test_device_share_error_propagates(chunk, monkeypatch):
    """No fallback: an error in the device share fails the chunk, and the
    native seeder sees only the host share (no reseeding)."""
    def broken(*a, **kw):
        raise RuntimeError("device share failed")

    native = smem.smem_collect_batch_native
    host_reads = []

    def counted(opt, fmi, reads, lens, **kw):
        host_reads.append(len(lens))
        return native(opt, fmi, reads, lens, **kw)

    monkeypatch.setattr(smem, "rounds12_megaq", broken)
    monkeypatch.setattr(smem, "smem_collect_batch_native", counted)
    split = HybridSplit(f=0.5, k_floor=16)
    with pytest.raises(RuntimeError, match="device share failed"):
        smem.collect_intv_device(
            MemOpt(), _didx(chunk["fmi"], "int32"), chunk["arr"],
            chunk["lens"], chunk["fmi"], mode="hybrid", split=split)
    assert host_reads == [0, B - 32]
    assert split.history == [] and split.f == 0.5


def test_without_the_native_seeder_a_chunk_goes_to_megaq(chunk,
                                                         monkeypatch):
    monkeypatch.setattr(smem, "smem_collect_batch_native",
                        lambda *a, **kw: None)
    split = HybridSplit(k_floor=16)
    got = smem.collect_intv_device(
        MemOpt(), _didx(chunk["fmi"], "int32"), chunk["arr"], chunk["lens"],
        chunk["fmi"], mode="hybrid", split=split)
    assert [h[:2] for h in split.history] == [(B, B)]
    _assert_rows(got[:2], _megaq(chunk, "int32"), "megaq")


# ---------------------------------------------------------------------
# the balancer (tpubwa/device/smem.py:581-605) as pure cases

def _measured(f=0.25, **kw):
    """A balancer past its first split chunk (whose walls are not used)."""
    split = HybridSplit(f=f, **kw)
    split.update(1000, int(1000 * f), 5.0, 0.001)
    assert split.f == f and split.chunks == 1
    return split


def test_balancer_ignores_the_first_chunk():
    split = HybridSplit()
    split.update(1000, 250, 0.001, 5.0)
    assert split.f == 0.25 and split.chunks == 1
    split.update(1000, 250, 0.001, 5.0)
    assert split.f > 0.5
    assert [h[4] for h in split.history] == [0.25, 0.25]


def test_balancer_damps_towards_equal_walls():
    """Equal rates (250 reads in 0.25 s, 750 in 0.75 s): f* = 0.5 and f
    moves half way, 0.25 -> 0.375."""
    split = _measured()
    split.update(1000, 250, 0.25, 0.75)
    assert split.f == pytest.approx(0.375, abs=1e-12)
    assert split.history[-1] == (1000, 250, 0.25, 0.75, 0.25)


@pytest.mark.parametrize("f,t_dev,t_host,want", [
    (0.8, 1e-3, 10.0, HybridSplit.HI), (0.03, 10.0, 1e-3, HybridSplit.LO)])
def test_balancer_clamps(f, t_dev, t_host, want):
    split = _measured(f)
    split.update(1000, int(1000 * f), t_dev, t_host)
    assert split.f == want


@pytest.mark.parametrize("t_dev,t_host", [(5e-5, 1.0), (1.0, 5e-5),
                                          (1e-4, 1.0)])
def test_balancer_ignores_walls_under_1e4(t_dev, t_host):
    split = _measured()
    split.update(1000, 250, t_dev, t_host)
    assert split.f == 0.25 and split.chunks == 2


def test_balancer_reaches_the_equal_wall_split():
    """With fixed rates (device 4x the host's) f converges to f* =
    rate_d / (rate_d + rate_h) = 0.8, where both walls are equal; a
    pinned balancer (auto off) and host-mode chunks (k = 0) leave f."""
    rate_d, rate_h, n = 4e5, 1e5, 10 ** 6
    split, pinned = HybridSplit(), HybridSplit(auto=False)
    for s in (split, pinned):
        for _ in range(40):
            k = s.k_for(n)
            s.update(n, k, k / rate_d, (n - k) / rate_h)
    assert split.f == pytest.approx(0.8, abs=1e-5)
    _, k, t_dev, t_host, _ = split.history[-1]
    assert t_dev == pytest.approx(t_host, rel=1e-4)
    assert pinned.f == 0.25 and pinned.chunks == 40
    split.update(n, 0, 0.0, 1.0)
    assert split.f == pytest.approx(0.8, abs=1e-5) and split.chunks == 40


# ---------------------------------------------------------------------
# `mem` end to end

@pytest.fixture(scope="module")
def mem_run(tmp_path_factory):
    """A 15 kb genome (seed 41) indexed by the port and 48 PE pairs with
    SNPs (seed 17): one chunk of 96 reads, padded to 128; at the share
    0.25, k = 32."""
    rng = np.random.default_rng(41)
    d = tmp_path_factory.mktemp("thybmem")
    codes = rng.integers(0, 4, 15000).astype(np.uint8)
    fa = d / "ref.fa"
    fa.write_text(">d1\n" + "".join("ACGT"[c] for c in codes) + "\n")
    assert main_index([str(fa)]) == 0
    pairs = simulate_pairs(codes, 48, 100, np.random.default_rng(17),
                           snp_rate=0.01)
    fqs = [str(d / "h1.fq"), str(d / "h2.fq")]
    write_fastq(fqs[0], [(n, s1) for n, s1, *_ in pairs])
    write_fastq(fqs[1], [(n, s2) for n, _, s2, *_ in pairs])
    return [str(fa)] + fqs


def _sam(argv):
    out = io.StringIO()
    assert main_mem(["--device", "cpu"] + argv, out=out) == 0
    return [l for l in out.getvalue().splitlines()
            if not l.startswith("@PG")]


@pytest.mark.parametrize("k_floor,want_k", [("16", 32), (None, 0)])
def test_mem_hybrid_sam_equals_host(mem_run, monkeypatch, k_floor,
                                    want_k):
    """`mem --device cpu` with TPUBWA_SEED_MODE=hybrid: SAM equal to host
    mode's, once across the seam (the floor lowered to 16: 32 reads on
    the device share) and once with the default floor of 64, where the
    chunk degrades to host mode."""
    host = _sam(mem_run)
    assert len(host) > 96
    seen = []
    k2 = smem.rounds12_megaq

    def spy(opt, didx, qd, ld, **kw):
        seen.append(len(ld))
        return k2(opt, didx, qd, ld, **kw)

    monkeypatch.setattr(smem, "rounds12_megaq", spy)
    monkeypatch.setenv("TPUBWA_SEED_MODE", "hybrid")
    monkeypatch.setenv("TPUBWA_HYBRID_AUTO", "0")
    if k_floor:
        monkeypatch.setenv("TPUBWA_HYBRID_K_FLOOR", k_floor)
    assert _sam(mem_run) == host
    assert seen == ([want_k] if want_k else [])

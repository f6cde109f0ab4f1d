"""The port's seed mode megaq on the CPU (K2's and K3's plain versions,
tpubwa_torch/device/smem_fused.py and device/smem.py) against tpubwa:
its collect_intv_device(mode="megaq"), rounds12_megaq and
_seed_strategy_scan on JAX-CPU, the scalar oracle ref.smem.collect_intv,
and the port's own host mode (the native seeder).  On the JAX package's
seeding test genome and on a 1 Mbp simulated genome, int32 and int64
ranks, with mutated, N, repeat-unit, random, one-base and all-N reads and
reads whose extensions cross the sentinel's row.  Tolerance 0."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpubwa.device  # noqa: F401  (x64, as the JAX package runs)
import tpubwa.index
import tpubwa.opts
import tpubwa.sim
from tpubwa.device import smem as jsmem
from tpubwa.device.occ import DeviceIndex as JaxDeviceIndex
from tpubwa.device.smem_fused import rounds12_megaq as jax_rounds12
from tpubwa.ref.smem import collect_intv
from tpubwa_torch import sim
from tpubwa_torch.device import smem, smem_fused
from tpubwa_torch.device.occ import DeviceIndex
from tpubwa_torch.index import FMIndex
from tpubwa_torch.opts import MemOpt

L = 128


def _pack(reads):
    arr = np.full((len(reads), L), 4, np.uint8)
    lens = np.zeros(len(reads), np.int32)
    for i, r in enumerate(reads):
        arr[i, :len(r)] = r
        lens[i] = len(r)
    return arr, lens


def _edge_reads(text, rng, unit):
    """Reads whose extensions cross the sentinel's row, a repeat-unit
    read, a random read, one base, all N.  The sentinel's row lies in
    the interval of a prefix of the doubled text: a backward step from
    the text's first 70 bases (after 30 random ones), and a forward step
    from the text's last 70 (before 30 random ones), whose reverse
    complement is that prefix, extend such an interval."""
    r30 = rng.integers(0, 4, (2, 30)).astype(np.uint8)
    return [np.concatenate([r30[0], text[:70]]),
            np.concatenate([text[len(text) - 70:], r30[1]]),
            np.tile(unit, 100 // len(unit) + 1)[:100].copy(),
            rng.integers(0, 4, 100).astype(np.uint8),
            text[500:501].copy(), np.full(100, 4, np.uint8)]


def _test_genome(d):
    """tests/test_device_smem.py's genome (a 35-base unit 4 times between
    random flanks, seed 21) and its reads (:227-255): mutated windows of
    the doubled text, N in the middle, and the edge reads."""
    rng = np.random.default_rng(21)
    unit = rng.integers(0, 4, 35).astype(np.uint8)
    codes = np.concatenate([
        rng.integers(0, 4, 1500).astype(np.uint8), np.tile(unit, 4),
        rng.integers(0, 4, 1500).astype(np.uint8)])
    fa = d / "g.fa"
    fa.write_text(">g\n" + "".join("ACGT"[c] for c in codes) + "\n")
    fmi, jfmi = FMIndex.from_fasta(str(fa)), tpubwa.index.FMIndex.from_fasta(
        str(fa))
    text = fmi.bnt.doubled()
    rng = np.random.default_rng(7)
    reads = []
    for _ in range(10):
        start = int(rng.integers(0, len(codes) - 110))
        q = text[start:start + 100].copy()
        for _ in range(int(rng.integers(0, 6))):
            q[int(rng.integers(0, 100))] = int(rng.integers(0, 5))
        reads.append(q)
    q = text[700:800].copy()
    q[50] = 4
    reads.append(q)
    return fmi, jfmi, reads + _edge_reads(text, rng, unit)


def _sim_genome():
    """A 1 Mbp repeat-realistic simulated genome (the port's and tpubwa's
    sim.make_bench_bnt, seed 3), 32 simulated reads (16 pairs, seed 1)
    and the edge reads."""
    bnt = sim.make_bench_bnt(1 << 20, np.random.default_rng(3))
    jbnt = tpubwa.sim.make_bench_bnt(1 << 20, np.random.default_rng(3))
    assert np.array_equal(bnt.codes, jbnt.codes)
    fmi, jfmi = FMIndex.build(bnt), tpubwa.index.FMIndex.build(jbnt)
    pairs = sim.simulate_pe(bnt, 16, 100, np.random.default_rng(1))
    text = fmi.bnt.doubled()
    unit = bnt.codes[5000:5040]
    return fmi, jfmi, [r.seq for r in pairs] + _edge_reads(
        text, np.random.default_rng(2), unit)


@pytest.fixture(scope="module")
def genomes(tmp_path_factory):
    out = {"test": _test_genome(tmp_path_factory.mktemp("tsmem")),
           "sim1m": _sim_genome()}
    for fmi, jfmi, _ in out.values():
        assert (fmi.seq_len, fmi.primary) == (jfmi.seq_len, jfmi.primary)
        assert np.array_equal(fmi.occ_ckpt, jfmi.occ_ckpt)
    return out


def _didx(fmi, idt):
    """The port's index on the CPU, with int32 or int64 ranks (the other
    instantiations of the kernels)."""
    didx = DeviceIndex.from_fmindex(fmi, "cpu")
    return didx if idt == "int32" else dataclasses.replace(
        didx, idt=torch.int64, _fm=None)


def _opts(**kw):
    opt, jopt = MemOpt(**kw), tpubwa.opts.MemOpt(**kw)
    assert vars(opt) == vars(jopt)
    return opt, jopt


def _sorted(rows, rids):
    return sorted(zip(np.asarray(rids).tolist(),
                      map(tuple, np.asarray(rows).tolist())))


_JAX = {}


def _jax_megaq(genomes, name, max_mem_intv):
    """tpubwa's collect_intv_device(mode="megaq") on JAX-CPU, per read,
    once per genome and option."""
    key = (name, max_mem_intv)
    if key not in _JAX:
        _, jfmi, reads = genomes[name]
        arr, lens = _pack(reads)
        _, jopt = _opts(max_mem_intv=max_mem_intv)
        _JAX[key] = jsmem.collect_intv_device(
            jopt, JaxDeviceIndex.from_fmindex(jfmi), arr, lens, fmi=jfmi,
            mode="megaq")
    return _JAX[key]


CASES = [(g, i) for g in ("test", "sim1m") for i in ("int32", "int64")]


@pytest.mark.parametrize("name,idt", CASES)
@pytest.mark.parametrize("max_mem_intv", [20, 0])
def test_megaq_equals_tpubwa_and_the_oracles(genomes, name, idt,
                                             max_mem_intv):
    """The port's megaq rows: as sorted sets equal to tpubwa's megaq (its
    machine returns ties in its own order), and in order equal to
    ref.smem.collect_intv and to the port's host mode (the chaining sees
    the order)."""
    fmi, jfmi, reads = genomes[name]
    arr, lens = _pack(reads)
    opt, jopt = _opts(max_mem_intv=max_mem_intv)
    didx = _didx(fmi, idt)
    flat, frid, qd = smem.collect_intv_device(opt, didx, arr, lens, fmi,
                                              mode="megaq")
    assert flat.dtype == frid.dtype == np.int64
    assert torch.equal(qd, torch.from_numpy(arr))
    host = smem.collect_intv_device(opt, didx, arr, lens, fmi)
    assert np.array_equal(flat, host[0]) and np.array_equal(frid, host[1])
    want = _jax_megaq(genomes, name, max_mem_intv)
    for i, r in enumerate(reads):
        got = flat[frid == i]
        assert sorted(map(tuple, got.tolist())) == sorted(
            map(tuple, np.asarray(want[i]).tolist())), f"read {i}"
        ref = [(m.x0, m.x1, m.size, m.qb, m.qe)
               for m in collect_intv(jopt, jfmi, r)]
        assert list(map(tuple, got.tolist())) == ref, f"read {i}"
    assert len(flat) > len(reads)


@pytest.mark.parametrize("name,idt", CASES)
def test_rounds12_plain_equals_tpubwa_rounds12_megaq(genomes, name, idt):
    """K2's plain version alone against tpubwa's rounds12_megaq, as
    sorted sets of (read, row) (the JAX machine returns rows in its
    buffer order); rows read-major, a steps count a read."""
    fmi, jfmi, reads = genomes[name]
    arr, lens = _pack(reads)
    opt, jopt = _opts()
    didx = _didx(fmi, idt)
    stats = {}
    rows, rids = smem_fused.rounds12_plain(
        opt, didx, torch.from_numpy(arr), torch.from_numpy(lens),
        stats=stats)
    assert rows.dtype == didx.idt and rids.dtype == torch.int64
    assert torch.equal(rids, torch.sort(rids, stable=True).values)
    jdidx = JaxDeviceIndex.from_fmindex(jfmi)
    jrows, jrids, *_ = jax_rounds12(
        jopt, jdidx, jnp.asarray(arr), jnp.asarray(lens), lens,
        arr, smem_fused.split_len_of(opt), jfmi)
    assert _sorted(rows, rids) == _sorted(jrows, jrids)
    steps = stats["steps"].numpy()
    assert steps.shape == (len(reads),) and steps[:-1].min() >= 0
    assert steps[-1] == 0          # the all-N read takes no step


@pytest.mark.parametrize("name,idt", CASES)
def test_seed_strategy_plain_equals_tpubwa_scan(genomes, name, idt):
    """K3's plain twin alone against tpubwa's _seed_strategy_scan: the
    hits [B, maxh, 5] (zero past each read's count) and their counts."""
    fmi, jfmi, reads = genomes[name]
    arr, lens = _pack(reads)
    opt, _ = _opts()
    didx = _didx(fmi, idt)
    hits, n_hits = smem._seed_strategy_scan(
        didx, torch.from_numpy(arr), torch.from_numpy(lens),
        opt.min_seed_len, opt.max_mem_intv)
    B = len(reads)
    buf = np.asarray(jsmem._seed_strategy_scan(
        JaxDeviceIndex.from_fmindex(jfmi), jnp.asarray(arr),
        jnp.asarray(lens), opt.min_seed_len, opt.max_mem_intv))
    want_n = buf[-B:]
    want = buf[:-B].reshape(B, -1, 5)
    assert hits.shape == want.shape == (B, smem.max_hits(
        L, opt.min_seed_len), 5)
    assert n_hits.dtype == torch.int32
    assert np.array_equal(n_hits.numpy(), want_n)
    valid = np.arange(want.shape[1])[None, :] < want_n[:, None]
    assert np.array_equal(hits.numpy()[valid], want[valid])
    assert not hits.numpy()[~valid].any()
    assert want_n.sum() > 0


def test_reads_cross_the_sentinel(genomes, monkeypatch):
    """The edge reads make extensions, backward and forward, whose pivot
    interval holds the sentinel's row (bwt_extend's `sent`, PERF.md
    §6): the seeding of both genomes steps over `primary` both ways."""
    crossed = set()
    plain = smem_fused.bwt_extend_plain

    def spy(didx, ik, is_back, stats=None):
        piv = ik[:, 0] if is_back else ik[:, 1]
        if bool(((piv <= didx.primary)
                 & (piv + ik[:, 2] - 1 >= didx.primary)).any()):
            crossed.add(is_back)
        return plain(didx, ik, is_back, stats)

    monkeypatch.setattr(smem_fused, "bwt_extend_plain", spy)
    for name in ("test", "sim1m"):
        fmi, _, reads = genomes[name]
        crossed.clear()
        arr, lens = _pack(reads[-6:-4])
        smem.collect_intv_device(MemOpt(), _didx(fmi, "int32"), arr, lens,
                                 fmi, mode="megaq")
        assert crossed == {True, False}, name


def test_wrappers_check_their_inputs(genomes):
    fmi, _, reads = genomes["test"]
    didx = _didx(fmi, "int32")
    arr, lens = (torch.from_numpy(x) for x in _pack(reads[:2]))
    opt = MemOpt()
    for bad_q, bad_l, what in (
            (arr.int(), lens, "uint8"), (arr, lens.long(), "int32"),
            (arr, lens + L, "outside"), (arr.t(), lens[:1].repeat(L),
                                         "contiguous")):
        with pytest.raises(ValueError, match=what):
            smem_fused.rounds12_megaq(opt, didx, bad_q, bad_l)
        with pytest.raises(ValueError, match=what):
            smem._seed_strategy_scan(didx, bad_q, bad_l, 19, 20)
    with pytest.raises(ValueError, match="slots"):
        smem_fused.rounds12_megaq(opt, didx, arr, lens, slots=0)


@pytest.mark.parametrize("idt", ["int32", "int64"])
def test_k2_refuses_reads_too_long(genomes, monkeypatch, idt):
    """K2 keeps a read's stacks in a block's shared memory: a read length
    past its limit raises RuntimeError naming the limit, and no plain
    route seeds it instead (the CPU route refuses what the card
    refuses)."""
    fmi, _, reads = genomes["test"]
    didx = _didx(fmi, idt)
    most = smem_fused.k2_max_len(didx.idt)

    def no_plain(*a, **kw):
        raise AssertionError("the plain version seeded a refused read")

    monkeypatch.setattr(smem_fused, "rounds12_plain", no_plain)
    arr = torch.full((1, most + 1), 4, dtype=torch.uint8)
    arr[0, :100] = torch.from_numpy(reads[0])
    lens = torch.tensor([100], dtype=torch.int32)
    with pytest.raises(RuntimeError, match=f"at most {most} bases"):
        smem_fused.rounds12_megaq(MemOpt(), didx, arr, lens)


def test_other_seed_modes_raise(genomes):
    fmi, _, reads = genomes["test"]
    didx = _didx(fmi, "int32")
    arr, lens = _pack(reads[:2])
    for mode in ("mega", "fused", "split", "cursor", "reach"):
        with pytest.raises(NotImplementedError, match="on purpose"):
            smem.collect_intv_device(MemOpt(), didx, arr, lens, fmi,
                                     mode=mode)
    with pytest.raises(ValueError, match="unknown"):
        smem.collect_intv_device(MemOpt(), didx, arr, lens, fmi, mode="gpu")

"""tpubwa_torch/dist/index_tp.py's TpIndex (the FM-index in row slabs
across devices, the counterpart of tpubwa/dist/index_tp.py) on CPU
devices, against tpubwa on JAX-CPU, on tests/test_index_tp.py's
30,000-base random genome: its occ4 equals tpubwa's TpIndex.occ4 over
the 8-device mesh; its occ4, bwt_extend and marked sa_lookup equal
tpubwa's flat primitives and the port's flat index over 1, 2, 3 and 8
slabs (each 1/n of the padded rows), cut from the port's FMIndex and
from tpubwa's own arrays; rounds12_megaq over it equals tpubwa's
seed_machine_tp row for row; mode megaq's fused SA walk over it equals
the one without it; a mark-less index raises, as tpubwa's does; and the
aligner over it (alone, and with a DataParallel) gives the regions and
SAM of one device and of tpubwa's aligner.  tpubwa's tp functions run
once each (every occ read is a collective on the virtual mesh).
Tolerance 0.  The kernels' own tests are tests/test_torch_tp_host.py."""
import numpy as np
import pytest
import torch

import tpubwa.device  # noqa: F401  (x64, as the JAX package runs)
import jax
import jax.numpy as jnp
import tpubwa.host.pipeline
import tpubwa.index
import tpubwa.opts
from jax.sharding import Mesh
from tpubwa.device import occ as jocc
from tpubwa.device.pipeline import make_device_aligner as jax_aligner
from tpubwa.device.smem_fused import (_r2_jobs_from,
                                      decode_chunk_machine_q)
from tpubwa.device.smem_split import _stack_P
from tpubwa.dist import index_tp as jtp
from tpubwa_torch.device import occ as tocc
from tpubwa_torch.device import pipeline as tpl
from tpubwa_torch.device import smem, smem_fused
from tpubwa_torch.device.occ import DeviceIndex
from tpubwa_torch.dist import index_tp
from tpubwa_torch.dist.dryrun import dryrun_multidevice
from tpubwa_torch.dist.index_tp import TpIndex
from tpubwa_torch.dist.sharding import DataParallel
from tpubwa_torch.host.pipeline import process_seqs
from tpubwa_torch.index import FMIndex
from tpubwa_torch.index.build import BntSeq, SeqAnn
from tpubwa_torch.opts import MEM_F_PE, MemOpt
from simread import simulate_pairs
from test_torch_dist import _flat, _reads
from test_torch_occ import fetch

SLABS = (1, 2, 3, 8)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """tests/test_index_tp.py's genome (30,000 random bases, seed 3)
    built by both packages; tpubwa's flat index and its TpIndex over the
    8-device mesh; the stock-bwa round trip of the port's."""
    assert len(jax.devices()) == 8
    n = 30000
    codes = np.random.default_rng(3).integers(0, 4, n).astype(np.uint8)
    fmi = FMIndex.build(BntSeq(l_pac=n, anns=[SeqAnn(
        name="t", anno="", offset=0, length=n, n_ambs=0)], ambs=[],
        seed=11, codes=codes))
    jfmi = tpubwa.index.FMIndex.build(tpubwa.index.build.BntSeq(
        l_pac=n, anns=[tpubwa.index.build.SeqAnn(
            name="t", anno="", offset=0, length=n, n_ambs=0)], ambs=[],
        seed=11, codes=codes))
    for k in ("L2", "bwt_words", "occ_ckpt", "sa_mark_rows", "sa_marked"):
        assert np.array_equal(getattr(fmi, k), getattr(jfmi, k)), k
    d = tmp_path_factory.mktemp("ttp")
    fmi.save_bwa(str(d / "g"))
    jd = jocc.DeviceIndex.from_fmindex(jfmi)
    mesh = Mesh(np.array(jax.devices()), ("tp",))
    return {"fmi": fmi, "jfmi": jfmi, "codes": codes, "jd": jd,
            "jtp": jtp.TpIndex(jfmi, mesh),
            "stock": FMIndex.load_bwa(str(d / "g"))}


@pytest.fixture(scope="module")
def queries(setup):
    """Ranks for occ4 (in [-1, seq_len]) and sa_lookup (in [0, seq_len]),
    intervals from set_intv, and tpubwa's flat answers to each."""
    fmi, jd = setup["fmi"], setup["jd"]
    rng = np.random.default_rng(1)
    m = np.arange(0, fmi.seq_len + 2, 128)
    edges = np.concatenate([[0, 1, fmi.primary - 1, fmi.primary,
                             fmi.primary + 1, fmi.seq_len - 1, fmi.seq_len],
                            m - 1, m, m + 1])
    k = np.concatenate([[-1], edges, rng.integers(-1, fmi.seq_len + 1, 512)])
    k = k[(k >= -1) & (k <= fmi.seq_len)].astype(jd.np_idt)
    ranks = k[k >= 0]
    c = rng.integers(0, 4, 256).astype(jd.np_idt)
    ik = np.array(jocc.set_intv(jd, jnp.asarray(c)))
    want = {"occ4": np.asarray(jocc.occ4(jd, jnp.asarray(k))),
            "sa_lookup": np.asarray(jocc.sa_lookup(jd, jnp.asarray(ranks)))}
    for b in (True, False):
        want[b] = np.asarray(jocc.bwt_extend(jd, jnp.asarray(ik), is_back=b))
    return k, ranks, ik, want


def _tp(setup, build, n):
    if build == "fmindex":
        return TpIndex(setup["fmi"], ["cpu"] * n)
    return TpIndex.from_index(DeviceIndex.from_numpy(fetch(setup["jd"]),
                                                     "cpu"), ["cpu"] * n)


def test_occ4_equals_tpubwa_tp_occ4(setup, queries):
    """Over 8 slabs, as tpubwa's over its 8-device mesh."""
    k, _, _, want = queries
    got = tocc.occ4(TpIndex(setup["fmi"], ["cpu"] * 8), torch.from_numpy(k))
    jgot = np.asarray(setup["jtp"].occ4(jnp.asarray(k)))
    assert np.array_equal(got.numpy(), jgot)
    assert np.array_equal(jgot, want["occ4"])


@pytest.mark.parametrize("n", SLABS)
@pytest.mark.parametrize("build", ["fmindex", "tpubwa"])
def test_primitives_equal_flat(setup, queries, build, n):
    k, ranks, ik, want = queries
    tp = _tp(setup, build, n)
    flat = DeviceIndex.from_fmindex(setup["fmi"], "cpu")
    assert tp.idt == flat.idt and tp.device == torch.device("cpu")
    for name, per in tp.slab_rows.items():
        slabs = tp.slabs[name]
        assert len(slabs) == n and all(len(s) == per for s in slabs)
        assert per * n == tp.rows_total[name]
        assert tp.rows_total[name] - n < len(getattr(flat, name))
        assert len({s.data_ptr() for s in slabs}) == n   # one block a slab
    assert set(tp.slab_rows) == set(index_tp.SLABBED)
    kt, rt, ikt = (torch.from_numpy(x) for x in (k, ranks, ik))
    got = tocc.occ4(tp, kt)
    assert np.array_equal(got.numpy(), want["occ4"])
    assert torch.equal(got, tocc.occ4(flat, kt))
    got = tocc.sa_lookup(tp, rt)
    assert np.array_equal(got.numpy(), want["sa_lookup"])
    assert torch.equal(got, tocc.sa_lookup(flat, rt))
    for b in (True, False):
        got = tocc.bwt_extend(tp, ikt, b)
        assert np.array_equal(got.numpy(), want[b]), b
        assert torch.equal(got, tocc.bwt_extend(flat, ikt, b))


def test_slab_count_is_checked(setup):
    for n in (0, index_tp.MAX_SLABS + 1):
        with pytest.raises(ValueError):
            TpIndex(setup["fmi"], ["cpu"] * n)


def _machine_reads(jfmi):
    """tests/test_index_tp.py:71's 24 reads: half from the text with 3%
    mutations, half random."""
    rng = np.random.default_rng(7)
    reads = np.empty((24, 80), np.uint8)
    for i in range(24):
        if i % 2 == 0:
            p = int(rng.integers(0, jfmi.bnt.l_pac - 80))
            reads[i] = jfmi.bnt.codes[p:p + 80]
            mut = rng.random(80) < 0.03
            reads[i][mut] = (reads[i][mut] + 1) % 4
        else:
            reads[i] = rng.integers(0, 4, 80)
    return reads, np.full(24, 80, np.int32)


def test_rounds12_equals_tpubwa_seed_machine_tp(setup):
    """tpubwa's seed_machine_tp over its 8-device mesh, with
    tests/test_index_tp.py:71's reads and arguments (each read's job
    from x = 0, rounds 1+2 as rounds12_megaq dispatches them), decoded
    by decode_chunk_machine_q: each read's round-1 rows then its round-2
    rows, in the machine's order, == the port's rounds12_megaq over 8
    slabs, row for row."""
    jd, jfmi = setup["jd"], setup["jfmi"]
    reads, lens = _machine_reads(jfmi)
    jobs = np.zeros((32, 8), jd.np_idt)
    jobs[:, 1] = 1 << 30
    jobs[:, 2] = 1
    jobs[:, 3] = 1
    jobs[:24, 0] = np.arange(24)
    jobs[:24, 1] = 0
    jobs[:24, 2] = 1
    jobs[:24, 3] = 0
    buf = np.asarray(jtp.seed_machine_tp(
        setup["jtp"], reads, lens, jobs, P_=_stack_P(jd), MAXC=12, CAPF=12,
        CAPF2=8, min_seed_len=19, split_len=28, split_width=10, SCAPF=16,
        max_occ=500))
    rows1, lane1, ovf1, rows2, lane2, ovf2, j2n, _ = decode_chunk_machine_q(
        (buf, 32, 24, 64, 12, 8, 16, 500))
    assert not ovf1.any() and not ovf2.any() and len(rows1) > 0
    opt = MemOpt(min_seed_len=19, split_width=10)
    assert smem_fused.split_len_of(opt) == 28
    rid2 = _r2_jobs_from(tpubwa.opts.MemOpt(min_seed_len=19,
                                            split_width=10),
                         28, jd.np_idt, rows1, lane1)[0]
    assert len(rid2) == j2n
    rid = np.concatenate([lane1, np.asarray(rid2)[lane2]]).astype(np.int64)
    rnd = np.concatenate([np.zeros(len(rows1)), np.ones(len(rows2))])
    order = np.lexsort((rnd, rid))          # stable: buffer order kept
    want_rows = np.concatenate([rows1, rows2])[order]
    rows, rids = smem_fused.rounds12_megaq(
        opt, TpIndex(setup["fmi"], ["cpu"] * 8), torch.from_numpy(reads),
        torch.from_numpy(lens))
    assert np.array_equal(rids.numpy(), rid[order])
    assert np.array_equal(rows.numpy(), want_rows)


@pytest.mark.parametrize("max_mem_intv", [20, 0])
def test_fused_walk_over_slabs_equals_one_device(setup, monkeypatch,
                                                 max_mem_intv):
    """Mode megaq with the SA walk fused (return_sa): over 3 slabs (K2's
    rows and every rank of rounds 1-3 walked on the slabs, round 3 on
    the whole index) == without them: rows, read ids and (cnt, pos)."""
    fmi = setup["fmi"]
    reads, lens = _machine_reads(setup["jfmi"])
    opt = MemOpt(max_mem_intv=max_mem_intv)
    didx = DeviceIndex.from_fmindex(fmi, "cpu")
    tp = TpIndex(fmi, ["cpu"] * 3)
    walked = []
    real = tocc.sa_lookup_plain

    def spy(index, ranks, stats=None):
        walked.append((index, len(ranks)))
        return real(index, ranks, stats=stats)

    monkeypatch.setattr(tocc, "sa_lookup_plain", spy)
    want = smem.collect_intv_device(opt, didx, reads, lens, fmi,
                                    mode="megaq", return_sa=True)
    got = smem.collect_intv_device(opt, didx, reads, lens, fmi,
                                   mode="megaq", return_sa=True, tp=tp)
    assert [type(x) for x, _ in walked] == [DeviceIndex, TpIndex]
    assert walked[1][1] == len(want[3][1]) >= len(want[0])
    for a, b in zip((got[0], got[1], *got[3]), (want[0], want[1],
                                                 *want[3])):
        assert np.array_equal(a, b)


def test_mark_less_index_raises_as_tpubwas(setup):
    """A stock-bwa index (no text-position marks) has no walk over the
    slabs: seeding and the SA walk raise, in the port and in tpubwa."""
    stock = setup["stock"]
    assert not stock.sa_mark_D
    tp = TpIndex(stock, ["cpu"] * 2)
    assert set(tp.slab_rows) == {"occ_blocks"}
    reads, lens = _machine_reads(setup["jfmi"])
    qd, ld = torch.from_numpy(reads), torch.from_numpy(lens)
    with pytest.raises(NotImplementedError, match="marked index"):
        smem_fused.rounds12_megaq(MemOpt(), tp, qd, ld)
    with pytest.raises(NotImplementedError, match="marked index"):
        tocc.sa_lookup(tp, torch.arange(1, 9, dtype=tp.idt))
    aligner = tpl.make_device_aligner(MemOpt(), stock, device="cpu", tp=tp)
    with pytest.raises(NotImplementedError, match="marked index"):
        aligner(_reads([("r", reads[0])])[0])
    jt = jtp.TpIndex(_tpubwa_stock(setup), setup["jtp"].mesh)
    with pytest.raises(AssertionError, match="marked index"):
        jt.sa_lookup(jnp.arange(1, 9))
    jd = setup["jd"]
    jobs = np.zeros((32, 8), jd.np_idt)
    with pytest.raises(AttributeError):       # no mark slabs to route
        jtp.seed_machine_tp(jt, reads, lens, jobs, P_=_stack_P(jd), MAXC=12,
                            CAPF=12, CAPF2=8, min_seed_len=19, split_len=28,
                            split_width=10)


def _tpubwa_stock(setup):
    """tpubwa's FMIndex of the port's stock-bwa files."""
    import tempfile
    with tempfile.TemporaryDirectory() as d:
        setup["fmi"].save_bwa(f"{d}/g")
        return tpubwa.index.FMIndex.load_bwa(f"{d}/g")


@pytest.fixture(scope="module")
def pairs(setup):
    """40 simulated 100 bp pairs of the genome, as the port's reads and
    tpubwa's."""
    rng = np.random.default_rng(5)
    recs = [x for n, s1, s2, *_ in simulate_pairs(setup["codes"], 40, 100,
                                                   rng)
            for x in ((n, s1), (n, s2))]
    return _reads(recs)


@pytest.fixture(scope="module")
def one_device(setup, pairs):
    """(regions, SAM) of the port's aligner on one CPU device."""
    opt = MemOpt(flag=MEM_F_PE)
    single = tpl.make_device_aligner(opt, setup["fmi"], device="cpu")
    reads = pairs[0]
    return _flat(single(reads)), process_seqs(opt, setup["fmi"], reads, 0,
                                              align_fn=single)


def test_aligner_over_slabs_equals_one_device_and_tpubwa(setup, pairs,
                                                         one_device):
    reads, jreads = pairs
    opt, jopt = MemOpt(flag=MEM_F_PE), tpubwa.opts.MemOpt(flag=MEM_F_PE)
    aligner = tpl.make_device_aligner(opt, setup["fmi"], device="cpu",
                                      tp=["cpu"] * 3)
    assert isinstance(aligner.tp, TpIndex) and aligner.tp.n == 3
    assert aligner.seed_mode == "megaq"      # tpubwa's mesh default
    assert aligner.didx.seq_len == aligner.tp.seq_len   # whole, for K3
    jax = jax_aligner(jopt, setup["jfmi"], platform="cpu")
    regs, sam = one_device
    assert _flat(aligner(reads)) == regs == _flat(jax(jreads))
    got = process_seqs(opt, setup["fmi"], reads, 0, align_fn=aligner)
    assert got == sam == tpubwa.host.pipeline.process_seqs(
        jopt, setup["jfmi"], jreads, 0, align_fn=jax)
    assert len(sam) >= len(reads)


def test_aligner_over_replicas_and_slabs_equals_one_device(setup, pairs,
                                                            one_device):
    """DataParallel([cpu]*2) with a TpIndex of 3 slabs: each replica's K2
    and fused walk read the one set of slabs."""
    opt = MemOpt(flag=MEM_F_PE)
    reads = pairs[0]
    dp = DataParallel(["cpu"] * 2)
    tp = TpIndex(setup["fmi"], ["cpu"] * 3)
    aligner = tpl.make_device_aligner(opt, setup["fmi"], dp=dp, tp=tp)
    assert aligner.tp is tp and aligner.seed_mode == "megaq"
    try:
        regs, sam = one_device
        assert _flat(aligner(reads)) == regs
        assert process_seqs(opt, setup["fmi"], reads, 0,
                            align_fn=aligner) == sam
        assert all(t["reads"] > 0 for t in dp.tally)
    finally:
        dp.close()


def test_dryrun_tp_leg(monkeypatch):
    monkeypatch.setenv("TPUBWA_DRYRUN_TP_PAIRS", "24")
    facts = dryrun_multidevice(["cpu"] * 3, mb=0.3, n_pairs=32)
    tp = facts["tp"]
    assert tp["reads"] == 48 and tp["records"] >= 48 and tp["slabs"] == 3
    assert tp["seed_mode"] == "megaq"
    for name, per in tp["slab_rows"].items():
        assert per * 3 == tp["rows_total"][name]

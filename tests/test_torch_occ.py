"""tpubwa_torch/device/occ.py's plain FM-index primitives against
tpubwa/device/occ.py's on JAX-CPU, tolerance 0: occ4, occ1, bwt_code,
set_intv, bwt_extend (both directions), inv_psi, the mark-row lookups,
sa_lookup and get_ref_batch, on an index with text-position marks and on
its stock-bwa round trip (no marks: the rank-sampled walk), with int32
and int64 ranks, and with the port's index made from the FMIndex or
carried over from tpubwa's fetched arrays.  The CUDA kernels' own test
is tests/test_torch_occ_host.py."""
import numpy as np
import pytest
import torch

import tpubwa.device  # noqa: F401  (x64, as the JAX package runs)
import jax.numpy as jnp
import tpubwa.index
from tpubwa.device import occ as jocc
from tpubwa.ref.smem import bwt_extend as ref_extend
from tpubwa.ref.smem import set_intv as ref_set_intv
from tpubwa_torch.device import occ as tocc
from tpubwa_torch.device.occ import DeviceIndex
from tpubwa_torch.index import FMIndex
from test_torch_occ_host import edge_intervals

BUILDS = ("fmindex", "numpy32", "numpy64")


def fetch(jdidx, idt=None):
    """A tpubwa DeviceIndex as the numpy mapping from_numpy takes; the
    rank arrays as ``idt`` where given."""
    out = {k: np.asarray(getattr(jdidx, k)) for k in (
        "occ_blocks", "pac_words", "mark_rows", "sa_sample", "L2",
        "sa_marked")}
    out.update(primary=jdidx.primary, seq_len=jdidx.seq_len,
               l_pac=jdidx.l_pac, mark_D=jdidx.mark_D)
    if idt is not None:
        for k in ("sa_sample", "L2", "sa_marked"):
            out[k] = out[k].astype(idt)
    return out


def edge_ranks(fmi, lo, hi, rng, n=512):
    """int64 ranks in [lo, hi]: the ends, primary and its neighbours,
    every multiple of 128 and its neighbours, and n random ones."""
    m = np.arange(0, fmi.seq_len + 2, 128)
    ks = np.concatenate([
        [-1, 0, 1, fmi.primary - 1, fmi.primary, fmi.primary + 1,
         fmi.seq_len - 1, fmi.seq_len], m - 1, m, m + 1,
        rng.integers(lo, hi + 1, n)])
    return ks[(ks >= lo) & (ks <= hi)].astype(np.int64)


@pytest.fixture(scope="module")
def indexes(tmp_path_factory):
    """{"marked" | "unmarked": (port FMIndex, tpubwa FMIndex)}: the
    3,000-base random genome (seed 11) built by both packages from one
    FASTA, and its save_bwa/load_bwa round trip, which has no marks."""
    rng = np.random.default_rng(11)
    codes = rng.integers(0, 4, 3000).astype(np.uint8)
    d = tmp_path_factory.mktemp("tocc")
    fa = d / "g.fa"
    fa.write_text(">g\n" + "".join("ACGT"[c] for c in codes) + "\n")
    fmi = FMIndex.from_fasta(str(fa))
    jfmi = tpubwa.index.FMIndex.from_fasta(str(fa))
    fmi.save_bwa(str(d / "g"))
    out = {"marked": (fmi, jfmi),
           "unmarked": (FMIndex.load_bwa(str(d / "g")),
                        tpubwa.index.FMIndex.load_bwa(str(d / "g")))}
    for name, (f, j) in out.items():
        assert (f.seq_len, f.primary, f.sa_mark_D) == (
            j.seq_len, j.primary, j.sa_mark_D)
        assert f.sa_mark_D == (8 if name == "marked" else 0)
        for k in ("L2", "bwt_words", "occ_ckpt", "sa_sample"):
            assert np.array_equal(getattr(f, k), getattr(j, k)), k
        if f.sa_mark_D:
            assert np.array_equal(f.sa_mark_rows, j.sa_mark_rows)
            assert np.array_equal(f.sa_marked, j.sa_marked)
        assert np.array_equal(f.bnt.codes, j.bnt.codes)
    return out


@pytest.fixture(scope="module")
def jax_side(indexes):
    """{marks: (tpubwa DeviceIndex, the inputs, tpubwa's results)}."""
    out = {}
    for name, (_, jfmi) in indexes.items():
        jdidx = jocc.DeviceIndex.from_fmindex(jfmi)
        rng = np.random.default_rng(5)
        occ_k = edge_ranks(jfmi, -1, jfmi.seq_len, rng)
        walk_k = edge_ranks(jfmi, 0, jfmi.seq_len, rng)
        stored = edge_ranks(jfmi, 0, jfmi.seq_len - 1, rng)
        bases = rng.integers(0, 4, len(occ_k))
        ik = extension_intervals(jfmi, rng)
        starts = np.concatenate([[0, 1, 15, 16, 17, jfmi.bnt.l_pac - 20],
                                 rng.integers(0, jfmi.bnt.l_pac, 60)])
        ins = {"occ_k": occ_k, "walk_k": walk_k, "stored": stored,
               "bases": bases, "ik": ik, "starts": starts}
        J = lambda x: jnp.asarray(x)  # noqa: E731
        res = {"occ4": jocc.occ4(jdidx, J(occ_k)),
               "occ1": jocc.occ1(jdidx, J(occ_k), J(bases)),
               "bwt_code": jocc.bwt_code(jdidx, J(stored)),
               "set_intv": jocc.set_intv(jdidx, J(np.arange(4))),
               "extend_back": jocc.bwt_extend(jdidx, J(ik), True),
               "extend_fwd": jocc.bwt_extend(jdidx, J(ik), False),
               "inv_psi": jocc.inv_psi(jdidx, J(walk_k)),
               "sa_lookup": jocc.sa_lookup(jdidx, J(walk_k)),
               "get_ref_batch": jocc.get_ref_batch(jdidx, J(starts), 24)}
        if jdidx.mark_D:
            res["mark_bit"] = jocc._mark_bit(jdidx, J(walk_k))
            res["mark_index"] = jocc._mark_index(jdidx, J(walk_k))
        out[name] = (jdidx, ins, {k: np.asarray(v) for k, v in res.items()})
    return out


def extension_intervals(jfmi, rng, n=300):
    """int64 [n, 3] intervals: each base's interval from set_intv, then
    0-5 random extension steps (each a nonempty result in a random
    direction), by tpubwa's scalar oracle; the empty interval, the
    whole-text one, and test_torch_occ_host's edge intervals."""
    iks = [[1, 1, 0], [0, 0, jfmi.seq_len + 1]]
    for _ in range(n - 2):
        ik = ref_set_intv(jfmi, int(rng.integers(0, 4)))
        for _ in range(int(rng.integers(0, 6))):
            live = [o for o in ref_extend(jfmi, ik, bool(rng.integers(0, 2)))
                    if o.size > 0]
            if not live:
                break
            ik = live[int(rng.integers(0, len(live)))]
        iks.append([ik.x0, ik.x1, ik.size])
    return np.concatenate([np.asarray(iks, np.int64), edge_intervals(jfmi)])


def port_index(indexes, jax_side, marks, build):
    fmi = indexes[marks][0]
    if build == "fmindex":
        return DeviceIndex.from_fmindex(fmi, "cpu")
    idt = np.int64 if build == "numpy64" else None
    return DeviceIndex.from_numpy(fetch(jax_side[marks][0], idt), "cpu")


@pytest.mark.parametrize("marks", ["marked", "unmarked"])
def test_port_index_holds_tpubwas_arrays(indexes, jax_side, marks):
    """The port's index, from the FMIndex and carried over, holds the
    arrays of tpubwa's, bit for bit; idt follows the carried arrays."""
    jdidx = jax_side[marks][0]
    want = fetch(jdidx)
    for build in BUILDS:
        didx = port_index(indexes, jax_side, marks, build)
        assert didx.idt == (torch.int64 if build == "numpy64"
                            else torch.int32)
        assert (didx.primary, didx.seq_len, didx.l_pac, didx.mark_D) == (
            jdidx.primary, jdidx.seq_len, jdidx.l_pac, jdidx.mark_D)
        for k in ("occ_blocks", "pac_words", "mark_rows"):
            assert np.array_equal(
                getattr(didx, k).numpy().view(np.uint32), want[k]), k
        for k in ("sa_sample", "L2", "sa_marked"):
            assert getattr(didx, k).dtype == didx.idt
            assert np.array_equal(getattr(didx, k).numpy(), want[k]), k


@pytest.mark.parametrize("build", BUILDS)
@pytest.mark.parametrize("marks", ["marked", "unmarked"])
@pytest.mark.parametrize("fn", [
    "occ4", "occ1", "bwt_code", "set_intv", "extend_back", "extend_fwd",
    "inv_psi", "sa_lookup", "get_ref_batch"])
def test_primitive_equals_tpubwa(indexes, jax_side, marks, build, fn):
    jdidx, ins, want = jax_side[marks]
    didx = port_index(indexes, jax_side, marks, build)
    T = lambda x: torch.from_numpy(  # noqa: E731
        np.ascontiguousarray(x, didx.np_idt))
    call = {
        "occ4": lambda: tocc.occ4(didx, T(ins["occ_k"])),
        "occ1": lambda: tocc.occ1(didx, T(ins["occ_k"]), T(ins["bases"])),
        "bwt_code": lambda: tocc.bwt_code(didx, T(ins["stored"])),
        "set_intv": lambda: tocc.set_intv(didx, T(np.arange(4))),
        "extend_back": lambda: tocc.bwt_extend(didx, T(ins["ik"]), True),
        "extend_fwd": lambda: tocc.bwt_extend(didx, T(ins["ik"]), False),
        "inv_psi": lambda: tocc.inv_psi(didx, T(ins["walk_k"])),
        "sa_lookup": lambda: tocc.sa_lookup(didx, T(ins["walk_k"])),
        "get_ref_batch": lambda: tocc.get_ref_batch(
            didx, T(ins["starts"]), 24)}[fn]
    got = call()
    if fn not in ("get_ref_batch",):
        assert got.dtype == didx.idt
    assert got.shape == want[fn].shape
    assert np.array_equal(got.numpy(), want[fn]), fn


@pytest.mark.parametrize("build", BUILDS)
def test_mark_lookups_equal_tpubwa(indexes, jax_side, build):
    jdidx, ins, want = jax_side["marked"]
    didx = port_index(indexes, jax_side, "marked", build)
    k = torch.from_numpy(ins["walk_k"].astype(didx.np_idt))
    assert np.array_equal(tocc._mark_bit(didx, k).numpy(), want["mark_bit"])
    assert np.array_equal(tocc._mark_index(didx, k).numpy(),
                          want["mark_index"])
    # every walk ends on a mark within mark_D - 1 steps
    assert want["mark_bit"].any() and not want["mark_bit"].all()


@pytest.mark.parametrize("marks", ["marked", "unmarked"])
def test_sa_lookup_equals_the_scalar_walk(indexes, marks):
    """Both walks against FMIndex.sa, the scalar rank-sampled walk; the
    stats count a rank's LF steps and the reads of its walk."""
    fmi = indexes[marks][0]
    didx = DeviceIndex.from_fmindex(fmi, "cpu")
    ranks = np.random.default_rng(3).integers(0, fmi.seq_len + 1, 400)
    stats = {}
    got = tocc.sa_lookup_plain(didx, torch.from_numpy(ranks.astype(
        np.int32)), stats=stats)
    assert got.tolist() == [fmi.sa(int(r)) for r in ranks]
    steps = stats["steps"]
    assert len(stats["samples"]) == len(ranks)
    assert len(stats["occ_rows"]) == int(steps.sum())
    if marks == "marked":
        assert int(steps.max()) <= fmi.sa_mark_D - 1
        # a mark test before each step and one at the end of each walk
        assert len(stats["mark_rows"]) == int(steps.sum()) + len(ranks)
    else:
        assert int(steps.max()) > fmi.sa_mark_D and not len(
            stats["mark_rows"])


def test_block_counts_equal_tpubwa():
    rng = np.random.default_rng(7)
    words = rng.integers(0, 1 << 32, (300, 8), dtype=np.uint64).astype(
        np.uint32)
    words[:4] = np.asarray([0, 0xFFFFFFFF, 0x55555555, 0xAAAAAAAA],
                           np.uint32)[:, None]
    nb = rng.integers(0, 129, 300)
    nb[:6] = [0, 1, 16, 17, 127, 128]
    want = np.asarray(jocc._block_counts(jnp.asarray(words),
                                         jnp.asarray(nb)))
    got = tocc._block_counts(torch.from_numpy(words.astype(np.int64)),
                             torch.from_numpy(nb))
    assert np.array_equal(got.numpy(), want)


def test_counts_past_2_31_stay_unsigned():
    """A checkpoint count above 2^31 (GRCh38 scale) reads as itself in
    occ4 and inv_psi, not as a negative int32."""
    big = (1 << 31) + 12345
    row = np.zeros((1, 12), np.uint32)
    row[0, :4] = [big, big + 1, big + 2, big + 3]
    row[0, 4] = 0x1B1B1B1B          # ACGT repeated
    arrays = {"occ_blocks": row, "pac_words": np.zeros(1, np.uint32),
              "mark_rows": np.zeros((1, 8), np.uint32),
              "sa_sample": np.zeros(1, np.int64),
              "L2": np.asarray([0, 1 << 32, 2 << 32, 3 << 32, 4 << 32],
                               np.int64),
              "sa_marked": np.zeros(1, np.int64), "primary": 100,
              "seq_len": 1 << 32, "l_pac": 1 << 31, "mark_D": 0}
    didx = DeviceIndex.from_numpy(arrays, "cpu")
    assert didx.idt == torch.int64
    got = tocc.occ4(didx, torch.tensor([3], dtype=torch.int64))
    assert got.tolist() == [[big + 1, big + 2, big + 3, big + 4]]
    # x = 3 is base T, the 4th of its block: L2[3] + count + 1
    assert tocc.inv_psi(didx, torch.tensor([3])).tolist() == [
        (3 << 32) + big + 3 + 1]


def test_fm_arrays_upload_at_first_use(indexes):
    fmi = indexes["marked"][0]
    built = []
    didx = DeviceIndex.from_fmindex(fmi, "cpu")
    source = didx.fm_source
    didx.fm_source = lambda: built.append(1) or source()
    assert didx._fm is None and not built
    tocc.occ4(didx, torch.tensor([5], dtype=torch.int32))
    tocc.sa_lookup(didx, torch.tensor([5], dtype=torch.int32))
    assert built == [1] and set(didx._fm) == set(tocc.FM_ARRAYS)


class _CudaTyped:
    """A tensor's face with a CUDA device, for a box that has none."""

    def __init__(self, t):
        self.t, self.device = t, torch.device("cuda", 0)
        self.dtype, self.shape = t.dtype, t.shape

    def dim(self):
        return self.t.dim()


def test_a_cuda_call_never_reaches_the_plain_version(indexes, monkeypatch):
    """A CUDA tensor launches the kernel or raises: here the build
    raises, and neither plain version is called."""
    didx = DeviceIndex.from_fmindex(indexes["unmarked"][0], "cpu")
    didx.device = torch.device("cuda", 0)

    def plain(*a, **k):
        raise AssertionError("the plain version was called")

    def no_build(name, signatures):
        raise RuntimeError(f"nvcc not found (building {name})")

    monkeypatch.setattr(tocc, "sa_lookup_plain", plain)
    monkeypatch.setattr(tocc, "bwt_extend_plain", plain)
    monkeypatch.setattr(tocc._build, "load", no_build)
    before = (tocc.sa_lookup.launches, tocc.bwt_extend.launches)
    with pytest.raises(RuntimeError, match="nvcc not found .building occ"):
        tocc.sa_lookup(didx, _CudaTyped(torch.zeros(4, dtype=torch.int32)))
    for is_back in (True, False):
        with pytest.raises(RuntimeError, match="nvcc not found"):
            tocc.bwt_extend(didx, _CudaTyped(
                torch.zeros((4, 3), dtype=torch.int32)), is_back)
    assert (tocc.sa_lookup.launches, tocc.bwt_extend.launches) == before


@pytest.mark.parametrize("bad,err", [
    (torch.zeros(4, dtype=torch.int64), TypeError),
    (torch.zeros((4, 1), dtype=torch.int32), ValueError),
    (torch.zeros(4, dtype=torch.int32, device="meta"), ValueError)])
def test_wrappers_check_their_inputs(indexes, bad, err):
    didx = DeviceIndex.from_fmindex(indexes["marked"][0], "cpu")
    with pytest.raises(err):
        tocc.sa_lookup(didx, bad)
    with pytest.raises(err):
        tocc.bwt_extend(didx, bad, True)

"""tpubwa_torch's entry step (tpubwa_torch/entry.py) and the reach it
seeds with (device/smem.py:rightmost_reach, K-reach on the card).

* ``rightmost_reach_plain`` == tpubwa's ``_rightmost_reach`` (and
  ``rightmost_reach_all`` == ``_rightmost_reach_all``) on JAX-CPU, on a
  3,000-base genome with an A run, int32 and int64 ranks, reads with N
  bases and SNPs, lengths below the tile and min_intv above 1;
* csrc/occ.cu's K-reach (``tpubwa_rightmost_reach``) on the host harness
  (csrc/occ_host.cpp, ASan/UBSan, both lane orders) == the plain version
  == tpubwa's, on read-major jobs (a read's jobs chained right to left),
  the same shuffled, mixed min_intv and reads with Ns, clipped starts
  and every length; with a segment's edge inside a chain on a grid
  smaller than the segments; and with fewer trips than the plain walk;
* ``entry(device="cpu")``'s step == tpubwa's jitted step
  (``__graft_entry__.entry``): e, pos and the extension score;
* seed mode ``reach``, built on the same reach, seeds a chunk as tpubwa's
  mode reach does (tests/test_torch_seed_modes.py holds it whole); mega,
  fused and split raise.

Tolerance 0."""
import dataclasses

import numpy as np
import pytest
import torch

import tpubwa.device  # noqa: F401  (x64, as the JAX package runs)
import jax
import jax.numpy as jnp
import tpubwa.index
import tpubwa.opts
from tpubwa.device import smem as jsmem
from tpubwa.device.occ import DeviceIndex as JaxIndex
from tpubwa.device.smem import _rightmost_reach, _rightmost_reach_all
from tpubwa.index.build import BntSeq as JaxBnt, SeqAnn as JaxAnn
from tpubwa_torch import entry as te
from tpubwa_torch.device import occ as tocc
from tpubwa_torch.device import smem, warp_host
from tpubwa_torch.device.occ import DeviceIndex
from tpubwa_torch.device.smem import collect_intv_device
from tpubwa_torch.index import FMIndex
from tpubwa_torch.index.build import BntSeq, SeqAnn
from tpubwa_torch.opts import MemOpt
from test_torch_occ_host import host_arrays


@pytest.fixture(scope="module")
def genome():
    """(port index on the CPU, tpubwa's DeviceIndex, reads uint8 [24,
    48], lens int32 [24]): 3,000 random bases with a 40-base A run, reads
    cut from the doubled text with two SNPs or N each, one inside the A
    run, lengths 0 to 48."""
    rng = np.random.default_rng(19)
    n = 3000
    codes = rng.integers(0, 4, n).astype(np.uint8)
    codes[500:540] = 0
    ann = dict(name="g", anno="", offset=0, length=n, n_ambs=0)
    fmi = FMIndex.build(BntSeq(l_pac=n, anns=[SeqAnn(**ann)], ambs=[],
                               seed=11, codes=codes))
    jfmi = tpubwa.index.FMIndex.build(JaxBnt(
        l_pac=n, anns=[JaxAnn(**ann)], ambs=[], seed=11, codes=codes))
    text = fmi.bnt.doubled()
    B, L = 24, 48
    reads = np.zeros((B, L), np.uint8)
    for i in range(B):
        s = 495 if i == 3 else int(rng.integers(0, len(text) - L))
        reads[i] = text[s:s + L]
        if i != 3:
            reads[i, rng.integers(0, L, 2)] = rng.integers(0, 5, 2)
    lens = rng.integers(0, L + 1, B).astype(np.int32)
    lens[3] = L
    return (DeviceIndex.from_fmindex(fmi, "cpu"),
            JaxIndex.from_fmindex(jfmi), reads, lens)


def _index(base, idt):
    return base if idt == "int32" else dataclasses.replace(
        base, idt=torch.int64, _fm=None)


def _jobs(reads, rng):
    B, L = reads.shape
    read_idx = np.repeat(np.arange(B, dtype=np.int32), L)
    starts = np.tile(np.arange(L, dtype=np.int32), B)
    min_intv = rng.choice([1, 1, 2, 3, 8], B * L).astype(np.int64)
    return read_idx, starts, min_intv


@pytest.mark.parametrize("idt", ["int32", "int64"])
def test_reach_plain_equals_jax(genome, idt):
    base, jdidx, reads, lens = genome
    didx = _index(base, idt)
    ri, st, mi = _jobs(reads, np.random.default_rng(3))
    jik, je = _rightmost_reach(jdidx, jnp.asarray(reads, jnp.int32),
                               jnp.asarray(lens), jnp.asarray(ri),
                               jnp.asarray(st), jnp.asarray(mi, jnp.int32))
    stats = {}
    args = [torch.from_numpy(x) for x in (reads, lens, ri, st)]
    ik, e = smem.rightmost_reach_plain(
        didx, *args, torch.from_numpy(mi).to(didx.idt), stats=stats)
    assert ik.dtype == e.dtype == didx.idt and ik.shape == (len(ri), 3)
    assert ik.numpy().tolist() == np.asarray(jik).reshape(-1, 3).tolist()
    assert e.numpy().tolist() == np.asarray(je).tolist()
    # the A run makes the longest walk; some jobs fail at once
    assert stats["rounds"] >= 30 and int((e.numpy() == st).sum()) > 0
    # the routed function takes the plain version on the CPU, and int32
    # codes the same as uint8
    ik2, e2 = smem.rightmost_reach(
        didx, torch.from_numpy(reads.astype(np.int32)), *args[1:],
        torch.from_numpy(mi).to(didx.idt))
    assert torch.equal(ik2, ik) and torch.equal(e2, e)


def test_reach_all_equals_jax(genome):
    base, jdidx, reads, lens = genome
    jik, je = _rightmost_reach_all(jdidx, jnp.asarray(reads, jnp.int32),
                                   jnp.asarray(lens))
    ik, e = smem.rightmost_reach_all(base, torch.from_numpy(reads),
                                     torch.from_numpy(lens))
    assert ik.numpy().tolist() == np.asarray(jik).reshape(-1, 3).tolist()
    assert e.numpy().tolist() == np.asarray(je).tolist()


@pytest.mark.parametrize("idt", ["int32", "int64"])
def test_reach_kernel_on_the_host_harness(genome, idt):
    base, _, reads, lens = genome
    didx = _index(base, idt)
    ri, st, mi = _jobs(reads, np.random.default_rng(4))
    mi = mi.astype(didx.np_idt)
    want = smem.rightmost_reach_plain(
        didx, *(torch.from_numpy(x) for x in (reads, lens, ri, st, mi)))
    got = warp_host.reach_host(host_arrays(didx), reads, lens, ri, st, mi)
    assert got[0].dtype == didx.np_idt
    assert got[0].tolist() == want[0].numpy().tolist()
    assert got[1].tolist() == want[1].numpy().tolist()


def test_reach_refusals(genome):
    base, _, reads, lens = genome
    q, ln = torch.from_numpy(reads), torch.from_numpy(lens)
    ri = torch.zeros(3, dtype=torch.int32)
    mi = torch.ones(3, dtype=torch.int32)
    with pytest.raises(TypeError, match="min_intv"):
        smem.rightmost_reach(base, q, ln, ri, ri, mi.long())
    with pytest.raises(ValueError, match="jobs"):
        smem.rightmost_reach(base, q, ln, ri, ri[:2], mi)
    with pytest.raises(ValueError, match="outside"):
        smem.rightmost_reach(base, q, ln, ri + 99, ri, mi)


def test_entry_step_equals_jax():
    """The port's entry step on the CPU (the plain versions) == tpubwa's
    jitted step on JAX-CPU: e, pos and score; the CPU launches
    nothing."""
    import __graft_entry__
    fn, args = __graft_entry__.entry()
    want = [np.asarray(x) for x in jax.jit(fn)(*args)]
    launches = smem.rightmost_reach.launches
    step, targs = te.entry(device="cpu")
    got = step(*targs)
    assert [tuple(g.shape) for g in got] == [(4096,), (4096,), (64,)]
    for name, g, w in zip(("e", "pos", "score"), got, want):
        assert g.numpy().tolist() == w.reshape(-1).tolist(), name
    assert smem.rightmost_reach.launches == launches


def test_entry_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        te.entry()


def test_device_modes_seed_as_tpubwa_reach(genome):
    """reach, cursor, mega, fused and split seed the fixture's reads
    (lengths 0 to 48, N bases, an A run) as tpubwa's reach does, rows and
    read ids in order."""
    base, jdidx, reads, lens = genome
    jflat, jfrid = jsmem.collect_intv_device(
        tpubwa.opts.MemOpt(), jdidx, reads, lens, mode="reach",
        return_flat=True)
    for mode in ("reach", "cursor", "mega", "fused", "split"):
        flat, frid, _ = collect_intv_device(MemOpt(), base, reads, lens,
                                            None, mode=mode)
        assert flat.tolist() == np.asarray(jflat).tolist()
        assert frid.tolist() == np.asarray(jfrid).tolist()
    assert len(jflat) > 0


def _edge_reads(reads, lens, rng):
    """The fixture's reads with N runs (at a read's first base, three in
    a row, the last column) and codes past 4 in some, every length from
    0 to L (the A run's read kept whole)."""
    B, L = reads.shape
    out = reads.copy()
    for i in range(B):
        if i == 3:
            continue
        out[i, rng.integers(0, L, 3)] = 4
        if i % 4 == 0:
            out[i, 0] = 4
        if i % 5 == 1:
            at = int(rng.integers(0, L - 3))
            out[i, at:at + 3] = 4
        if i % 7 == 2:
            out[i, L - 1] = 4 + i % 3
    lens = lens.copy()
    lens[:L + 1 if B > L else B] = np.arange(min(B, L + 1), dtype=np.int32)
    lens[3] = L
    return out, lens


def _job_sets(reads, lens):
    """{name: (reads, lens, read_idx, starts, min_intv int64)}: K-reach's
    four job sets over the fixture's reads: every start of every read,
    read-major (one chain a read, as reach_jobs builds them); the same
    jobs shuffled (no two linked); mixed min_intv (_jobs: most links
    broken); and, on reads with Ns and every length, starts -2 to L + 1
    of every read with one min_intv a read from 0, 1, 2 and 5 (chains
    across clipped positions, Ns and the read's end; min_intv 0 keeps
    intervals of size 0; the last job left out)."""
    rng = np.random.default_rng(23)
    B, L = reads.shape
    ri = np.repeat(np.arange(B, dtype=np.int32), L)
    st = np.tile(np.arange(L, dtype=np.int32), B)
    ones = np.ones(B * L, np.int64)
    perm = rng.permutation(B * L)
    mixed = _jobs(reads, np.random.default_rng(3))
    er, el = _edge_reads(reads, lens, rng)
    span = np.arange(-2, L + 2, dtype=np.int32)
    eri = np.repeat(np.arange(B, dtype=np.int32), len(span))
    emi = np.repeat(rng.choice([0, 1, 2, 5], B), len(span)).astype(np.int64)
    return {"read-major": (reads, lens, ri, st, ones),
            "shuffled": (reads, lens, ri[perm], st[perm], ones[perm]),
            "mixed-min-intv": (reads, lens, *mixed),
            "edges": (er, el, eri[:-1], np.tile(span, B)[:-1], emi[:-1])}


def _reach_jax(jdidx, reads, lens, ri, st, mi):
    jik, je = _rightmost_reach(jdidx, jnp.asarray(reads, jnp.int32),
                               jnp.asarray(lens), jnp.asarray(ri),
                               jnp.asarray(st), jnp.asarray(mi, jnp.int32))
    return np.asarray(jik).reshape(-1, 3), np.asarray(je)


@pytest.mark.parametrize("idt", ["int32", "int64"])
@pytest.mark.parametrize("name", ["read-major", "shuffled", "mixed-min-intv",
                                  "edges"])
def test_chained_reach_equals_plain_and_jax(genome, name, idt):
    """K-reach's chained design on the host harness, in both lane
    orders, == rightmost_reach_plain == tpubwa's _rightmost_reach on
    JAX-CPU, ik and e, on each job set."""
    base, jdidx, reads0, lens0 = genome
    didx = _index(base, idt)
    reads, lens, ri, st, mi = _job_sets(reads0, lens0)[name]
    mi = mi.astype(didx.np_idt)
    want = smem.rightmost_reach_plain(
        didx, *(torch.from_numpy(x) for x in (reads, lens, ri, st, mi)))
    jik, je = _reach_jax(jdidx, reads, lens, ri, st, mi)
    assert want[0].numpy().tolist() == jik.tolist()
    assert want[1].numpy().tolist() == je.tolist()
    for reverse in (False, True):
        ik, e = warp_host.reach_host(host_arrays(didx), reads, lens, ri, st,
                                     mi, reverse=reverse)
        assert ik.dtype == didx.np_idt
        assert ik.tolist() == want[0].numpy().tolist(), reverse
        assert e.tolist() == want[1].numpy().tolist(), reverse


def test_reach_segment_boundary_inside_a_chain(genome):
    """Jobs placed so that a segment's edge (a multiple of kSeg) falls
    inside a read's chain: the segment to its right walks forward from
    its own right end, the one to its left from its own.  On a card of
    one SM holding one block, so that lanes take segment after segment
    from the queue, in both lane orders: == the plain walk."""
    base, _, reads, lens = genome
    from tpubwa_torch.scripts.exp_reach_forms import constant
    seg = constant("kSeg")
    B, L = reads.shape
    pre = seg // 2 + ((seg - seg // 2) % L == 0)
    ri = np.concatenate([np.full(pre, 5, np.int32),
                         np.repeat(np.arange(B, dtype=np.int32), L)])
    st = np.concatenate([np.zeros(pre, np.int32),
                         np.tile(np.arange(L, dtype=np.int32), B)])
    mi = np.ones(len(ri), np.int32)
    edges = np.arange(seg, len(ri), seg)
    assert (ri[edges - 1] == ri[edges]).any()  # a chain crosses an edge
    # more segments than a warp has lanes: the harness runs a launch's
    # warps one after another, so the first warp's lanes take more
    assert len(edges) + 1 > 32
    want = smem.rightmost_reach_plain(
        base, *(torch.from_numpy(x) for x in (reads, lens, ri, st, mi)))
    for reverse in (False, True):
        ik, e = warp_host.reach_host(host_arrays(base), reads, lens, ri, st,
                                     mi, reverse=reverse, card=(1, 1))
        assert ik.tolist() == want[0].numpy().tolist(), reverse
        assert e.tolist() == want[1].numpy().tolist(), reverse


def test_chained_reach_reads_fewer_rows(genome):
    """On read-major jobs (one chain a read) the chained design makes
    far fewer extension steps (trips) than the plain walk, one a job
    step, and loads fewer occ rows: the backward steps are taken.  On
    the shuffled jobs no job has a linked neighbour, so it steps as the
    plain walk does."""
    base, _, reads0, lens0 = genome
    sets = _job_sets(reads0, lens0)
    got = {}
    for name in ("read-major", "shuffled"):
        reads, lens, ri, st, mi = sets[name]
        mi = mi.astype(np.int32)
        stats, pstats = {}, {}
        warp_host.reach_host(host_arrays(base), reads, lens, ri, st, mi,
                             stats=stats)
        smem.rightmost_reach_plain(
            base, *(torch.from_numpy(x) for x in (reads, lens, ri, st, mi)),
            stats=pstats)
        got[name] = (stats, int(pstats["steps"].sum()),
                     len(pstats["occ_rows"]), len(ri))
    stats, plain_steps, plain_rows, n = got["read-major"]
    assert stats["steps"] * 4 < plain_steps and stats["steps"] < 8 * n
    assert stats["row_loads"] * 4 < plain_rows
    # the distinct rows come ascending, each once
    assert (np.diff(stats["rows"]) > 0).all() and len(stats["rows"])
    stats, plain_steps, _, _ = got["shuffled"]
    assert stats["steps"] == plain_steps


def _form_names():
    from tpubwa_torch.scripts import exp_reach_forms
    return list(exp_reach_forms.forms())


def test_reach_forms_edit_the_sources_once():
    """scripts/exp_reach_forms.py's forms are the sources with named
    edits, each of which must find its text exactly once (the script
    refuses otherwise, on the card): the first designs restored, the
    shipped sources, and every other segment length and group size."""
    from tpubwa_torch.device import _build
    from tpubwa_torch.scripts import exp_reach_forms as xf
    forms = xf.forms()
    assert forms["shipped"] == [] and len(forms["first"]) == 4
    assert len(forms) == (len(xf.SEGMENTS) + len(xf.REACH_GROUPS)
                          + len(xf.EXT_GROUPS))
    for form, edits in forms.items():
        for name, old, new in edits:
            assert name in xf.SOURCES, form
            text = (_build.CSRC / name).read_text()
            assert text.count(old) == 1 and new not in text, (form, old)


@pytest.mark.parametrize("form", _form_names())
def test_reach_forms_equal_plain_on_the_harness(genome, form, tmp_path):
    """Every form of scripts/exp_reach_forms.py, its edits applied to a
    copy of the sources and built as the host harness: K-reach on the
    read-major and the mixed-min_intv jobs and K-ext in both directions
    == the plain versions, so that the forms timed on the card compute
    what the package does."""
    import shutil
    from tpubwa_torch.device import _build
    from tpubwa_torch.scripts import exp_reach_forms as xf
    for name in warp_host.SOURCES["occ_host"]:
        shutil.copy(_build.CSRC / name, tmp_path / name)
    for name, old, new in xf.forms()[form]:
        text = (tmp_path / name).read_text()
        (tmp_path / name).write_text(text.replace(old, new))
    base, _, reads0, lens0 = genome
    arrays = host_arrays(base)
    sets = _job_sets(reads0, lens0)
    for name in ("read-major", "mixed-min-intv"):
        reads, lens, ri, st, mi = sets[name]
        mi = mi.astype(np.int32)
        want = smem.rightmost_reach_plain(
            base, *(torch.from_numpy(x) for x in (reads, lens, ri, st, mi)))
        ik, e = warp_host.reach_host(arrays, reads, lens, ri, st, mi,
                                     sanitize=False, csrc=tmp_path)
        assert ik.tolist() == want[0].numpy().tolist(), name
        assert e.tolist() == want[1].numpy().tolist(), name
    rng = np.random.default_rng(8)
    ik = tocc.set_intv(base, torch.from_numpy(rng.integers(0, 4, 99)))
    ik = torch.cat([ik, tocc.bwt_extend_plain(base, ik, True)[
        torch.arange(99), torch.from_numpy(rng.integers(0, 4, 99))]])
    _, back, fwd = warp_host.occ_host(arrays, np.zeros(0, np.int32),
                                      ik.numpy(), sanitize=False,
                                      csrc=tmp_path)
    for got, is_back in ((back, True), (fwd, False)):
        assert np.array_equal(got, tocc.bwt_extend_plain(
            base, ik, is_back).numpy()), is_back

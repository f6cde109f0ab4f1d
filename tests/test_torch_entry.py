"""tpubwa_torch's entry step (tpubwa_torch/entry.py) and the reach it
seeds with (device/smem.py:rightmost_reach, K-reach on the card).

* ``rightmost_reach_plain`` == tpubwa's ``_rightmost_reach`` (and
  ``rightmost_reach_all`` == ``_rightmost_reach_all``) on JAX-CPU, on a
  3,000-base genome with an A run, int32 and int64 ranks, reads with N
  bases and SNPs, lengths below the tile and min_intv above 1;
* csrc/occ.cu's K-reach (``tpubwa_rightmost_reach``) on the host harness
  (csrc/occ_host.cpp, ASan/UBSan) == the plain version;
* ``entry(device="cpu")``'s step == tpubwa's jitted step
  (``__graft_entry__.entry``): e, pos and the extension score.

Tolerance 0.  Seed mode ``reach`` itself stays unported: it raises."""
import dataclasses

import numpy as np
import pytest
import torch

import tpubwa.device  # noqa: F401  (x64, as the JAX package runs)
import jax
import jax.numpy as jnp
import tpubwa.index
from tpubwa.device.occ import DeviceIndex as JaxIndex
from tpubwa.device.smem import _rightmost_reach, _rightmost_reach_all
from tpubwa.index.build import BntSeq as JaxBnt, SeqAnn as JaxAnn
from tpubwa_torch import entry as te
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


def test_reach_mode_still_raises(genome):
    base, _, reads, lens = genome
    for mode in ("mega", "fused", "split", "cursor", "reach"):
        with pytest.raises(NotImplementedError, match="on purpose"):
            collect_intv_device(MemOpt(), base, reads, lens, None, mode=mode)

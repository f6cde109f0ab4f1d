"""tpubwa_torch's fused per-seed extension and descriptor tiles
(device/extend_fused.py) vs tpubwa's (Pallas kernel in interpret mode)
and the scalar_fused oracle.  Both packages get the same index state:
tpubwa's DeviceIndex fetched as numpy and carried over with
DeviceIndex.from_numpy.  Tolerance 0."""
import os
import sys

import numpy as np
import pytest
import torch

import tpubwa.device  # noqa: F401  (x64, as the JAX package runs)
import jax.numpy as jnp
from tpubwa.device import extend_fused as jf
from tpubwa.device.occ import DeviceIndex as JaxDeviceIndex
from tpubwa.index import FMIndex
from tpubwa.opts import MemOpt
from tpubwa_torch.device import extend_fused as tf
from tpubwa_torch.device.extend_kernel import extend_batch_plain
from tpubwa_torch.device.occ import DeviceIndex
from tpubwa_torch.index import FMIndex as TorchFMIndex
from test_extend_desc import _materialize, _mk_descs
from test_extend_fused import _rand_job

sys.path.insert(0, os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "scripts"))
from chip_desc_equality import mk_descs as adversarial_descs  # noqa: E402


@pytest.fixture(scope="module")
def fasta(tmp_path_factory):
    rng = np.random.default_rng(5)
    unit = rng.integers(0, 4, 37).astype(np.uint8)
    codes = np.concatenate([
        rng.integers(0, 4, 2000).astype(np.uint8), np.tile(unit, 6),
        rng.integers(0, 4, 2000).astype(np.uint8)])
    p = tmp_path_factory.mktemp("tdesc") / "g.fa"
    p.write_text(">g\n" + "".join("ACGT"[c] for c in codes) + "\n")
    return str(p)


@pytest.fixture(scope="module")
def setup(fasta):
    fmi = FMIndex.from_fasta(fasta)
    jdidx = JaxDeviceIndex.from_fmindex(fmi)
    tdidx = DeviceIndex.from_numpy({
        **{k: np.asarray(getattr(jdidx, k)) for k in (
            "pac_words", "occ_blocks", "sa_sample", "L2", "mark_rows",
            "sa_marked")},
        **{k: getattr(jdidx, k) for k in (
            "l_pac", "seq_len", "primary", "mark_D")}}, device="cpu")
    return fmi, jdidx, tdidx


def _reads(fmi, rng, B=32, L=100):
    """Random reads, half of them genome echoes (high-score paths),
    with N codes in two queries."""
    reads = rng.integers(0, 4, (B, L)).astype(np.uint8)
    text = fmi.bnt.doubled()
    for i in range(0, B, 2):
        s = int(rng.integers(0, len(text) - L))
        reads[i] = text[s:s + L]
    reads[1, 40:42] = 4
    reads[3, 0] = 4
    return reads


def test_from_numpy_equals_from_fmindex(setup, fasta):
    fmi, jdidx, tdidx = setup
    # the port's own index of the same FASTA holds the same reference
    tfmi = TorchFMIndex.from_fasta(fasta)
    assert np.array_equal(tfmi.bnt.codes, fmi.bnt.codes)
    assert (tfmi.bnt.l_pac, tfmi.seq_len) == (fmi.bnt.l_pac, fmi.seq_len)
    direct = DeviceIndex.from_fmindex(tfmi, "cpu")
    assert torch.equal(direct.pac_words, tdidx.pac_words)
    assert (direct.l_pac, direct.seq_len, direct.primary, direct.mark_D) == (
        tdidx.l_pac, tdidx.seq_len, tdidx.primary, tdidx.mark_D)
    assert tdidx.np_idt == jdidx.np_idt == direct.np_idt
    # the int32 bit patterns are the uint32 words
    assert (tdidx.pac_words.numpy().view(np.uint32).tolist()
            == np.asarray(jdidx.pac_words).tolist())


@pytest.mark.parametrize("seed", [0, 1])
def test_fused_passes_equal_jax(seed):
    opt = MemOpt()
    rng = np.random.default_rng(seed)
    jobs = [_rand_job(rng) for _ in range(40)]
    W, tmax = 128, 256
    N = len(jobs)
    qL = np.full((N, W), 4, np.int32)
    qR = np.full((N, W), 4, np.int32)
    tL = np.full((N, tmax), 4, np.int32)
    tR = np.full((N, tmax), 4, np.int32)
    cols = np.zeros((8, N), np.int32)
    for i, (ql, q_l, tl, t_l, qr, q_r, tr, t_r, w, h0, p5, p3) in \
            enumerate(jobs):
        qL[i, :ql], tL[i, :tl] = q_l[:ql], t_l[:tl]
        qR[i, :qr], tR[i, :tr] = q_r[:qr], t_r[:tr]
        cols[:, i] = (ql, tl, qr, tr, h0, w, p5, p3)
    pen = (opt.a, opt.b, opt.o_del, opt.e_del, opt.o_ins, opt.e_ins,
           opt.zdrop)
    want = np.asarray(jf._fused_passes(
        *(jnp.asarray(x) for x in (qL, tL, qR, tR)),
        *(jnp.asarray(c) for c in cols), *pen, tmax, True)).reshape(-1, 16)
    got = tf._fused_passes(
        *(torch.from_numpy(x) for x in (qL, tL, qR, tR)),
        *(torch.from_numpy(c) for c in cols), *pen)
    assert got.dtype == torch.int32
    assert got.numpy().tolist() == want.tolist()
    # the plain and the routed extension agree on the CPU too
    plain = tf._fused_passes(
        *(torch.from_numpy(x) for x in (qL, tL, qR, tR)),
        *(torch.from_numpy(c) for c in cols), *pen,
        extend=extend_batch_plain)
    assert torch.equal(plain, got)


@pytest.mark.parametrize("step_desc", [False, True])
def test_windows_equal_jax(setup, step_desc):
    """Reference and query tiles for every sub-word phase, at both
    ends of both strands, for a tmax that is not a multiple of 16."""
    fmi, jdidx, tdidx = setup
    lp = fmi.bnt.l_pac
    tmax = 250
    p0 = np.concatenate([
        np.arange(16) + 320, np.arange(16) + lp + 96,
        [0, 1, lp - 1, lp, lp + 1, 2 * lp - 1, 2 * lp - 2, 15, 16]])
    tlen = np.random.default_rng(2).integers(0, tmax + 1, len(p0))
    if step_desc:   # windows read downwards from p0, never below 0/l_pac
        tlen = np.minimum(tlen, np.where(p0 >= lp, p0 - lp + 1, p0 + 1))
    else:           # upwards, never past l_pac/2 l_pac
        tlen = np.minimum(tlen, np.where(p0 >= lp, 2 * lp - p0, lp - p0))
    p0 = p0.astype(jdidx.np_idt)
    tlen = tlen.astype(np.int32)
    # per-base codes across both strands
    pos = np.arange(-3, 2 * lp + 3).astype(jdidx.np_idt)
    assert tf._ref_codes(tdidx, torch.from_numpy(pos)).tolist() == \
        np.asarray(jf._ref_codes(jdidx, jnp.asarray(pos))).tolist()
    want = np.asarray(jf._ref_window(jdidx, jnp.asarray(p0), step_desc,
                                     jnp.asarray(tlen), tmax))
    got = tf._ref_window(tdidx, torch.from_numpy(p0), step_desc,
                         torch.from_numpy(tlen), tmax)
    assert got.numpy().tolist() == want.tolist()
    rng = np.random.default_rng(3)
    rows = rng.integers(0, 5, (len(p0), 100)).astype(np.uint8)
    off = np.arange(len(p0), dtype=np.int32) * 7 % 100
    qlen = rng.integers(0, 101, len(p0)).astype(np.int32)
    qlen = np.minimum(qlen, off + 1 if step_desc else 100 - off)
    want = np.asarray(jf._query_window(jnp.asarray(rows),
                                       jnp.asarray(off), step_desc,
                                       jnp.asarray(qlen), 128))
    got = tf._query_window(torch.from_numpy(rows), torch.from_numpy(off),
                           step_desc, torch.from_numpy(qlen), 128)
    assert got.numpy().tolist() == want.tolist()


@pytest.mark.parametrize("kind", ["random", "adversarial"])
def test_desc_np_equal_jax_and_scalar(setup, kind):
    fmi, jdidx, tdidx = setup
    opt = MemOpt()
    mat = opt.scoring_matrix()
    rng = np.random.default_rng(20 if kind == "random" else 21)
    reads = _reads(fmi, rng)
    B, L = reads.shape
    make = _mk_descs if kind == "random" else adversarial_descs
    da = make(rng, fmi.bnt.l_pac, B, L, 48)
    args = (mat, opt.o_del, opt.e_del, opt.o_ins, opt.e_ins, opt.zdrop,
            512)
    want = jf.extend_seed_desc_np(jdidx, jnp.asarray(reads), da, *args)
    got = tf.extend_seed_desc_np(tdidx, torch.from_numpy(reads), da,
                                 *args)
    assert got.dtype == np.int32 and got.shape == (len(da), 16)
    assert got.tolist() == want.tolist()
    for i in range(len(da)):
        job = _materialize(fmi.bnt, reads, da[i])
        ref = tf.scalar_fused(job, mat, opt.o_del, opt.e_del, opt.o_ins,
                              opt.e_ins, opt.zdrop)
        assert ref.tolist() == jf.scalar_fused(
            job, mat, opt.o_del, opt.e_del, opt.o_ins, opt.e_ins,
            opt.zdrop).tolist()
        # the lanes the planner consumes
        if job[0] > 0:
            assert got[i, :6].tolist() == ref[:6].tolist(), i
            assert got[i, 12] == ref[12], i
        if job[4] > 0:
            assert got[i, 6:12].tolist() == ref[6:12].tolist(), i
            assert got[i, 13] == ref[13], i
        assert got[i, 14:].tolist() == ref[14:].tolist(), i


def test_desc_np_empty_and_tuples(setup):
    fmi, _, tdidx = setup
    opt = MemOpt()
    args = (opt.scoring_matrix(), opt.o_del, opt.e_del, opt.o_ins,
            opt.e_ins, opt.zdrop, 512)
    reads = torch.from_numpy(_reads(fmi, np.random.default_rng(4)))
    assert tf.extend_seed_desc_np(
        tdidx, reads, np.zeros((0, 11), np.int64), *args).shape == (0, 16)
    da = _mk_descs(np.random.default_rng(5), fmi.bnt.l_pac, 32, 100, 6)
    rows = tf.extend_seed_desc_np(tdidx, reads, da, *args)
    tuples = tf.extend_seed_desc_np(
        tdidx, reads, [("D",) + tuple(int(x) for x in d) for d in da],
        *args)
    assert rows.tolist() == tuples.tolist()


def test_desc_np_band_retries_equal_jax(setup):
    """Seeds next to a 3-base deletion at w = 4 take the second band
    trial on their left or right side (the masked trial-1 launches)."""
    from chip_smoke import retry_descs
    fmi, jdidx, tdidx = setup
    opt = MemOpt()
    reads, da = retry_descs(fmi.bnt, np.random.default_rng(6), 24)
    args = (opt.scoring_matrix(), opt.o_del, opt.e_del, opt.o_ins,
            opt.e_ins, opt.zdrop, 512)
    want = jf.extend_seed_desc_np(jdidx, jnp.asarray(reads), da, *args)
    got = tf.extend_seed_desc_np(tdidx, torch.from_numpy(reads), da,
                                 *args)
    assert got.tolist() == want.tolist()
    retried = (got[:, 12] == 8) | (got[:, 13] == 8)
    assert retried.all(), got[~retried, 12:14].tolist()


def test_desc_np_rejects_sides_wider_than_the_lanes(setup):
    fmi, _, tdidx = setup
    opt = MemOpt()
    reads = torch.full((1, 640), 1, dtype=torch.uint8)
    # a 581 bp right side: beyond the kernel's 511 lanes
    da = np.asarray([(0, 0, 19, 600, 100, 100, 800, 100, 19, 5, 5)])
    with pytest.raises(ValueError, match="lanes"):
        tf.extend_seed_desc_np(tdidx, reads, da, opt.scoring_matrix(),
                               opt.o_del, opt.e_del, opt.o_ins,
                               opt.e_ins, opt.zdrop, 1024)

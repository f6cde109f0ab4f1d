"""K1-mat: the extension under a general 5 x 5 scoring matrix.

tpubwa_torch's ``extend_batch_plain(mat=)``, ``extend_batch(mat=)`` and
``extend_batch_kernel_np`` against tpubwa's XLA ``extend.extend_batch`` /
``extend_batch_np`` and its ``extend_pallas.extend_batch_pallas_np``
(Pallas in interpret mode), and
csrc/extend.cu's K1-mat instantiation (``tpubwa_extend_mat``) on the
host harness (csrc/warp_host.h, ASan/UBSan) against the plain version,
under four matrices: the entry step's (N against N scores +1), a
transition/transversion one, one with a positive entry off the diagonal
(the band cap moves with it) and bwa_fill_scmat's, where K1-mat must
give K1's rows.  Jobs with N codes on both sides, h0 at the packed
row-max bound and several w and end_bonus.  Tolerance 0."""
import numpy as np
import pytest
import torch

import tpubwa.device  # noqa: F401  (x64, as the JAX package runs)
import jax.numpy as jnp
from tpubwa.device import extend as jx
from tpubwa.device import extend_pallas as jp
from tpubwa_torch.device import extend_kernel as tk
from tpubwa_torch.device import warp_host
from tpubwa_torch.entry import ENTRY_MAT
from tpubwa_torch.opts import MemOpt
from chip_smoke import make_jobs

O = MemOpt()
PEN = (O.o_del, O.e_del, O.o_ins, O.e_ins)
# the entry step's; transition/transversion; a positive entry off the
# diagonal above the match score (mmax 2); bwa_fill_scmat's
MATS = {"entry": ENTRY_MAT, "tt": tk.tt_matrix(),
        "positive": tk.positive_matrix(), "scmat": O.scoring_matrix()}


def jobs(seed, n=96, W=128, tmax=256, mat=None):
    """make_jobs' jobs, with every fifth job's h0 at the packed row-max
    bound of ``mat`` (h0 + mmax * qlen == 2^24 - 1 at W 128)."""
    q, t, p = make_jobs(np.random.default_rng(seed), n, W, tmax)
    if mat is not None:
        hmax = (1 << 31 - (W - 1).bit_length()) - 1
        edge = np.arange(n) % 5 == 0
        p[edge, 2] = hmax - tk.mat_max(mat) * p[edge, 0]
    return q, t, p


def xla(q, t, p, mat, zdrop):
    """tpubwa's XLA extend_batch on the same tiles: int32 [N, 6]."""
    W, tmax = q.shape[1], t.shape[1]
    out = jx.extend_batch(*(jnp.asarray(x) for x in (q, t, *p[:, :5].T)),
                          jnp.asarray(mat), *PEN, zdrop, W, tmax)
    return np.stack([np.asarray(x) for x in out], 1)


def plain(q, t, p, mat, zdrop):
    return tk.extend_batch_plain(*(torch.from_numpy(x) for x in (q, t, p)),
                                 None, None, *PEN, zdrop, mat=mat).numpy()


def dict_jobs(q, t, p):
    return [dict(q=q[i, :p[i, 0]], t=t[i, :p[i, 1]], h0=int(p[i, 2]),
                 w=int(p[i, 3]), end_bonus=int(p[i, 4]))
            for i in range(len(q))]


@pytest.mark.parametrize("name", list(MATS))
@pytest.mark.parametrize("zdrop", [0, 100])
def test_plain_equals_xla(name, zdrop):
    mat = MATS[name]
    q, t, p = jobs(23, mat=mat)
    got = plain(q, t, p, mat, zdrop)
    assert got.tolist() == xla(q, t, p, mat, zdrop).tolist()
    # the routed function takes the plain version on the CPU
    routed = tk.extend_batch(*(torch.from_numpy(x) for x in (q, t, p)),
                             None, None, *PEN, zdrop, mat=mat).numpy()
    assert routed.tolist() == got.tolist()


@pytest.mark.parametrize("name", ["tt", "positive"])
def test_extend_module_equals_tpubwas(name):
    """extend_batch_kernel_np on dict jobs == tpubwa's XLA
    extend_batch_np, the per-side batch function K1-mat stands for."""
    mat = MATS[name]
    q, t, p = jobs(5, n=70, mat=mat)
    js = dict_jobs(q, t, p)
    want = jx.extend_batch_np(js, mat, *PEN, O.zdrop, 127, 256)
    got = tk.extend_batch_kernel_np(js, mat, *PEN, O.zdrop, 127, 256,
                                    device="cpu")
    assert all(g.dtype == np.int32 for g in got)
    assert np.array_equal(np.stack(got), np.stack(want))


def test_scmat_matrix_gives_k1():
    """At bwa_fill_scmat's matrix the table scoring is K1's arithmetic,
    on every tile shape of the main path."""
    for W, tmax in ((128, 256), (256, 512), (512, 512)):
        q, t, p = jobs(W, n=40, W=W, tmax=tmax)
        a = tk.extend_batch_plain(*(torch.from_numpy(x) for x in (q, t, p)),
                                  O.a, O.b, *PEN, O.zdrop)
        assert plain(q, t, p, MATS["scmat"], O.zdrop).tolist() == a.tolist()


@pytest.mark.parametrize("name", ["scmat", "tt"])
def test_kernel_np_equals_pallas_np(name):
    """extend_batch_kernel_np == extend_batch_pallas_np: K1 against the
    Pallas kernel (interpret mode) at scmat, K1-mat against the XLA
    extension tpubwa routes a non-scmat matrix to; 600 jobs, so that
    there are two launch chunks."""
    mat = MATS[name]
    q, t, p = jobs(77, n=600, W=128, tmax=256)
    js = dict_jobs(q, t, p)
    want = jp.extend_batch_pallas_np(js, mat, *PEN, O.zdrop, 511, 1024,
                                     interpret=True)
    launches = tk.extend_batch.launches
    got = tk.extend_batch_kernel_np(js, mat, *PEN, O.zdrop, 511, 1024,
                                    device="cpu")
    assert np.array_equal(np.stack(got), np.stack(want))
    assert tk.extend_batch.launches == launches   # the CPU launches none


def test_refusals():
    mat = MATS["tt"]
    q, t, p = jobs(1, n=4)
    js = dict_jobs(q, t, p)
    with pytest.raises(ValueError, match="lanes"):
        tk.extend_batch_kernel_np(js, mat, *PEN, O.zdrop, 512, 1024, "cpu")
    with pytest.raises(ValueError, match="lanes"):
        tk.extend_batch_kernel_np(js, mat, *PEN, O.zdrop, 600, 1024, "cpu")
    with pytest.raises(ValueError, match="exceeds qmax"):
        tk.extend_batch_kernel_np(js, mat, *PEN, O.zdrop, 20, 1024, "cpu")
    args = [torch.from_numpy(x) for x in (q, t, p)]
    with pytest.raises(ValueError, match="5 x 5"):
        tk.extend_batch(*args, None, None, *PEN, 0, mat=mat[:4])
    with pytest.raises(ValueError, match="ablations"):
        tk.extend_batch(*args, None, None, *PEN, 0, mat=mat, ablate=("pk",))
    # the packed row max: h0 + mmax * qlen past 2^24 - 1 at W 128
    p2 = p.copy()
    p2[0, :3] = (100, 10, (1 << 24) - 150)
    with pytest.raises(ValueError, match="h0"):
        tk.extend_batch(args[0], args[1], torch.from_numpy(p2), None, None,
                        *PEN, 0, mat=tk.positive_matrix())


def test_k1_mat_on_the_host_harness():
    """csrc/extend.cu's K1-mat entry under every matrix == the plain
    version, in both lane orders; at scmat == K1's entry."""
    q, t, p = jobs(41, n=13, mat=MATS["positive"])
    mats = list(MATS.values())
    for reverse in (False, True):
        got = warp_host.extend_mat_host(q, t, p, mats, *PEN, O.zdrop,
                                        reverse=reverse)
        for name, mat, out in zip(MATS, mats, got):
            want = plain(q, t, p, mat, O.zdrop)
            assert out.tolist() == want.tolist(), (name, reverse)
    k1 = warp_host.extend_host(q, t, p, O.a, O.b, *PEN, O.zdrop)[0]
    assert got[-1].tolist() == k1.tolist()

"""tpubwa's non-fused extension waves and its non-descriptor route for a
scoring matrix that is not bwa_fill_scmat-structured, in tpubwa_torch.

* ``WaveExtender.run`` (device/dispatch.py): per-side jobs from
  ``extension_plan()`` generators, 512-job blocks through
  ``extend_batch_kernel_np`` (K1 or K1-mat): regions, waves, jobs and
  scalar-loop jobs == tpubwa's ``WaveExtender(fused=False)`` on the same
  reads' chains (its Pallas kernel in interpret mode, or its XLA
  extension), and the regions == the scalar path's
  (``host/regions.py:chain2aln``).
* ``DeviceAligner`` under a transition/transversion matrix: no native
  planner, sequence-tile jobs through ``extend_seed_batch_np`` on K1-mat
  (tpubwa: host scalar loops); `mem` SAM == tpubwa's, SE and PE, with
  ``MemOpt.scoring_matrix`` patched in both packages.

At tests/test_mode_matrix.py's size (tests/test_torch_waves.py's
corpus).  Tolerance 0."""
import numpy as np
import pytest

import tpubwa.device  # noqa: F401  (x64, as the JAX package runs)
import tpubwa.opts
from tpubwa.cli import main_mem as tpubwa_main_mem
from tpubwa.device import pipeline as jpipe
from tpubwa.device.dispatch import WaveExtender as JaxWaves
from tpubwa.host import native_emit as jemit
from tpubwa.host.regions import extension_plan as jplan
from tpubwa_torch.cli import main_mem
from tpubwa_torch.device import dispatch
from tpubwa_torch.device import extend_kernel as tk
from tpubwa_torch.device import pipeline as tp
from tpubwa_torch.device.dispatch import WaveExtender
from tpubwa_torch.host import native_emit as temit
from tpubwa_torch.host.native_emit import FlatRegs
from tpubwa_torch.host.regions import chain2aln, extension_plan
from tpubwa_torch.opts import MemOpt
from test_torch_pipeline import _flat, _opts, _reads
from test_torch_waves import _mem, corpus  # noqa: F401  (the fixture)


def _chains(corpus):
    """(port reads, tpubwa reads, port chains, tpubwa chains): the SE
    reads seeded and chained by each package's own aligner and native
    chainer."""
    _, fmi, jfmi, recs, *_ = corpus
    reads, jreads = _reads(recs)
    opt, jopt = _opts()
    port = tp.make_device_aligner(opt, fmi, device="cpu")
    jax = jpipe.make_device_aligner(jopt, jfmi, platform="cpu")
    chains = temit.chain_batch_native(opt, fmi, reads,
                                      *port._seed_chunk(reads)[:2])
    jchains = jemit.chain_batch_native(jopt, jfmi, jreads,
                                       *jax._seed_chunk(jreads)[:2])
    return reads, jreads, chains, jchains


def _run(waves, plan, opt, fmi, reads, chains):
    """Per-read regions from ``waves.run`` over ``plan`` generators."""
    regs = [[] for _ in reads]
    waves.run(tp._serialize_per_read([
        [plan(opt, fmi.bnt, r.l_seq, r.seq, c, regs[i]) for c in chains[i]]
        for i, r in enumerate(reads)]))
    return regs


@pytest.mark.parametrize("jax_route,matrix", [
    ("pallas", "scmat"), ("pallas", "tt"), ("xla", "scmat")])
@pytest.mark.parametrize("qmax", [511, 40], ids=["kernel", "oversize"])
def test_plain_waves_equal_jax_and_scalar(corpus, jax_route, matrix,
                                          qmax):
    """The port's plain waves (K1 at scmat, K1-mat under tt) == tpubwa's
    WaveExtender(fused=False) through its Pallas route (which sends tt to
    its XLA extension) or its XLA extension at scmat, and == chain2aln;
    n_waves, n_jobs and n_fallback == tpubwa's.  At qmax 40 the sides
    past 40 bases take the scalar loops."""
    _, fmi, jfmi, *_ = corpus
    reads, jreads, chains, jchains = _chains(corpus)
    opt, jopt = _opts()
    mat = tk.tt_matrix() if matrix == "tt" else opt.scoring_matrix()
    waves = WaveExtender(opt, mat, "cpu", qmax=qmax)
    jwaves = JaxWaves(jopt, mat, qmax=qmax,
                      use_pallas=jax_route == "pallas")
    got = _run(waves, extension_plan, opt, fmi, reads, chains)
    want = _run(jwaves, jplan, jopt, jfmi, jreads, jchains)
    assert _flat(FlatRegs.from_lists(got)) == \
        _flat(FlatRegs.from_lists(want))
    assert (waves.n_waves, waves.n_jobs, waves.n_fallback) == \
        (jwaves.n_waves, jwaves.n_jobs, jwaves.n_fallback)
    assert waves.n_waves > 0 and (waves.n_fallback > 0) == (qmax == 40)
    scalar = [[] for _ in reads]
    for i, r in enumerate(reads):
        for c in chains[i]:
            chain2aln(opt, fmi.bnt, r.l_seq, r.seq, c, scalar[i], mat)
    assert _flat(FlatRegs.from_lists(got)) == \
        _flat(FlatRegs.from_lists(scalar))


def test_plain_waves_run_in_blocks(corpus, monkeypatch):
    """A wave runs in launch groups of at most BLOCK jobs, in job order:
    at a BLOCK of 7 the regions equal those at 512."""
    _, fmi, *_ = corpus
    reads, _, chains, _ = _chains(corpus)
    opt = MemOpt()
    ref = WaveExtender(opt, opt.scoring_matrix(), "cpu")
    want = _run(ref, extension_plan, opt, fmi, reads, chains)
    sizes = []
    real = dispatch.extend_batch_kernel_np

    def batch(jobs, *a, **k):
        sizes.append(len(jobs))
        return real(jobs, *a, **k)

    monkeypatch.setattr(dispatch, "extend_batch_kernel_np", batch)
    monkeypatch.setattr(dispatch, "BLOCK", 7)
    waves = WaveExtender(opt, opt.scoring_matrix(), "cpu")
    got = _run(waves, extension_plan, opt, fmi, reads, chains)
    assert _flat(FlatRegs.from_lists(got)) == \
        _flat(FlatRegs.from_lists(want))
    assert (waves.n_waves, waves.n_jobs) == (ref.n_waves, ref.n_jobs)
    assert max(sizes) == 7 and sum(sizes) == waves.n_jobs
    assert len(sizes) > waves.n_waves


@pytest.mark.parametrize("kind", ["se", "pe"])
def test_non_scmat_mem_equals_tpubwa(corpus, monkeypatch, kind):
    """`mem --device cpu` under the transition/transversion matrix ==
    tpubwa's (its host scalar loops), SE and PE; the port's aligner
    takes the non-descriptor route (no native planner) and extends every
    job through K1-mat's plain version."""
    prefix, *_, fq_se, fq1, fq2 = corpus
    mat = tk.tt_matrix()
    for cls in (MemOpt, tpubwa.opts.MemOpt):
        monkeypatch.setattr(cls, "scoring_matrix", lambda self: mat.copy())
    seen = {"mat": 0, "desc": 0}
    real_plain, real_desc = tk.extend_batch_plain, tp.extend_seed_desc_np

    def plain(*a, mat=None, **k):
        seen["mat"] += mat is not None
        return real_plain(*a, mat=mat, **k)

    def desc(*a, **k):
        seen["desc"] += 1
        return real_desc(*a, **k)

    monkeypatch.setattr(tk, "extend_batch_plain", plain)
    monkeypatch.setattr(tp, "extend_seed_desc_np", desc)
    fqs = [fq_se] if kind == "se" else [fq1, fq2]
    want = _mem(tpubwa_main_mem, prefix, fqs)
    got = _mem(main_mem, prefix, fqs)
    assert len(got) > (70 if kind == "se" else 100)
    assert got == want
    assert seen["mat"] > 0 and seen["desc"] == 0

"""The whole pipeline on several devices, held to one device: the
counterpart of tpubwa's dryrun (``__graft_entry__.dryrun_multichip``),
its data-parallel leg and its tensor-parallel one.

``DeviceAligner`` over a ``DataParallel`` (the FM-index replicated,
seeding, the SA walk and the extension waves split over the replicas)
runs a realistic multi-contig genome's PE reads through pairing and SAM
emission, and its SAM must equal the single-device run's record for
record.  Then the tp leg: an aligner over ``TpIndex(fmi, devices)`` (the
seeding index in row slabs across the devices, megaq's K2 and fused SA
walk reading each row from the slab that holds it) on the first
TPUBWA_DRYRUN_TP_PAIRS pairs (default 128, tpubwa's), SAM-equal to the
single-device run, each slab 1/n of the padded rows.
"""

from __future__ import annotations

import os

import numpy as np


def dryrun_multidevice(devices, mb: float = 1.5, n_pairs: int = 1024,
                       seed: int = 13) -> dict:
    """Build ``make_bench_bnt(mb Mbp, realistic=True)`` and ``n_pairs``
    100 bp pairs from ``seed``; align them through an aligner on
    ``devices[0]`` alone and through one over ``DataParallel(devices)``
    (seed mode megaq unless TPUBWA_SEED_MODE says otherwise), and raise
    unless the two SAMs are equal; then the tp leg (the module's
    docstring), skipped where TPUBWA_DRYRUN_TP_PAIRS is 0.  Prints one
    line a leg and returns their facts (the tp leg's under ``tp``)."""
    from .sharding import DataParallel

    dp = DataParallel.over(devices)
    try:
        return _dryrun(dp, mb, n_pairs, seed)
    finally:
        dp.close()


def _dryrun(dp, mb, n_pairs, seed):
    from ..device.pipeline import make_device_aligner
    from ..host.pipeline import process_seqs
    from ..index.fmindex import FMIndex
    from ..opts import MEM_F_PE, MemOpt
    from ..sim import make_bench_bnt, simulate_pe
    n_bp = int(mb * 1_000_000)
    rng = np.random.default_rng(seed)
    bnt = make_bench_bnt(n_bp, rng, realistic=True, contig_bp=n_bp // 3)
    fmi = FMIndex.build(bnt)
    reads = simulate_pe(bnt, n_pairs, 100, rng)
    opt = MemOpt(flag=MEM_F_PE)
    single = make_device_aligner(opt, fmi, device=dp.devices[0])
    multi = make_device_aligner(opt, fmi, dp=dp)
    sam_s = process_seqs(opt, fmi, reads, 0, align_fn=single)
    sam_m = process_seqs(opt, fmi, reads, 0, align_fn=multi)
    if len(sam_m) < len(reads):
        raise AssertionError(f"{len(sam_m)} SAM records for {len(reads)} "
                             "reads")
    if sam_m != sam_s:
        raise AssertionError(
            "data-parallel SAM != single-device SAM: "
            + repr([d for d in zip(sam_s, sam_m) if d[0] != d[1]][:2]))
    facts = {"records": len(sam_m), "reads": len(reads),
             "mapped": sum(1 for l in sam_m
                           if not int(l.split("\t")[1]) & 0x4),
             "with_xa": sum(1 for l in sam_m if "\tXA:Z:" in l),
             "devices": [str(d) for d in dp.devices],
             "genome_bp": n_bp, "seed_mode": multi.seed_mode,
             "single_seed_mode": single.seed_mode, "tally": dp.tally}
    print(f"[dryrun_multidevice] {dp.n} replicas on "
          f"{','.join(facts['devices'])}: SAM-equal to one device "
          f"({facts['records']} records from {facts['reads']} reads, "
          f"{facts['mapped']} mapped, {facts['with_xa']} with XA, "
          f"{n_bp} bp realistic multi-contig genome incl. ALT; seeding "
          f"{multi.seed_mode} over the replicas, {single.seed_mode} on "
          "one)", flush=True)
    n_tp = int(os.environ.get("TPUBWA_DRYRUN_TP_PAIRS", "128"))
    if n_tp > 0:
        facts["tp"] = _tp_leg(opt, fmi, reads[:2 * n_tp], single, dp.devices)
    return facts


def _tp_leg(opt, fmi, reads, single, devices):
    """The tp leg: ``reads`` through an aligner over ``TpIndex(fmi,
    devices)`` SAM-equal to ``single``'s, each slab 1/n of the padded
    rows."""
    from ..device.pipeline import make_device_aligner
    from ..host.pipeline import process_seqs
    from .index_tp import TpIndex
    tp = TpIndex(fmi, devices)
    aligner = make_device_aligner(opt, fmi, device=devices[0], tp=tp)
    sam_t = process_seqs(opt, fmi, reads, 0, align_fn=aligner)
    sam_s = process_seqs(opt, fmi, reads, 0, align_fn=single)
    if sam_t != sam_s:
        raise AssertionError(
            "index-sharded SAM != single-device SAM: "
            + repr([d for d in zip(sam_s, sam_t) if d[0] != d[1]][:2]))
    for name, per in tp.slab_rows.items():
        if per * tp.n != tp.rows_total[name]:
            raise AssertionError(f"{name}: {tp.n} slabs of {per} rows for "
                                 f"{tp.rows_total[name]}")
    facts = {"records": len(sam_t), "reads": len(reads), "slabs": tp.n,
             "devices": [str(d) for d in tp.devices],
             "slab_rows": tp.slab_rows, "rows_total": tp.rows_total,
             "seed_mode": aligner.seed_mode}
    print(f"[dryrun_multidevice] TP: index-sharded seeding (occ slab "
          f"1/{tp.n} a device, {tp.slab_rows['occ_blocks']} of "
          f"{tp.rows_total['occ_blocks']} rows) SAM-equal on "
          f"{len(reads)} reads over {','.join(facts['devices'])}",
          flush=True)
    return facts


"""The whole pipeline on several devices, held to one device: the
counterpart of the data-parallel leg of tpubwa's dryrun
(``__graft_entry__.dryrun_multichip``).

``DeviceAligner`` over a ``DataParallel`` (the FM-index replicated,
seeding, the SA walk and the extension waves split over the replicas)
runs a realistic multi-contig genome's PE reads through pairing and SAM
emission, and its SAM must equal the single-device run's record for
record.  tpubwa's tensor-parallel leg (the seeding index sharded over a
'tp' axis) waits for ROADMAP [index-tp].
"""

from __future__ import annotations

import numpy as np


def dryrun_multidevice(devices, mb: float = 1.5, n_pairs: int = 1024,
                       seed: int = 13) -> dict:
    """Build ``make_bench_bnt(mb Mbp, realistic=True)`` and ``n_pairs``
    100 bp pairs from ``seed``; align them through an aligner on
    ``devices[0]`` alone and through one over ``DataParallel(devices)``
    (seed mode megaq unless TPUBWA_SEED_MODE says otherwise), and raise
    unless the two SAMs are equal.  Prints one line and returns its
    facts."""
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
    return facts


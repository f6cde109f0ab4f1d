"""The alignment device step on its own, and the whole pipeline on
several devices: the counterpart of tpubwa's entry points
(``__graft_entry__.py``: ``entry`` and ``dryrun_multichip``).

``entry()`` gives one fused device step over a tiny index: the
rightmost forward reach of every position of every read
(``device.smem.rightmost_reach``, K-reach on the card), the SA walk of
the resulting intervals' anchors (``occ.sa_lookup``, K-sa), and one
extension wave of each read from its first anchor against the reference
window there (``extend_kernel.extend_batch`` under the step's own
scoring matrix, match +1 and everything else -4, N against N too: K1-mat).
On a CUDA device each of the three launches its kernel; on the CPU, and
only where the caller asks for it, the plain versions run.

    python -m tpubwa_torch.entry               # the step on the card, then
                                               # the dryrun over every card
    python -m tpubwa_torch.entry --device cpu  # the same on the CPU
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

# the step's scoring matrix (__graft_entry__.py:72-74): not bwa_fill_scmat
ENTRY_MAT = np.array([[1 if i == j else -4 for j in range(5)]
                      for i in range(5)], np.int32)


def _tiny_setup(seed=7, genome_len=4096, n_reads=64, read_len=64):
    """(FMIndex, reads uint8 [n_reads, read_len], lens int32): a random
    genome of ``genome_len`` bases and reads cut from its doubled text,
    every third with a SNP (tpubwa's ``_tiny_setup``, from the port's
    index modules)."""
    from .index import FMIndex
    from .index.build import BntSeq, SeqAnn
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, genome_len).astype(np.uint8)
    bnt = BntSeq(l_pac=genome_len,
                 anns=[SeqAnn(name="t", anno="", offset=0,
                              length=genome_len, n_ambs=0)],
                 ambs=[], seed=11, codes=codes)
    fmi = FMIndex.build(bnt)
    text = bnt.doubled()
    reads = np.zeros((n_reads, read_len), np.uint8)
    for i in range(n_reads):
        s = int(rng.integers(0, genome_len - read_len))
        reads[i] = text[s:s + read_len]
        if i % 3 == 0:
            reads[i, int(rng.integers(0, read_len))] = \
                int(rng.integers(0, 4))
    lens = np.full(n_reads, read_len, np.int32)
    return fmi, reads, lens


def step(didx, q, lens, read_idx, starts, min_intv):
    """One device step (tpubwa's jitted ``step``): (e idt [B * L], the
    reach of each job; pos idt [B * L], the SA position of each job's
    interval's first rank, clipped into [1, seq_len]; score int32 [B],
    each read's extension from its first anchor)."""
    from .device.extend_kernel import extend_batch
    from .device.occ import get_ref_batch, sa_lookup
    from .device.smem import rightmost_reach
    B, L = q.shape
    ik, e = rightmost_reach(didx, q, lens, read_idx, starts, min_intv)
    ik = ik.reshape(-1, 3)
    pos = sa_lookup(didx, torch.clamp(ik[:, 0], 1, didx.seq_len))
    rstart = torch.clamp(pos[::L][:B], 0, didx.l_pac - 1).to(torch.int64)
    t = get_ref_batch(didx, rstart, 128).to(torch.int32).contiguous()
    # the query's first 64 columns in K1-mat's 128 lanes, N-padded;
    # params (qlen, tlen 128, h0 19, w 100, end_bonus 5)
    qt = torch.full((B, 128), 4, dtype=torch.int32, device=q.device)
    qt[:, :64] = q[:, :64]
    params = torch.stack([lens[:B].to(torch.int32), *(
        torch.full((B,), v, dtype=torch.int32, device=q.device)
        for v in (128, 19, 100, 5))], dim=1)
    res = extend_batch(qt, t, params, None, None, 6, 1, 6, 1, 100,
                       mat=ENTRY_MAT)
    return e, pos, res[:, 0]


def entry(device="cuda"):
    """(step, args): ``step`` and its arguments on ``device`` (the
    index, the reads int32 [64, 64], their lengths, and one job a (read,
    start) with min_intv 1).  'cuda' raises without a card: nothing
    falls back to the CPU."""
    from .device.occ import DeviceIndex
    from .device.pipeline import resolve_device
    from .device.smem import reach_jobs
    dev = resolve_device(device)
    fmi, reads, lens = _tiny_setup()
    didx = DeviceIndex.from_fmindex(fmi, dev)
    read_idx, starts, min_intv = reach_jobs(*reads.shape, didx.idt, dev)
    args = (didx, torch.from_numpy(reads.astype(np.int32)).to(dev),
            torch.from_numpy(lens).to(dev), read_idx, starts, min_intv)
    return step, args


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m tpubwa_torch.entry",
        description="Run the alignment device step, then the multi-device "
                    "dryrun (dist/dryrun.py) over every card, or three "
                    "CPU replicas with --device cpu.")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--mb", type=float, default=1.5,
                    help="the dryrun's genome in Mbp (default 1.5)")
    ap.add_argument("--pairs", type=int, default=1024,
                    help="the dryrun's read pairs (default 1024)")
    args = ap.parse_args(argv)
    fn, fargs = entry(args.device)
    out = fn(*fargs)
    print("entry ok:", [tuple(o.shape) for o in out], flush=True)
    from .dist.dryrun import dryrun_multidevice
    if args.device == "cpu":
        devices = ["cpu"] * 3
    else:
        n = torch.cuda.device_count()
        # one card: two replicas on it, so that the split is exercised
        devices = [f"cuda:{i}" for i in range(n)] if n > 1 else ["cuda:0"] * 2
    dryrun_multidevice(devices, mb=args.mb, n_pairs=args.pairs)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

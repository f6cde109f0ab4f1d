"""Batched SMEM seeding for a read chunk, the counterpart of
tpubwa/device/smem.py:collect_intv_device.

This slice has mode ``host`` only: the native C++ seeder
(tpubwa/host/native_smem.py) runs the full 3-round mem_collect_intv
protocol on the host, and the chunk's reads go up to the device once
for the descriptor extension.  The GPU seeding machine (modes
``megaq``/``hybrid``) is ROADMAP Queue 1 item 5.
"""

from __future__ import annotations

import numpy as np
import torch

from tpubwa.host.native_smem import smem_collect_batch_native

_GPU_SEEDING = ("seed mode {!r} needs the GPU seeding machine "
                "(ROADMAP Queue 1 item 5); tpubwa_torch seeds in mode "
                "'host' only")


def _package_rows(flat, frid, reads, device):
    """The host path's return: flat rows, their read ids, and the
    chunk's reads as a uint8 tensor on ``device`` (resident for the
    descriptor extension)."""
    qd = torch.from_numpy(np.ascontiguousarray(reads, dtype=np.uint8))
    return flat, frid, qd.to(device)


def collect_intv_device(opt, didx, reads: np.ndarray, lens: np.ndarray,
                        fmi, mode: str = "host"):
    """Full 3-round mem_collect_intv for a packed chunk (uint8 reads
    [B, L], int32 lens [B]).  Returns (flat int64 [n, 5] rows (x0, x1,
    size, qb, qe), frid int64 [n] read ids, qd uint8 [B, L] on the
    index's device); rows are in (read, qb, qe) order, the
    ref.smem.collect_intv contract per read.  SA positions are left to
    the caller."""
    if mode != "host":
        raise NotImplementedError(_GPU_SEEDING.format(mode))
    rows6 = smem_collect_batch_native(opt, fmi, reads, lens)
    if rows6 is None:
        raise NotImplementedError(
            "the native seeder (tpubwa/native/smem.cpp) is unavailable; "
            "seeding without it needs the GPU seeding machine (ROADMAP "
            "Queue 1 item 5)")
    return _package_rows(rows6[:, :5], rows6[:, 5], reads, didx.device)

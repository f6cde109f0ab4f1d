"""Native scalar-SMEM bridge (native/smem.cpp).

The production host fallback for megaq overflow tails and oversize
reads: ~30x the Python scalar path, bit-identical by construction
(same protocol, fuzzed against ref/smem.py in tests/test_smem_native).
`ref/smem.py` remains the independent pure-Python oracle.
"""

from __future__ import annotations

import ctypes
import os
import numpy as np

_LIB = None


def _lib():
    global _LIB
    if _LIB is not None:
        return _LIB or None
    if os.environ.get("TPUBWA_NO_NATIVE") \
            or os.environ.get("TPUBWA_NO_NATIVE_SMEM"):
        _LIB = False
        return None
    try:
        from ..native import load_smem
        _LIB = load_smem()
    except Exception:  # pragma: no cover - toolchain missing
        _LIB = False
    return _LIB or None


class _Handle:
    """Owns the C-side FmIdx and keeps the numpy arrays alive."""

    def __init__(self, lib, fmi):
        self.lib = lib
        self.words = np.ascontiguousarray(fmi.bwt_words, np.uint32)
        self.ckpt = np.ascontiguousarray(fmi.occ_ckpt, np.uint32)
        self.L2 = np.ascontiguousarray(fmi.L2, np.int64)
        self.h = ctypes.c_void_p(lib.tpubwa_smem_init(
            self.words.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
            self.ckpt.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
            self.L2.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            ctypes.c_int64(int(fmi.seq_len)),
            ctypes.c_int64(int(fmi.primary))))

    def __del__(self):  # pragma: no cover - interpreter teardown
        try:
            if self.h:
                self.lib.tpubwa_smem_free(self.h)
        except Exception:
            pass


def _handle(fmi):
    # cached on the FMIndex itself (dataclass, unhashable); the
    # _Handle keeps the numpy arrays alive and frees the C side when
    # the index is collected
    lib = _lib()
    if lib is None:
        return None
    h = getattr(fmi, "_native_smem", None)
    if h is None:
        h = _Handle(lib, fmi)
        try:
            object.__setattr__(fmi, "_native_smem", h)
        except Exception:  # pragma: no cover - slots/frozen classes
            pass
    return h


def smem_jobs_native(opt, fmi, reads, lens_np, split_len, jobs):
    """The _scalar_full batch natively: jobs = [(ri, x, mi, osh), ...].
    Returns int64 [n, 6] rows (x0, x1, size, qb, qe, rid) in the exact
    Python emission order, or None if the native path is unavailable."""
    h = _handle(fmi)
    if h is None or not h.h:
        return None
    reads = np.ascontiguousarray(reads, np.uint8)
    lens = np.ascontiguousarray(lens_np, np.int32)
    jarr = np.ascontiguousarray(
        [(int(a), int(b), int(c), 1 if d else 0)
         for a, b, c, d in jobs], np.int64).reshape(-1, 4)
    i64p = ctypes.POINTER(ctypes.c_int64)
    cap = 64 * len(jarr) + 64
    for _ in range(2):
        out = np.zeros((cap, 6), np.int64)
        n = h.lib.tpubwa_smem_jobs(
            h.h, reads.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            ctypes.c_int64(reads.shape[1]),
            lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            jarr.ctypes.data_as(i64p), ctypes.c_int64(len(jarr)),
            ctypes.c_int64(int(opt.min_seed_len)),
            ctypes.c_int64(int(split_len)),
            ctypes.c_int64(int(opt.split_width)),
            out.ctypes.data_as(i64p), ctypes.c_int64(cap))
        if n >= 0:
            return out[:n]
        cap = -n
    return None  # pragma: no cover - exact retry cannot fail


def collect_intv_native(opt, fmi, q):
    """Full 3-round mem_collect_intv for one read; int64 [n, 5] rows
    sorted by (qb, qe), or None if unavailable."""
    h = _handle(fmi)
    if h is None or not h.h:
        return None
    q = np.ascontiguousarray(q, np.uint8)
    split_len = int(opt.min_seed_len * opt.split_factor + 0.499)
    i64p = ctypes.POINTER(ctypes.c_int64)
    cap = 4 * len(q) + 64
    for _ in range(2):
        out = np.zeros((cap, 5), np.int64)
        n = h.lib.tpubwa_smem_collect(
            h.h, q.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            ctypes.c_int64(len(q)),
            ctypes.c_int64(int(opt.min_seed_len)),
            ctypes.c_int64(split_len),
            ctypes.c_int64(int(opt.split_width)),
            ctypes.c_int64(int(opt.max_mem_intv)),
            out.ctypes.data_as(i64p), ctypes.c_int64(cap))
        if n >= 0:
            return out[:n]
        cap = -n
    return None  # pragma: no cover - exact retry cannot fail


def smem_collect_batch_native(opt, fmi, reads, lens_np,
                              threads=None):
    """Full 3-round collect for a packed read chunk: int64 [n, 6]
    rows (x0, x1, size, qb, qe, rid), per-read (qb, qe)-sorted and
    concatenated in read order — the host seeding mode's one call.
    None if the native path is unavailable."""
    h = _handle(fmi)
    if h is None or not h.h:
        return None
    reads = np.ascontiguousarray(reads, np.uint8)
    lens = np.ascontiguousarray(lens_np, np.int32)
    split_len = int(opt.min_seed_len * opt.split_factor + 0.499)
    i64p = ctypes.POINTER(ctypes.c_int64)
    cap = 8 * len(lens) + 64
    for _ in range(2):
        out = np.zeros((cap, 6), np.int64)
        n = h.lib.tpubwa_smem_collect_batch(
            h.h, reads.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            ctypes.c_int64(reads.shape[1]),
            lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            ctypes.c_int64(len(lens)),
            ctypes.c_int64(int(opt.min_seed_len)),
            ctypes.c_int64(split_len),
            ctypes.c_int64(int(opt.split_width)),
            ctypes.c_int64(int(opt.max_mem_intv)),
            ctypes.c_int64(int(threads if threads is not None
                               else getattr(opt, "n_threads", 1)
                               or 1)),
            out.ctypes.data_as(i64p), ctypes.c_int64(cap))
        if n >= 0:
            return out[:n]
        cap = -n
    return None  # pragma: no cover - exact retry cannot fail


def sa_positions_native(fmi, flat, max_occ, threads=1):
    """Host SA stage: bwa's per-interval subsampling + text-position-
    marked bounded walks for the chunk's flat rows.  Returns
    (pos int64 [total], cnt int64 [n_rows]) — the _sa_positions
    contract — or None (no native lib / index without marks)."""
    if getattr(fmi, "sa_mark_D", 0) in (0, None) \
            or getattr(fmi, "sa_mark_rows", None) is None:
        return None
    h = _handle(fmi)
    if h is None or not h.h:
        return None
    if not getattr(h, "sa_ready", False):
        h.mark_rows = np.ascontiguousarray(fmi.sa_mark_rows, np.uint32)
        h.marked = np.ascontiguousarray(fmi.sa_marked, np.int64)
        h.lib.tpubwa_sa_init(
            h.h,
            h.mark_rows.ctypes.data_as(
                ctypes.POINTER(ctypes.c_uint32)),
            h.marked.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            ctypes.c_int64(int(fmi.sa_mark_D)))
        h.sa_ready = True
    flat = np.ascontiguousarray(flat, np.int64)
    x0 = np.ascontiguousarray(flat[:, 0])
    size = np.ascontiguousarray(flat[:, 2])
    n_rows = len(flat)
    cnt = np.zeros(n_rows, np.int64)
    i64p = ctypes.POINTER(ctypes.c_int64)
    cap = int(np.minimum(size, max_occ).sum())
    out = np.zeros(max(cap, 1), np.int64)
    n = h.lib.tpubwa_sa_positions(
        h.h, x0.ctypes.data_as(i64p), size.ctypes.data_as(i64p),
        ctypes.c_int64(n_rows), ctypes.c_int64(int(max_occ)),
        ctypes.c_int64(int(threads or 1)),
        out.ctypes.data_as(i64p), ctypes.c_int64(len(out)),
        cnt.ctypes.data_as(i64p))
    if n < 0:
        return None  # pragma: no cover - cap covers the protocol max
    return out[:n], cnt

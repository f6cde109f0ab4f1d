"""csrc/extend.cu's, csrc/extend16.cu's, csrc/extend_bd.cu's,
csrc/occ.cu's and csrc/smem.cu's kernels on the host, for tests.

The kernel sources compile as plain C++ against ``csrc/warp_host.h``,
which runs a warp's 32 lanes in lockstep, computes its shuffles,
reductions and ballots by a loop over the lanes' operands, and has host
versions of the 16x2 intrinsics and of the atomics.  ``build`` compiles
one harness (``csrc/extend_host.cpp``, ``csrc/extend16_host.cpp``,
``csrc/extend_bd_host.cpp``, ``csrc/occ_host.cpp`` or
``csrc/smem_host.cpp``) with g++ under ``-fsanitize=address,undefined``
into ``build/host`` in the checkout (or ``$TPUBWA_TORCH_HOST_BUILD``),
keyed by a hash of its sources; ``extend_host`` (K1 and K1-floor),
``extend_real_host`` (K1-real), ``extend16_host`` (K1-i16),
``extend_bd_host`` (K1-bd, both passes), ``occ_host`` (K-sa and K-ext)
and ``smem_host`` (K2 and K3) run one on a set of jobs, and
``intrinsics16_host`` runs the host intrinsics alone.  This checks the
kernel's logic, its memory accesses and that its warp operations are
reached by all 32 lanes together, where there is no card; what the GPU's
compiler makes of the source still shows only on a card.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import numpy as np

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD = Path(os.environ.get(
    "TPUBWA_TORCH_HOST_BUILD",
    Path(__file__).resolve().parents[2] / "build" / "host"))
# each harness: its entry and the sources it compiles
SOURCES = {"extend_host": ("extend_host.cpp", "extend.cu", "warp_host.h"),
           "extend16_host": ("extend16_host.cpp", "extend16.cu",
                             "warp_host.h"),
           "extend_bd_host": ("extend_bd_host.cpp", "extend_bd.cu",
                              "warp_host.h"),
           "occ_host": ("occ_host.cpp", "occ.cu", "fm.cuh", "warp_host.h"),
           "smem_host": ("smem_host.cpp", "smem.cu", "smem.cuh", "fm.cuh",
                         "warp_host.h")}
FLAGS = ["-std=c++17", "-O1", "-g", "-fsanitize=address,undefined",
         "-fno-sanitize-recover=undefined"]
# without the sanitizers, for a count over a large input (smem_host's
# count_rows on the card's machine); lanes then switch by _longjmp,
# which a fortified build refuses across stacks
FAST_FLAGS = ["-std=c++17", "-O2", "-U_FORTIFY_SOURCE"]
# the intrinsics of extend16_host --ops, in its order
INTRINSICS16 = ("__vadd2", "__vmaxs2", "__vimin_s16x2_relu",
                "__viaddmin_s16x2", "__viaddmax_s16x2",
                "__viaddmax_s16x2_relu", "__byte_perm")


def build(name: str = "extend_host", sanitize: bool = True) -> Path:
    """The harness executable ``name`` (a key of ``SOURCES``), built on
    first use, with ``FLAGS`` (or ``FAST_FLAGS`` where not
    ``sanitize``).  Raises RuntimeError without g++ or when the build
    fails."""
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found: the host harness needs it")
    flags = FLAGS if sanitize else FAST_FLAGS
    key = b"".join((CSRC / s).read_bytes() for s in SOURCES[name])
    key += " ".join(flags).encode()
    exe = BUILD / f"{name}-{hashlib.sha256(key).hexdigest()[:16]}"
    if not exe.exists():
        BUILD.mkdir(parents=True, exist_ok=True)
        tmp = exe.with_suffix(f".{os.getpid()}.tmp")
        entry = SOURCES[name][0]
        res = subprocess.run([gxx, *flags, "-o", str(tmp), str(CSRC / entry)],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"g++ failed on {entry}:\n{res.stderr}")
        os.replace(tmp, exe)
    return exe


def _exec(name, arrays, args=(), dtype=np.int32, sanitize=True):
    """Run harness ``name`` on the concatenated bytes of ``arrays``;
    returns what it wrote, as ``dtype``.  Raises RuntimeError with its
    report if it fails."""
    exe = build(name, sanitize)
    with tempfile.TemporaryDirectory() as d:
        inp, out = os.path.join(d, "in"), os.path.join(d, "out")
        with open(inp, "wb") as fh:
            for x in arrays:
                fh.write(x.tobytes())
        res = subprocess.run([str(exe), *args, inp, out], capture_output=True,
                             text=True)
        if res.returncode != 0:
            raise RuntimeError(f"{name} failed (rc {res.returncode}):\n"
                               f"{res.stderr[-4000:]}")
        return np.fromfile(out, dtype)


def _jobs(q, t, params):
    return tuple(np.ascontiguousarray(x, np.int32) for x in (q, t, params))


def _run(q, t, params, pen, masks, variants, reverse):
    """The harness on one set of jobs: (one int32 [N, 6] per mask, one
    int32 [N, 128] per K1-real variant index)."""
    q, t, params = _jobs(q, t, params)
    n, W = q.shape
    head = np.asarray([n, W, t.shape[1], params.shape[1], *pen, int(reverse),
                       len(masks), len(variants), *masks, *variants],
                      np.int32)
    got = _exec("extend_host", (head, q, t, params))
    k = len(masks) * n * 6
    return (list(got[:k].reshape(len(masks), n, 6)),
            list(got[k:].reshape(len(variants), n, 128)))


def extend_host(q, t, params, a, b, o_del, e_del, o_ins, e_ins, zdrop,
                masks=(0,), reverse=False):
    """``extend_batch``'s contract on numpy int32 arrays, through the
    kernel's own C entries on the host: one int32 [N, 6] per ablation
    mask of ``masks`` (0: K1's entry; -1: mask 0 through the floor
    entry).  ``reverse`` runs each warp's lanes 31..0.  Raises
    RuntimeError with the harness's report if a sanitizer or the
    lockstep check stops it."""
    return _run(q, t, params, (a, b, o_del, e_del, o_ins, e_ins, zdrop),
                masks, (), reverse)[0]


def extend_real_host(q, t, params, variants, scoring, reverse=False):
    """K1-real's C entry (``tpubwa_extend_real``) on the host: one int32
    [N, 128] per index of ``exp_kernel_real.VARIANTS`` in ``variants``,
    each launched with ``scoring`` (a, b, o_del, e_del, o_ins, e_ins,
    zdrop), lanes 0-5 from the kernel and lanes 6-127 as it left them
    (the harness fills them with -77 first).  Raises as ``extend_host``."""
    return _run(q, t, params, scoring, (), variants, reverse)[1]


def extend16_host(q, t, params, a, b, o_del, e_del, o_ins, e_ins, zdrop,
                  reverse=False):
    """``extend_batch16``'s contract on numpy int32 arrays, through the
    kernel's C entry (``tpubwa_extend_batch16``) on the host: int32
    [N, 6].  ``reverse`` runs each warp's lanes 31..0.  Raises
    RuntimeError with the harness's report if a sanitizer or the
    lockstep check stops it, or if the entry refuses the launch."""
    q, t, params = _jobs(q, t, params)
    n, W = q.shape
    head = np.asarray([n, W, t.shape[1], params.shape[1], a, b, o_del, e_del,
                       o_ins, e_ins, zdrop, int(reverse)], np.int32)
    return _exec("extend16_host", (head, q, t, params)).reshape(n, 6)


def extend_bd_host(q, t, params, variants, reverse=False):
    """K1-bd's C entry (``tpubwa_extend_bd``) on the host, both passes:
    one int32 [N, 128] per index of ``exp_kernel_breakdown.VARIANTS`` in
    ``variants``, lanes 0-3 from the kernel and lanes 4-127 as it left
    them (the harness fills them with -77 first).  ``reverse`` runs each
    warp's lanes 31..0.  Raises RuntimeError with the harness's report
    if a sanitizer or the lockstep check stops it, or if the entry
    refuses the launch."""
    q, t, params = _jobs(q, t, params)
    n, NL = q.shape
    head = np.asarray([n, NL, t.shape[1], params.shape[1], int(reverse),
                       len(variants), *variants], np.int32)
    got = _exec("extend_bd_host", (head, q, t, params))
    return list(got.reshape(len(variants), n, 128))


def intrinsics16_host(a, b, c):
    """{name: uint32 [n]}: each host intrinsic of ``INTRINSICS16`` on the
    uint32 words ``a``, ``b``, ``c`` (a two-operand one takes a and b;
    ``__byte_perm`` takes c as its selector)."""
    a, b, c = (np.ascontiguousarray(x, np.uint32) for x in (a, b, c))
    got = _exec("extend16_host", (np.asarray([len(a)], np.int32), a, b, c),
                ("--ops",)).view(np.uint32)
    return dict(zip(INTRINSICS16, got.reshape(len(INTRINSICS16), len(a))))


def occ_host(arrays, ranks, ik):
    """csrc/occ.cu's C entries on the host, on a tpubwa-layout index:
    ``arrays`` maps ``occ_blocks``, ``mark_rows`` (uint32), ``L2``,
    ``sa_marked``, ``sa_sample`` (the rank type, int32 or int64, taken
    from ``sa_sample``) and ``primary``, ``seq_len``, ``mark_D``.
    Returns (positions [n] of ``ranks`` through ``tpubwa_sa_lookup``,
    the backward and the forward extensions [m, 4, 3] of ``ik`` [m, 3]
    through ``tpubwa_bwt_extend``), of the rank type.  Raises
    RuntimeError with the harness's report if a sanitizer stops it or
    an entry returns an error."""
    dt = np.asarray(arrays["sa_sample"]).dtype
    if dt not in (np.int32, np.int64):
        raise TypeError(f"rank type {dt}")
    occ, marks = (np.ascontiguousarray(arrays[k], np.uint32)
                  for k in ("occ_blocks", "mark_rows"))
    ranks = np.ascontiguousarray(ranks, dt)
    ik = np.ascontiguousarray(ik, dt).reshape(-1, 3)
    head = np.asarray([len(occ), len(marks), len(arrays["sa_marked"]),
                       len(arrays["sa_sample"]), arrays["primary"],
                       arrays["seq_len"], arrays["mark_D"], dt == np.int64,
                       len(ranks), len(ik)], np.int64)
    got = _exec("occ_host", (head, occ, marks, *(
        np.ascontiguousarray(arrays[k], dt)
        for k in ("L2", "sa_marked", "sa_sample")), ranks, ik), dtype=dt)
    n, m = len(ranks), len(ik) * 12
    return (got[:n], got[n:n + m].reshape(-1, 4, 3),
            got[n + m:].reshape(-1, 4, 3))


def smem_host(arrays, reads, lens, kernel, params, rids=None, slots=0,
              count_rows=False, sanitize=True, reverse=False):
    """One launch of csrc/smem.cu's K2 (``kernel`` 0,
    ``tpubwa_smem_rounds12``, on the reads ``rids`` with ``slots`` row
    slots each, a warp a read) or K3 (1, ``tpubwa_seed_strategy``, on
    every read) on the host.  ``arrays`` maps ``occ_blocks`` (uint32),
    ``L2`` (the rank type, int32 or int64) and ``primary``, ``seq_len``;
    ``reads`` uint8 [B, L], ``lens`` int32 [B]; ``params`` (min_seed_len,
    split_len, split_width, max_intv, maxh).  ``reverse`` runs each
    warp's lanes 31..0.  Returns int64 arrays: (rows [n, slots, 5],
    counts [n], steps [n], chain [n]) for K2, (hits [B, maxh, 5], n_hits
    [B], steps [B]) for K3, and with ``count_rows`` the distinct occ rows
    the launch read, ascending.  Raises RuntimeError with the harness's
    report if a sanitizer or the lockstep check stops it or the entry
    returns an error (K2 refuses reads too long for a block's shared
    memory)."""
    L2 = np.asarray(arrays["L2"])
    if L2.dtype not in (np.int32, np.int64):
        raise TypeError(f"rank type {L2.dtype}")
    occ = np.ascontiguousarray(arrays["occ_blocks"], np.uint32)
    reads = np.ascontiguousarray(reads, np.uint8)
    B, L = reads.shape
    rids = np.ascontiguousarray(np.arange(B) if rids is None else rids,
                                np.int32)
    n = len(rids) if kernel == 0 else B
    min_seed_len, split_len, split_width, max_intv, maxh = params
    head = np.asarray([kernel, len(occ), arrays["primary"],
                       arrays["seq_len"], L2.dtype == np.int64, B, L, n,
                       min_seed_len, split_len, split_width, slots,
                       max_intv, maxh, int(count_rows), int(reverse)],
                      np.int64)
    got = _exec("smem_host", (head, occ, L2, reads, np.ascontiguousarray(
        lens, np.int32), *((rids,) if kernel == 0 else ())),
        dtype=np.int64, sanitize=sanitize)
    width = slots if kernel == 0 else maxh
    k = n * width * 5
    n_out = 3 if kernel == 0 else 2  # the per-read outputs after the rows
    out = (got[:k].reshape(n, width, 5), *(
        got[k + i * n:k + (i + 1) * n] for i in range(n_out)))
    if count_rows:
        at = k + n_out * n
        m = int(got[at])
        out += (got[at + 1:at + 1 + m],)
    return out

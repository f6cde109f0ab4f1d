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
``extend_mat_host`` (K1-mat), ``extend_real_host`` (K1-real),
``extend16_host`` (K1-i16), ``extend_bd_host`` (K1-bd, both passes),
``occ_host`` (K-sa and K-ext; ``sa_lookup_refusal``, K-sa's refusal of
an n past its rank queue), ``reach_host`` (K-reach), ``smem_host``
(K2, K3 and K-cur), ``fwd_host`` (K-fwd) and ``bwd_host`` (K-bwd) run
one on a set of jobs, ``form_sources`` writes the sources of K-fwd's
forms (``SPLIT_FORMS``), and
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


# csrc/smem.cu's K-fwd in its forms: each form, the edits to the shipped
# sources (file, old text, new text) that make it: the lanes a job
# (kFwdGroup) and the blocks of 4 warps an SM it is pinned to
# (kFwdMinBlocks: its registers).  g32 is the first design's layout, a
# warp a job.  scripts/exp_split_forms.py times them on a card;
# ``form_sources`` writes them for the harness.
SPLIT_SHIPPED = {"kFwdGroup": 8, "kFwdMinBlocks": 8}


def _split_form(**consts):
    return [("smem.cu", f"constexpr int {k} = {SPLIT_SHIPPED[k]};",
             f"constexpr int {k} = {v};") for k, v in consts.items()
            if v != SPLIT_SHIPPED[k]]


SPLIT_FORMS = {
    "g4": _split_form(kFwdGroup=4),
    "g8": _split_form(),
    "g16": _split_form(kFwdGroup=16),
    "g32": _split_form(kFwdGroup=32),
    # other register pins: 40 and 36 warps an SM
    "b10": _split_form(kFwdMinBlocks=10),
    "b9": _split_form(kFwdMinBlocks=9),
}


def split_constants(csrc: Path = CSRC) -> dict:
    """K-fwd's constants in ``csrc``'s smem.cu (kFwdGroup,
    kFwdMinBlocks)."""
    import re
    text = (Path(csrc) / "smem.cu").read_text()
    return {k: int(re.search(rf"constexpr int {k} = (\d+);", text).group(1))
            for k in ("kFwdGroup", "kFwdMinBlocks")}


def form_sources(form: str, out: Path) -> Path:
    """A copy of smem_host's sources in ``out`` with split form ``form``'s
    edits applied (each must find its text once), for ``csrc=``."""
    out = Path(out)
    out.mkdir(parents=True, exist_ok=True)
    for src in SOURCES["smem_host"]:
        shutil.copy(CSRC / src, out / src)
    for fname, old, new in SPLIT_FORMS[form]:
        text = (out / fname).read_text()
        if text.count(old) != 1:
            raise RuntimeError(f"{old!r} is not in {fname} once")
        (out / fname).write_text(text.replace(old, new))
    return out


def build(name: str = "extend_host", sanitize: bool = True,
          csrc: Path = CSRC) -> Path:
    """The harness executable ``name`` (a key of ``SOURCES``), built on
    first use from the sources in ``csrc`` (the package's, or an edited
    copy of them), with ``FLAGS`` (or ``FAST_FLAGS`` where not
    ``sanitize``).  Raises RuntimeError without g++ or when the build
    fails."""
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found: the host harness needs it")
    csrc = Path(csrc)
    flags = FLAGS if sanitize else FAST_FLAGS
    key = b"".join((csrc / s).read_bytes() for s in SOURCES[name])
    key += " ".join(flags).encode()
    exe = BUILD / f"{name}-{hashlib.sha256(key).hexdigest()[:16]}"
    if not exe.exists():
        BUILD.mkdir(parents=True, exist_ok=True)
        tmp = exe.with_suffix(f".{os.getpid()}.tmp")
        entry = SOURCES[name][0]
        res = subprocess.run([gxx, *flags, "-o", str(tmp), str(csrc / entry)],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"g++ failed on {entry}:\n{res.stderr}")
        os.replace(tmp, exe)
    return exe


def _exec(name, arrays, args=(), dtype=np.int32, sanitize=True, csrc=CSRC):
    """Run harness ``name`` (built from ``csrc``) on the concatenated
    bytes of ``arrays``; returns what it wrote, as ``dtype``.  Raises
    RuntimeError with its report if it fails."""
    exe = build(name, sanitize, csrc)
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


def _run(q, t, params, pen, masks, variants, reverse, mats=()):
    """The harness on one set of jobs: (one int32 [N, 6] per mask, one
    int32 [N, 128] per K1-real variant index, one int32 [N, 6] per 5 x 5
    matrix of ``mats``)."""
    q, t, params = _jobs(q, t, params)
    n, W = q.shape
    head = np.asarray([n, W, t.shape[1], params.shape[1], *pen, int(reverse),
                       len(masks), len(variants), len(mats), *masks,
                       *variants], np.int32)
    tables = np.asarray(mats, np.int32).reshape(-1)
    got = _exec("extend_host", (head, tables, q, t, params))
    k = len(masks) * n * 6
    r = k + len(variants) * n * 128
    return (list(got[:k].reshape(len(masks), n, 6)),
            list(got[k:r].reshape(len(variants), n, 128)),
            list(got[r:].reshape(len(mats), n, 6)))


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


def extend_mat_host(q, t, params, mats, o_del, e_del, o_ins, e_ins, zdrop,
                    reverse=False):
    """K1-mat's C entry (``tpubwa_extend_mat``) on the host: one int32
    [N, 6] per int32 [5, 5] scoring matrix of ``mats``.  Raises as
    ``extend_host``."""
    return _run(q, t, params, (0, 0, o_del, e_del, o_ins, e_ins, zdrop), (),
                (), reverse, mats)[2]


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


def _slab_input(first, devices, n_arrays):
    """(n_slabs, the int64 arrays of the harness's slab cuts): ``first``,
    one list of first rows an array (``n_arrays`` of them, all of one
    length; None: the flat entries), and the slabs' ``devices`` (all 0
    where None)."""
    if first is None:
        return 0, ()
    first = [np.asarray(f, np.int64) for f in first]
    if len(first) != n_arrays or len({len(f) for f in first}) != 1:
        raise ValueError(f"{n_arrays} lists of first rows of one length")
    n = len(first[0])
    devices = np.zeros(n, np.int64) if devices is None else np.asarray(
        devices, np.int64)
    return n, (*first, devices)


def _occ_input(arrays, ranks, ik, max_blocks, reverse, n_call, slabs=None,
               devices=None, peers=True, reach=None, count=False,
               card=(0, 0)):
    """(rank type, the occ_host input arrays); ``reach``, ``count`` and
    ``card`` as in ``reach_host``."""
    dt = np.asarray(arrays["sa_sample"]).dtype
    if dt not in (np.int32, np.int64):
        raise TypeError(f"rank type {dt}")
    occ, marks = (np.ascontiguousarray(arrays[k], np.uint32)
                  for k in ("occ_blocks", "mark_rows"))
    ranks = np.ascontiguousarray(ranks, dt)
    ik = np.ascontiguousarray(ik, dt).reshape(-1, 3)
    n_slabs, cuts = _slab_input(slabs, devices, 3)
    if reach is None:
        jobs, shape = (), (0, 0, 0)
    else:
        q, lens, read_idx, starts, min_intv = reach
        q = np.ascontiguousarray(q, np.uint8)
        jobs = (q, *(np.ascontiguousarray(x, np.int32)
                     for x in (lens, read_idx, starts)),
                np.ascontiguousarray(min_intv, dt))
        shape = (len(read_idx), *q.shape)
    head = np.asarray([len(occ), len(marks), len(arrays["sa_marked"]),
                       len(arrays["sa_sample"]), arrays["primary"],
                       arrays["seq_len"], arrays["mark_D"], dt == np.int64,
                       len(ranks), len(ik), max_blocks, int(reverse),
                       n_call, n_slabs, int(peers), *shape, int(count),
                       *card], np.int64)
    return dt, (head, occ, marks, *(
        np.ascontiguousarray(arrays[k], dt)
        for k in ("L2", "sa_marked", "sa_sample")), ranks, ik, *cuts, *jobs)


def occ_host(arrays, ranks, ik, max_blocks=0, reverse=False, stats=None,
             slabs=None, devices=None, peers=True, csrc=CSRC,
             sanitize=True):
    """csrc/occ.cu's C entries on the host, on a tpubwa-layout index:
    ``arrays`` maps ``occ_blocks``, ``mark_rows`` (uint32), ``L2``,
    ``sa_marked``, ``sa_sample`` (the rank type, int32 or int64, taken
    from ``sa_sample``) and ``primary``, ``seq_len``, ``mark_D``.
    Returns (positions [n] of ``ranks`` through ``tpubwa_sa_lookup``,
    the backward and the forward extensions [m, 4, 3] of ``ik`` [m, 3]
    through ``tpubwa_bwt_extend``), of the rank type.  ``max_blocks`` > 0
    caps K-sa's grid; ``reverse`` runs each warp's lanes 31..0; a
    ``stats`` dict gets ``lanes``, the global thread index that walked
    each rank.  ``slabs`` (the first rows of the occ, the mark and the
    sa_marked slabs, three lists of one length, each from 0) runs the TP
    instantiations (``tpubwa_sa_lookup_tp``, the marked walk, and
    ``tpubwa_bwt_extend_tp``) on the arrays cut there, each slab its own
    heap block, on ``devices`` (one a slab; all 0, the launch's, where
    None); ``peers`` False makes the peer-access query refuse every
    pair.  ``csrc`` builds the harness from another copy of the sources
    (a form of ``scripts/exp_reach_forms.py``); ``sanitize`` as in
    ``reach_host``.  Raises RuntimeError with the harness's report if a
    sanitizer or the lockstep check stops it or an entry returns an
    error."""
    dt, inputs = _occ_input(arrays, ranks, ik, max_blocks, reverse, -1,
                            slabs, devices, peers)
    got = _exec("occ_host", inputs, dtype=dt, sanitize=sanitize, csrc=csrc)
    n, m = len(ranks), len(inputs[7]) * 12
    if stats is not None:
        stats["lanes"] = got[n:2 * n].astype(np.int64)
    return (got[:n], got[2 * n:2 * n + m].reshape(-1, 4, 3),
            got[2 * n + m:].reshape(-1, 4, 3))


def reach_host(arrays, q, lens, read_idx, starts, min_intv, reverse=False,
               stats=None, card=(0, 0), sanitize=True, csrc=CSRC):
    """K-reach's C entry (``tpubwa_rightmost_reach``) on the host, on an
    index as ``occ_host`` takes it: reads ``q`` (uint8 [B, L]) of lengths
    ``lens`` and the jobs ``read_idx``, ``starts`` (int32) and
    ``min_intv`` (the rank type).  Returns (ik [n, 3], e [n]) of the rank
    type.  ``reverse`` runs each warp's lanes 31..0; ``card`` (SMs,
    blocks an SM), where nonzero, makes the launch's grid that of a
    smaller card, so that lanes take segment after segment from the
    queue; a ``stats`` dict gets ``steps`` (the extension steps, one
    trip to memory each), ``row_loads`` (the occ rows they loaded) and
    ``rows`` (the distinct rows, ascending, int64).  ``sanitize`` False
    builds without the sanitizers, for a count over many jobs; ``csrc``
    as in ``occ_host``.  Raises as ``occ_host``."""
    dt, inputs = _occ_input(arrays, np.zeros(0), np.zeros((0, 3)), 0,
                            reverse, -1,
                            reach=(q, lens, read_idx, starts, min_intv),
                            count=stats is not None, card=card)
    got = _exec("occ_host", inputs, dtype=dt, sanitize=sanitize, csrc=csrc)
    n = len(read_idx)
    if stats is not None:
        at = 4 * n
        stats.update(steps=int(got[at]), row_loads=int(got[at + 1]),
                     rows=got[at + 3:at + 3 + int(got[at + 2])].astype(
                         np.int64))
    return got[:3 * n].reshape(n, 3), got[3 * n:4 * n]


def sa_lookup_refusal(arrays, ranks, n_call):
    """``tpubwa_sa_lookup`` on the host called with ``n_call`` ranks
    (``ranks`` holds fewer): (its return code, the queue word after it,
    -77 before; the positions, -77 each before).  The entry must refuse
    an n past its rank queue's range before it touches anything."""
    dt, inputs = _occ_input(arrays, ranks, np.zeros((0, 3)), 0, False,
                            n_call)
    got = _exec("occ_host", inputs, dtype=dt)
    return int(got[0]), int(got[1]), got[2:]


def smem_host(arrays, reads, lens, kernel, params, rids=None, slots=0,
              count_rows=False, sanitize=True, reverse=False, card=(0, 0),
              slabs=None, devices=None, peers=True, jobs=None):
    """One launch of csrc/smem.cu's K2 (``kernel`` 0,
    ``tpubwa_smem_rounds12``, on the reads ``rids`` with ``slots`` row
    slots each, a warp a read), K3 (1, ``tpubwa_seed_strategy``, on
    every read, a group of lanes a read) or K-cur (2,
    ``tpubwa_smem_jobs``, on the jobs ``rids`` of ``jobs`` = (read int32,
    x0 int32, min_intv of the rank type, one_shot bool), ``slots`` row
    slots each, a warp a job) on the host.  ``arrays`` maps
    ``occ_blocks`` (uint32), ``L2`` (the rank type, int32 or int64) and
    ``primary``, ``seq_len``; ``reads`` uint8 [B, L], ``lens`` int32 [B];
    ``params`` (min_seed_len, split_len, split_width, max_intv, maxh).
    ``reverse`` runs each warp's lanes 31..0; ``card`` (SMs, blocks an
    SM), where nonzero, makes the attribute and occupancy queries answer
    for a smaller card than an H100, so that a persistent grid holds
    fewer warps than the work.  ``slabs`` (K2 only: the first rows of the
    occ slabs, from 0) launches K2's TP instantiation
    (``tpubwa_smem_rounds12_tp``) on the occ rows cut there, each slab
    its own heap block, on ``devices`` (one a slab; all 0, the launch's,
    where None); ``peers`` False makes the peer-access query refuse every
    pair.  Returns int64 arrays: (rows [n, slots, 5], counts [n], steps
    [n], chain [n]) for K2 and K-cur, (hits [B, maxh, 5], n_hits [B],
    steps [B], chain [B], longest [B]) for K3, and with ``count_rows``
    the distinct occ rows the launch read, ascending.  Raises
    RuntimeError with the harness's report if a sanitizer or the
    lockstep check stops it or the entry returns an error (K2 and K-cur
    refuse reads too long for a block's shared memory)."""
    L2 = np.asarray(arrays["L2"])
    if L2.dtype not in (np.int32, np.int64):
        raise TypeError(f"rank type {L2.dtype}")
    occ = np.ascontiguousarray(arrays["occ_blocks"], np.uint32)
    reads = np.ascontiguousarray(reads, np.uint8)
    B, L = reads.shape
    job_arrays = ()
    if kernel == 2:
        read, x0, mi, once = jobs
        job_arrays = (np.ascontiguousarray(read, np.int32),
                      np.ascontiguousarray(x0, np.int32),
                      np.ascontiguousarray(mi, L2.dtype),
                      np.ascontiguousarray(once, np.uint8))
        if rids is None:
            rids = np.arange(len(read))
    rids = np.ascontiguousarray(np.arange(B) if rids is None else rids,
                                np.int32)
    n = B if kernel == 1 else len(rids)
    min_seed_len, split_len, split_width, max_intv, maxh = params
    if slabs is not None and kernel != 0:
        raise ValueError("K3 has no TP instantiation")
    n_slabs, cuts = _slab_input(None if slabs is None else [slabs],
                                devices, 1)
    head = np.asarray([kernel, len(occ), arrays["primary"],
                       arrays["seq_len"], L2.dtype == np.int64, B, L, n,
                       min_seed_len, split_len, split_width, slots,
                       max_intv, maxh, int(count_rows), int(reverse),
                       *card, n_slabs, int(peers),
                       len(job_arrays[0]) if job_arrays else 0], np.int64)
    tail = {0: (rids, *cuts), 1: (), 2: (*job_arrays, rids)}[kernel]
    got = _exec("smem_host", (head, occ, L2, reads, np.ascontiguousarray(
        lens, np.int32), *tail), dtype=np.int64, sanitize=sanitize)
    width = maxh if kernel == 1 else slots
    k = n * width * 5
    n_out = 4 if kernel == 1 else 3  # the per-read outputs after the rows
    out = (got[:k].reshape(n, width, 5), *(
        got[k + i * n:k + (i + 1) * n] for i in range(n_out)))
    if count_rows:
        at = k + n_out * n
        m = int(got[at])
        out += (got[at + 1:at + 1 + m],)
    return out


def _smem_head(arrays, reads, kernel, n, slots=0, min_seed_len=0,
               count_rows=False, reverse=False, card=(0, 0), m=0):
    """(rank type, occ, L2, reads, smem_host's header) for ``kernel``."""
    L2 = np.asarray(arrays["L2"])
    if L2.dtype not in (np.int32, np.int64):
        raise TypeError(f"rank type {L2.dtype}")
    occ = np.ascontiguousarray(arrays["occ_blocks"], np.uint32)
    reads = np.ascontiguousarray(reads, np.uint8)
    B, L = reads.shape
    head = np.asarray([kernel, len(occ), arrays["primary"],
                       arrays["seq_len"], L2.dtype == np.int64, B, L, n,
                       min_seed_len, 0, 0, slots, 0, 0, int(count_rows),
                       int(reverse), *card, 0, 1, m], np.int64)
    return L2.dtype, occ, L2, reads, head


def _rows_tail(got, at, count_rows):
    """The distinct occ rows after ``at`` where ``count_rows``, as a
    1-tuple, else ()."""
    if not count_rows:
        return ()
    k = int(got[at])
    return (got[at + 1:at + 1 + k],)


def fwd_host(arrays, reads, lens, jobs, slots, ids=None, count_rows=False,
             sanitize=True, reverse=False, card=(0, 0), csrc=CSRC):
    """One launch of csrc/smem.cu's K-fwd (``tpubwa_smem_fwd``) on the
    host, on the jobs ``ids`` (all where None) of ``jobs`` = (read int32,
    x0 int32, min_intv of the rank type, one_shot bool), ``slots`` stack
    intervals each; ``arrays``, ``reads``, ``lens``, ``reverse``, ``card``
    and ``sanitize`` as in ``smem_host``; ``csrc``, the sources to build
    (an edited copy for a form, as ``build`` takes it).  Returns int64
    arrays (stack [n, slots, 4], calls [n, slots, 3], n_calls [n], n_intv
    [n], steps [n], chain [n]) and with ``count_rows`` the distinct occ
    rows the launch read.  Raises RuntimeError as ``smem_host`` does."""
    read, x0, mi, once = jobs
    ids = np.arange(len(read)) if ids is None else ids
    n = len(ids)
    dt, occ, L2, reads, head = _smem_head(arrays, reads, 3, n, slots,
                                          count_rows=count_rows,
                                          reverse=reverse, card=card,
                                          m=len(read))
    got = _exec("smem_host", (head, occ, L2, reads, np.ascontiguousarray(
        lens, np.int32), np.ascontiguousarray(read, np.int32),
        np.ascontiguousarray(x0, np.int32), np.ascontiguousarray(mi, dt),
        np.ascontiguousarray(once, np.uint8),
        np.ascontiguousarray(ids, np.int32)), dtype=np.int64,
        sanitize=sanitize, csrc=csrc)
    ks, kc = n * slots * 4, n * slots * 3
    out = (got[:ks].reshape(n, slots, 4), got[ks:ks + kc].reshape(n, slots, 3),
           *(got[ks + kc + i * n:ks + kc + (i + 1) * n] for i in range(4)))
    return out + _rows_tail(got, ks + kc + 4 * n, count_rows)


def bwd_host(arrays, reads, lens, calls, stack, min_seed_len,
             count_rows=False, sanitize=True, reverse=False, card=(0, 0)):
    """One launch of csrc/smem.cu's K-bwd (``tpubwa_smem_bwd``) on the
    host over ``calls`` = (read int32, x int32, m int32, min_intv of the
    rank type), their stacks ``stack`` ([sum of m, 4] of the rank type)
    one after another; the rest as in ``fwd_host``.  Returns int64 arrays
    (rows [sum of m, 5], each call's at its stack's offset, the slots it
    does not fill left at -77; counts [c], steps [c], chain [c]) and with
    ``count_rows`` the distinct occ rows the launch read."""
    read, x, m, mi = calls
    n, total = len(read), len(stack)
    m = np.ascontiguousarray(m, np.int32)
    off = np.cumsum(m, dtype=np.int64) - m
    dt, occ, L2, reads, head = _smem_head(arrays, reads, 4, n,
                                          min_seed_len=min_seed_len,
                                          count_rows=count_rows,
                                          reverse=reverse, card=card, m=total)
    got = _exec("smem_host", (head, occ, L2, reads, np.ascontiguousarray(
        lens, np.int32), np.ascontiguousarray(read, np.int32),
        np.ascontiguousarray(x, np.int32), m, off,
        np.ascontiguousarray(mi, dt), np.ascontiguousarray(stack, dt)),
        dtype=np.int64, sanitize=sanitize)
    k = total * 5
    out = (got[:k].reshape(total, 5),
           *(got[k + i * n:k + (i + 1) * n] for i in range(3)))
    return out + _rows_tail(got, k + 3 * n, count_rows)

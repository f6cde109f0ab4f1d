"""csrc/extend.cu's kernels on the host, for tests.

The kernel source compiles as plain C++ against ``csrc/warp_host.h``,
which runs a warp's 32 lanes in lockstep and computes its shuffles,
reductions and ballots by a loop over the lanes' operands.  ``build``
compiles ``csrc/extend_host.cpp`` with g++ under
``-fsanitize=address,undefined`` into ``build/host`` in the checkout
(or ``$TPUBWA_TORCH_HOST_BUILD``), keyed by a hash of the sources;
``extend_host`` (K1 and K1-floor) and ``extend_real_host`` (K1-real) run
it on one set of jobs.  This checks the kernel's
logic, its memory accesses and that its warp operations are reached by
all 32 lanes together, where there is no card; what the GPU's compiler
makes of the source still shows only on a card.
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
SOURCES = ("extend_host.cpp", "extend.cu", "warp_host.h")
FLAGS = ["-std=c++17", "-O1", "-g", "-fsanitize=address,undefined",
         "-fno-sanitize-recover=undefined"]


def build() -> Path:
    """The harness executable, built on first use.  Raises RuntimeError
    without g++ or when the build fails."""
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found: the host harness needs it")
    key = b"".join((CSRC / s).read_bytes() for s in SOURCES)
    key += " ".join(FLAGS).encode()
    exe = BUILD / f"extend_host-{hashlib.sha256(key).hexdigest()[:16]}"
    if not exe.exists():
        BUILD.mkdir(parents=True, exist_ok=True)
        tmp = exe.with_suffix(f".{os.getpid()}.tmp")
        res = subprocess.run([gxx, *FLAGS, "-o", str(tmp),
                              str(CSRC / "extend_host.cpp")],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"g++ failed on extend_host.cpp:\n{res.stderr}")
        os.replace(tmp, exe)
    return exe


def _run(q, t, params, pen, masks, variants, reverse):
    """The harness on one set of jobs: (one int32 [N, 6] per mask, one
    int32 [N, 128] per K1-real variant index)."""
    exe = build()
    q, t, params = (np.ascontiguousarray(x, np.int32) for x in (q, t, params))
    n, W = q.shape
    head = np.asarray([n, W, t.shape[1], params.shape[1], *pen, int(reverse),
                       len(masks), len(variants), *masks, *variants],
                      np.int32)
    with tempfile.TemporaryDirectory() as d:
        jobs, out = os.path.join(d, "jobs"), os.path.join(d, "out")
        with open(jobs, "wb") as fh:
            for x in (head, q, t, params):
                fh.write(x.tobytes())
        res = subprocess.run([str(exe), jobs, out], capture_output=True,
                             text=True)
        if res.returncode != 0:
            raise RuntimeError(f"extend_host failed (rc {res.returncode}):\n"
                               f"{res.stderr[-4000:]}")
        got = np.fromfile(out, np.int32)
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

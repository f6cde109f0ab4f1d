"""K-fwd's forms side by side on the main path's launches: each form of
``csrc/smem.cu``'s ``smem_fwd_kernel`` (a group of lanes a bwt_smem1a
job, its forward phases) alone on seed mode split's round-1 and round-2
launches of the first chunk of ``chip_smoke.py``'s phase 5c (16,384
reads of the 64 Mbp realistic genome, int32 ranks), in interleaved
passes, beside K-bwd (``smem_bwd_kernel``, a warp a recorded call) and
K-cur on the same jobs.

A form is the package's source with named edits
(``device/warp_host.py:SPLIT_FORMS``, which the host harness runs too),
so that each design can be timed against the others in one process on
one card:

* ``g4``, ``g8``, ``g16``: a group of 4, 8 or 16 lanes a job, each
  forward step counted across the group (``fm.cuh:bwt_extend_group``),
  32 / G jobs a warp in lockstep;
* ``g32``: a warp a job (``smem.cuh:bwt_extend_warp``, K2's forward
  step): the first design's layout, without its stacks in shared
  memory;
* ``b10``, ``b9``: the shipped group pinned by ``__launch_bounds__`` to
  40 or 36 warps an SM (fewer registers).

``SHIPPED`` is the form the package builds (no edits).  ``--first DIR``
adds the first design itself, built from the sources in ``DIR`` (a
checkout's ``tpubwa_torch/csrc`` from before the group design: a warp a
job, its stacks in shared memory).

K-bwd's group forms (4 to 32 lanes a call, 4 lanes an interval, one
stack in place sized by m with a wide second launch past it, a
queue-free feed, other register pins), which all ran slower than its
first design and are not kept, come back with
``split_bwd_groups.patch`` beside this script: ``git apply`` it at the
root of a checkout and run this module as below (``--caps 16,32,64``
also times the grouped launch at those stack slots); it restores
csrc/smem.cu, smem.cuh, smem_host.cpp, device/smem_split.py,
smem_fused.py, warp_host.py, this script and chip_smoke.py as they were
when PERF.md's K-bwd forms were timed.

Each form is built with the package's nvcc flags into
``build/split_forms/<form>``, its launches' results (calls, intervals
and steps a job) are held equal to the package's wrapper before it is
timed, and each keeps the minimum over ``--passes`` passes of the
marginal time per launch in a chain of ``--reps``
(``exp_kernel_floor.interleaved_min``), in both orders; then what the
timed launches left is held equal again.  It prints each form's
registers, its block, and the warps and jobs in flight an SM.

Run it on a card, from the root of a checkout (it builds phase 5's
index and runs phase 5c for the chunk, about 5 min):

    python -m tpubwa_torch.scripts.exp_split_forms [--passes 4]
        [--reps 20] [--first DIR]
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from ..device import _build, smem_cursor, smem_fused, smem_split, warp_host
from .exp_kernel_floor import interleaved_min

SHIPPED = "g8"
def build(form: str):
    """(the ctypes handle of ``form``'s build, its sources' directory):
    its edits applied to a copy of the sources."""
    out = _build.BUILD.parent / "split_forms" / form
    lib, _ = _build.build_edited("smem", warp_host.SPLIT_FORMS[form], out,
                                 smem_fused._SIGNATURES)
    return lib, out


def build_first(csrc: Path):
    """(the ctypes handle, the ptxas report) of ``csrc``'s smem.cu, the
    first design, with the package's nvcc flags (its K-fwd entry is the
    package's)."""
    out = _build.BUILD.parent / "split_forms" / "first"
    out.mkdir(parents=True, exist_ok=True)
    so = out / "smem.so"
    res = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so),
                          str(Path(csrc) / "smem.cu")], capture_output=True,
                         text=True)
    if res.returncode:
        raise RuntimeError(f"nvcc failed on {csrc}/smem.cu:\n{res.stderr}")
    lib = ctypes.CDLL(str(so))
    restype, argtypes = smem_fused._SIGNATURES["tpubwa_smem_fwd"]
    lib.tpubwa_smem_fwd.restype = restype
    lib.tpubwa_smem_fwd.argtypes = argtypes
    return lib, res.stderr


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--passes", type=int, default=4)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--first", default=None,
                    help="the first design's csrc directory")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("exp_split_forms needs a CUDA card")
    import chip_smoke as c  # the root of the checkout is on sys.path
    forms = [f for f in warp_host.SPLIT_FORMS if f != SHIPPED]
    with ThreadPoolExecutor(len(forms) + 2) as ex:
        built = {f: ex.submit(build, f) for f in forms}
        first = ex.submit(build_first, args.first) if args.first else None
        lib = _build.load("smem", smem_fused._SIGNATURES)
        libs = {SHIPPED: (lib, None), **{f: b.result()
                                         for f, b in built.items()}}
        first = first.result() if first else None
    if first:
        libs["first"] = (first[0], None)
    main_path = c.phase_main_path(torch, np)
    opt, didx, qd, ld = c.phase_megaq(torch, np, main_path)["chunk"]
    msl, L = opt.min_seed_len, qd.shape[1]
    jobs = smem_cursor.round1_jobs(len(ld), didx.idt, qd.device)
    rounds, fns, checks = {}, {}, []
    for name in ("round1", "round2"):
        fst, bst = {}, {}
        calls = smem_split.run_fwd(didx, qd, ld, jobs, stats=fst)
        bcalls = smem_split.bwd_calls(jobs, calls)
        rows, n = smem_split.run_bwd(didx, qd, ld, *bcalls, calls.stack, msl,
                                     stats=bst)
        rounds[name] = (len(jobs[0]), calls)
        per_job = torch.bincount(calls.job, minlength=len(jobs[0])).int()
        per_intv = torch.bincount(calls.job, weights=calls.m.double(),
                                  minlength=len(jobs[0])).int()

        def fwd_ok(fn, per_job=per_job, per_intv=per_intv, fst=fst):
            b = fn.buffers
            return (torch.equal(b[5], per_job) and torch.equal(b[6], per_intv)
                    and torch.equal(b[7], fst["steps"]))

        def bwd_ok(fn, calls=calls, rows=rows, n=n, bst=bst):
            b = fn.buffers
            return (torch.equal(b[5], n) and torch.equal(b[6], bst["steps"])
                    and torch.equal(smem_split.call_rows(b[4], b[5], calls.m),
                                    rows))

        for form, (flib, _) in libs.items():
            fns[f"fwd {form} {name}"] = c.kfwd_alone(torch, didx, qd, ld,
                                                     jobs, lib=flib)
            checks.append((f"fwd {form} {name}", fwd_ok))
        fns[f"bwd {name}"] = c.kbwd_alone(torch, didx, qd, ld, bcalls,
                                          calls.stack, msl)
        checks.append((f"bwd {name}", bwd_ok))
        fns[f"kcur {name}"] = c.kcur_alone(torch, opt, didx, qd, ld, jobs)
        counts = torch.zeros(len(jobs[0]), dtype=torch.int64,
                             device=qd.device).index_add_(0, calls.job,
                                                          n.long()).int()
        jobs = smem_cursor.round2_jobs(opt, rows, counts)

    def check(when):
        for key, ok in checks:
            if not ok(fns[key]):
                raise AssertionError(f"{key} != the wrappers' ({when})")

    for fn in fns.values():
        fn()
    torch.cuda.synchronize()
    check("first launch")
    dev = torch.device("cuda")
    ms = interleaved_min(fns, args.reps, args.passes, dev)
    back = interleaved_min(dict(reversed(list(fns.items()))), args.reps,
                           args.passes, dev)
    torch.cuda.synchronize()
    check("timed launches")
    shapes, regs = {}, {}
    units = {"fwd": rounds["round1"][0], "bwd": len(rounds["round1"][1].m)}
    for form, (flib, src) in libs.items():
        if form == "first":
            continue
        report = (_build.build_info["smem"]["ptxas"] if src is None
                  else _build.build_info[str(src)]["ptxas"])
        facts = c.ksplit_launch_facts(torch, L, units,
                                      {form: (flib, report, src)})
        shapes.update(facts["launch"])
        regs.update(facts["ptxas"])
    if first:
        regs["first"] = [line.strip() for line in first[1].splitlines()
                         if "registers" in line]
    print("[split forms] " + json.dumps({
        "reads": len(ld), "shipped": SHIPPED,
        "jobs": {k: v[0] for k, v in rounds.items()},
        "calls": {k: len(v[1].m) for k, v in rounds.items()},
        "ms": {k: round(v, 4) for k, v in ms.items()},
        "ms_reversed": {k: round(v, 4) for k, v in back.items()},
        "registers": regs, "launch": shapes,
        "gpu": torch.cuda.get_device_name(0)}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

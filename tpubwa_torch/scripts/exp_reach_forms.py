"""K-reach's and K-ext's forms side by side: each form of ``csrc/occ.cu``
alone on the jobs of ``chip_smoke.py``'s phase 3j (every start 0-99 of
every read of 5c's first chunk, 16,384 reads of the 64 Mbp realistic
genome: 1,638,400 jobs, min_intv 1, int32 ranks) for K-reach, and on
65,536 intervals built as phase 3g builds them (one-base intervals of
random bases, extended backward, then the backward results of random
bases extended forward) for K-ext, in interleaved passes, warm and after
a write that flushes L2.

A form is the package's source with named edits, so that each design
can be timed against the others in one process on one card:

* ``first``: the first designs, restored: K-reach one thread a job, each
  walking forward to its own end, and K-ext one interval a thread,
  storing its twelve values one by one;
* ``shipped``: the sources as they are (K-reach a group of
  ``kReachGroup`` lanes a segment of ``kSeg`` jobs, the jobs of a read
  chained right to left by backward extensions; K-ext an interval on
  ``kExtGroup`` lanes);
* ``seg<S>``: the shipped form with segments of S jobs (``seg100`` is a
  whole read of 3j's jobs);
* ``reach-g<G>``: the shipped form with K-reach's segment on G lanes
  (``reach-g1``: a lane a segment, its steps ``fm::bwt_extend``;
  ``reach-g4`` and ``reach-g8``: ``fm::bwt_extend_group``);
* ``no-prefetch``: the shipped form with each job's fields and a forward
  walk's next base loaded when they are needed, not ahead;
* ``ext-g<G>``: the shipped form with K-ext on groups of G lanes.

Each form is built with the package's nvcc flags into
``build/reach_forms/<form>``; its K-reach results (ik and e) and K-ext
results are held equal to the package's wrappers before it is timed, and
each keeps the minimum over ``--passes`` passes of the marginal time per
launch in a chain of ``--reps`` (``exp_kernel_floor.interleaved_min``),
in both orders; then the least time of one launch after a 64 MB write
(``chip_smoke.cold_ms``), and what the timed launches left is held equal
again.

Run it on a card, from the root of a checkout (it runs phases 5 and 5c
for their index and chunk, about 4 min):

    python -m tpubwa_torch.scripts.exp_reach_forms [--passes 4] [--reps 20]
"""

from __future__ import annotations

import argparse
import json
import re
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..device import _build, occ, smem
from .exp_kernel_floor import interleaved_min

SOURCES = ("occ.cu", "fm.cuh")
SEGMENTS = (8, 16, 32, 64, 100)  # K-reach's segment lengths (of 4s)
REACH_GROUPS = (1, 4, 8)       # K-reach's lanes a segment
EXT_GROUPS = (4, 8)            # K-ext's lanes an interval
STARTS = 100                   # 3j: starts 0-99 of every read
N_EXT = 1 << 16                # 3g: intervals of K-ext

# PR 12's K-ext and PR 23's K-reach (with the segment queue's argument,
# unused), and PR 23's grid, a thread a job
FIRST_EXT = '''template <class Idx, bool IsBack, bool Tp>
__global__ void __launch_bounds__(kThreads)
bwt_extend_kernel(fm::Index<Idx, Rows<uint32_t, Tp>> f,
                  const Idx* __restrict__ ik,
                  Idx* __restrict__ ok, int64_t n) {
    const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    f = fm::with_l2(f);
    const Idx in[3] = {ik[3 * i], ik[3 * i + 1], ik[3 * i + 2]};
    Idx res[4][3];
    fm::bwt_extend<Idx, IsBack>(f, in, res);
    Idx* o = ok + 12 * i;
    for (int c = 0; c < 4; ++c)
        for (int j = 0; j < 3; ++j) o[3 * c + j] = res[c][j];
}

'''
FIRST_REACH = '''template <class Idx>
__global__ void __launch_bounds__(kThreads)
reach_kernel(fm::Index<Idx> f, const uint8_t* __restrict__ q, int L,
             const int32_t* __restrict__ lens,
             const int32_t* __restrict__ read_idx,
             const int32_t* __restrict__ starts,
             const Idx* __restrict__ min_intv, Idx* __restrict__ ik_out,
             Idx* __restrict__ e_out, int64_t n,
             unsigned long long* __restrict__ queue) {
    const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    f = fm::with_l2(f);
    const uint8_t* qr = q + (int64_t)read_idx[i] * L;
    const Idx b = starts[i], jl = lens[read_idx[i]], mi = min_intv[i];
    const auto base_at = [&](Idx pos) -> int {
        return qr[pos < 0 ? 0 : pos > L - 1 ? L - 1 : pos];
    };
    const int c0 = base_at(b);
    const bool valid0 = c0 <= 3 && b < jl;
    Idx ik[3];
    fm::set_intv(f, valid0 ? c0 : 0, ik);
    bool live = valid0 && ik[2] >= mi;
    Idx e = live ? b + 1 : b;
    for (Idx pos = b + 1; live; ++pos) {
        const int c = base_at(pos);
        if (pos >= jl || c > 3) break;
        Idx ok[4][3];
        fm::bwt_extend<Idx, false>(f, ik, ok);
        Idx nik[3];
#pragma unroll
        for (int j = 0; j < 3; ++j)
            nik[j] = fm::pick4(ok[0][j], ok[1][j], ok[2][j], ok[3][j], 3 - c);
        live = nik[2] >= mi;
        if (live) {
#pragma unroll
            for (int j = 0; j < 3; ++j) ik[j] = nik[j];
            e = pos + 1;
        }
    }
    for (int j = 0; j < 3; ++j) ik_out[3 * i + j] = ik[j];
    e_out[i] = e;
}

'''
_EXT_AT = "// K-ext: one interval on a group of kExtGroup lanes"
_REACH_AT = "// K-reach: the rightmost forward reach of each job, with"
_REACH_END = "int blocks_for(int64_t n) {"
_GRID = ("    *blocks = std::min<int64_t>((int64_t)per_sm * sms,\n"
         "                                blocks_for(segs * kReachGroup));")
_EXT_GRID = "TPUBWA_LAUNCH(kernel, blocks_for(n * kExtGroup), kThreads"


def constant(name: str) -> int:
    """The value of ``constexpr int name`` in csrc/occ.cu."""
    return int(re.search(rf"constexpr int {name} = (\d+);",
                         (_build.CSRC / "occ.cu").read_text()).group(1))


def _first():
    """The edits that restore the first designs: the two kernels, cut
    from the source at their notes, and their grids."""
    text = (_build.CSRC / "occ.cu").read_text()
    ext = text[text.index(_EXT_AT):text.index(_REACH_AT)]
    reach = text[text.index(_REACH_AT):text.index(_REACH_END)]
    return [("occ.cu", ext, FIRST_EXT), ("occ.cu", reach, FIRST_REACH),
            ("occ.cu", _GRID, "    *blocks = blocks_for(n);"),
            ("occ.cu", _EXT_GRID,
             "TPUBWA_LAUNCH(kernel, blocks_for(n), kThreads")]


def _set(name: str, value: int):
    old = constant(name)
    return [("occ.cu", f"constexpr int {name} = {old};",
             f"constexpr int {name} = {value};")]


NO_PREFETCH = [
    ("occ.cu", "        if (jb != j) {  // a segment's first job\n",
     "        {  // every job's fields and bases when it starts\n"),
    ("occ.cu", """        if (j > lo) {
            if (ja != j - 1) fields(j - 1);
            bases();
            if (j - 1 > lo) fields(j - 2);
        }
""", "        // the jobs to the left are not fetched ahead\n"),
    ("occ.cu", "        c = c1;\n",
     "        c = base_at(pos);  // no fetch\n"),
    ("occ.cu", "            c = cn;\n",
     "            c = base_at(pos);  // loaded after the step\n")]


def forms() -> dict:
    """{form: its edits}, from the sources as they are."""
    out = {"first": _first(), "shipped": [], "no-prefetch": NO_PREFETCH}
    for prefix, name, values in (("seg", "kSeg", SEGMENTS),
                                 ("reach-g", "kReachGroup", REACH_GROUPS),
                                 ("ext-g", "kExtGroup", EXT_GROUPS)):
        out.update({f"{prefix}{v}": _set(name, v) for v in values
                    if v != constant(name)})
    return out


def build(form: str, edits):
    """(the ctypes handle of ``form``'s build, its ptxas register
    lines): its edits applied to a copy of the sources; each edit must
    apply exactly once."""
    return _build.build_edited("occ", edits, _build.BUILD.parent
                               / "reach_forms" / form, occ._SIGNATURES)


def ext_intervals(didx, dev, seed=0x0CC):
    """3g's construction: (the backward case's intervals, the forward
    case's), N_EXT each."""
    rng = np.random.default_rng(seed)
    pick = [torch.from_numpy(rng.integers(0, 4, N_EXT)).to(dev)
            for _ in range(2)]
    ik = occ.set_intv(didx, pick[0]).contiguous()
    fwd = occ.bwt_extend(didx, ik, True)[
        torch.arange(N_EXT, device=dev), pick[1]].contiguous()
    return ik, fwd


def run(c, didx, qd, ld, passes=4, reps=20) -> dict:
    """Every form side by side on 3j's jobs over the reads ``qd`` (of
    lengths ``ld``) and on K-ext's intervals, through ``chip_smoke``
    (``c``)'s launches alone: the facts ``main`` prints."""
    dev = qd.device
    B = len(ld)
    read_idx = torch.arange(B, dtype=torch.int32,
                            device=dev).repeat_interleave(STARTS)
    starts = torch.arange(STARTS, dtype=torch.int32, device=dev).repeat(B)
    mi = torch.ones(len(read_idx), dtype=didx.idt, device=dev)
    want_ik, want_e = smem.rightmost_reach(didx, qd, ld, read_idx, starts, mi)
    stats = {}
    pik, pe = smem.rightmost_reach_plain(didx, qd, ld, read_idx, starts, mi,
                                         stats=stats)
    if not (torch.equal(want_ik, pik) and torch.equal(want_e, pe)):
        raise AssertionError("K-reach's wrapper != rightmost_reach_plain")
    cases = dict(zip(("back", "fwd"), ext_intervals(didx, dev)))
    want_ext = {k: occ.bwt_extend(didx, ik, k == "back")
                for k, ik in cases.items()}
    todo = forms()
    with ThreadPoolExecutor(len(todo)) as pool:
        built = dict(zip(todo, pool.map(lambda f: build(f, todo[f]), todo)))
    fns, regs = {}, {}
    for form, (lib, regs[form]) in built.items():
        fns[f"{form}/reach"] = c.reach_alone(torch, didx, qd, ld, read_idx,
                                             starts, mi, lib=lib)
        for k, ik in cases.items():
            fns[f"{form}/ext-{k}"] = c.kext_alone(torch, didx, ik,
                                                  k == "back", lib=lib)

    def held(when):
        torch.cuda.synchronize()
        for key, fn in fns.items():
            what = key.split("/")[1]
            if what == "reach":
                ok = (torch.equal(fn.buffers[5], want_ik)
                      and torch.equal(fn.buffers[6], want_e))
            else:
                ok = torch.equal(fn.buffers[1], want_ext[what[4:]])
            if not ok:
                raise AssertionError(f"{key} != the wrapper ({when})")
    for fn in fns.values():
        fn()
    held("first launch")
    ms = interleaved_min(fns, reps, passes, dev)
    back = interleaved_min(dict(reversed(list(fns.items()))), reps, passes,
                           dev)
    cold = {key: c.cold_ms(torch, fn) for key, fn in fns.items()}
    held("timed launches")
    return {"jobs": len(read_idx), "intervals": N_EXT,
            **{k: constant(k) for k in ("kSeg", "kReachGroup",
                                        "kExtGroup")},
            "plain_steps_mean": round(float(stats["steps"].float().mean()),
                                      3),
            "ms": {k: round(v, 4) for k, v in ms.items()},
            "ms_reversed": {k: round(v, 4) for k, v in back.items()},
            "cold_ms": {k: round(v, 4) for k, v in cold.items()},
            "registers": regs, "gpu": torch.cuda.get_device_name(0)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--passes", type=int, default=4)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("exp_reach_forms needs a CUDA card")
    import chip_smoke as c  # the root of the checkout is on sys.path
    main_path = c.phase_main_path(torch, np)
    _, didx, qd, ld = c.phase_megaq(torch, np, main_path)["chunk"]
    facts = run(c, didx, qd, ld, args.passes, args.reps)
    print("[reach forms] " + json.dumps(facts), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

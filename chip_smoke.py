#!/usr/bin/env python3
"""Smoke run of tpubwa_torch on one NVIDIA GPU: the quickest proof that
the port builds, agrees with its plain PyTorch versions, and runs
`mem` end to end on the card.

Usage (from the root of a checkout, one CUDA card visible):

    python3 chip_smoke.py

Phases, one output line each (a failing phase raises, exit != 0):
  1. toolchain facts (torch, CUDA, nvcc, triton, nvidia-smi);
  2. build of the CUDA kernels from tpubwa_torch/csrc (nvcc, sm_90a; one
     nvcc per source, all started together), with ptxas's registers and
     spills for each;
  3. the extension kernel == extend_batch_plain on the card, exactly,
     at the main path's shapes, and descriptor extension kernel ==
     plain on adversarial descriptors, with CUDA-event times;
 3b. the int16 extension kernel == extend_batch16_plain == K1's kernel,
     exactly, at phase 3's shapes, with CUDA-event times for all three;
     then the ported int16 experiment
     (tpubwa_torch.scripts.exp_int16_kernel.main: int32 against int16
     timing, and its 1,920-job equality fuzz, which must find 0
     mismatches), whose int16 kernel launches are counted;
  4. `mem --device cuda` on tests/golden: SE and PE SAM byte-equal to
     the snapshots (tpubwa's own output), @PG stripped;
  5. the main path at real size: 2 batches x 8,192 pairs of 100 bp PE
     reads on the 64 Mbp repeat-realistic synthetic genome, through
     tpubwa's process_batches with the port's aligner on cuda; the
     first 512 pairs' SAM equals a run with device="cpu" and one through
     tpubwa's scalar host pipeline.
Then a JSON line of the kernels (launches on each kernel's path: K1 in
phase 5, the int16 kernel in the experiment of phase 3b; errors, times)
and, last, {"ok": true, "device": {...}}.

Everything it builds or caches (kernels, the native host library, the
benchmark index) goes under build/ in the checkout.  It imports no JAX.
"""
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
BUILD = os.path.join(ROOT, "build")
DEV = "cuda"
GENOME_MB = 64          # the benchmark genome of phase 5
PAIRS = 8192            # pairs per batch in phase 5 (2 batches)


def _run(cmd):
    return subprocess.run(cmd, capture_output=True, text=True,
                          check=True).stdout.strip()


def cuda_ms(fn, reps):
    """Mean ms per call over ``reps`` calls after one warm-up, timed
    with CUDA events on the current stream."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def make_jobs(rng, n, W, tmax):
    """n extension jobs at one (W, tmax) shape: 80% queries copied from
    their target with SNPs and a small indel (high scores, band
    excursions that need the second band trial at small w), N codes on
    both sides, 5% empty targets and 2% empty queries; sorted by target
    length as the main path sorts them."""
    import numpy as np
    t = rng.integers(0, 4, (n, tmax)).astype(np.int32)
    j = np.arange(W)[None, :]
    cut = rng.integers(0, W, n)[:, None]
    shift = (rng.integers(-3, 4, n) * (rng.random(n) < 0.3))[:, None]
    src = np.clip(np.where(j < cut, j, j + shift), 0, tmax - 1)
    q = np.take_along_axis(t, src, axis=1)
    snp = rng.random((n, W)) < 0.03
    q = np.where(snp, (q + 1) % 4, q)
    rand = rng.random(n) < 0.2
    q[rand] = rng.integers(0, 4, (int(rand.sum()), W))
    q[rng.random((n, W)) < 0.005] = 4
    t[rng.random((n, tmax)) < 0.005] = 4
    qlen = rng.integers(1, W, n)
    tlen = rng.integers(1, tmax + 1, n)
    tlen[rng.random(n) < 0.05] = 0
    qlen[rng.random(n) < 0.02] = 0
    q[j >= qlen[:, None]] = 4
    t[np.arange(tmax)[None, :] >= tlen[:, None]] = 4
    p = np.stack([qlen, tlen, rng.integers(1, 60, n),
                  rng.choice([3, 10, 25, 100], n),
                  rng.choice([0, 5], n)], axis=1).astype(np.int32)
    order = np.argsort(-tlen, kind="stable")
    return q[order].astype(np.int32), t[order], p[order]


def retry_descs(bnt, rng, n, L=100):
    """n descriptor rows (and their reads, uint8 [n, L]) whose left or
    right side crosses a 3-base deletion at band w = 4: the band
    excursion reaches 3/4 w, so each side takes the second band
    trial (w = 8)."""
    import numpy as np
    reads = np.zeros((n, L), np.uint8)
    rows = []
    qbeg, slen, gap = 30, 25, 3
    for k in range(n):
        s = int(rng.integers(64, bnt.l_pac - L - 64))
        ref = bnt.get_seq(s, s + L + gap)
        d = 70 if k % 2 else 12          # in the right / left side
        reads[k] = np.concatenate([ref[:d], ref[d + gap:]])
        rbeg = s + qbeg + (gap if d < qbeg else 0)
        rows.append((k, qbeg, slen, L, rbeg, s - 20, s + L + 20, 4, slen,
                     5, 5))
    return reads, np.asarray(rows, np.int64)


def phase_toolchain(torch):
    from tpubwa_torch.device import _build
    smi = _run(["nvidia-smi", "--query-gpu=name,power.limit",
                "--format=csv,noheader"]).splitlines()[0]
    nvcc = _run([_build._nvcc(), "--version"]).splitlines()[-1]
    try:
        import triton
        triton_v = triton.__version__
    except ImportError:
        triton_v = None
    print("[1 toolchain] " + json.dumps({
        "python": sys.version.split()[0], "torch": torch.__version__,
        "torch_cuda": torch.version.cuda, "nvcc": nvcc,
        "triton": triton_v, "gpu": torch.cuda.get_device_name(0),
        "device_count": torch.cuda.device_count()}), flush=True)
    print(smi, flush=True)
    return smi


def phase_build():
    from concurrent.futures import ThreadPoolExecutor
    from tpubwa_torch.device import _build
    from tpubwa_torch.device import extend_kernel as ek
    from tpubwa_torch.scripts import exp_int16_kernel as x16
    kernels = {"extend": ek._SIGNATURES, "extend16": x16._SIGNATURES}
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(kernels)) as ex:
        futures = [ex.submit(_build.load, name, sigs)
                   for name, sigs in kernels.items()]
        for f in futures:
            f.result()
    built = []
    for name in kernels:
        info = _build.build_info[name]
        ptxas = [l.strip() for l in info["ptxas"].splitlines()
                 if "registers" in l or "spill" in l]
        if not ptxas:
            raise AssertionError(f"no ptxas report for {name}")
        built.append({"source": f"tpubwa_torch/csrc/{name}.cu",
                      "nvcc_s": round(info["seconds"], 3),
                      "ptxas": ptxas})
    print("[2 build] " + json.dumps({
        "kernels": built, "load_s": round(time.perf_counter() - t0, 3)}),
        flush=True)


def phase_kernel(torch, np):
    from tpubwa.opts import MemOpt
    from tpubwa_torch.device import extend_kernel as ek
    o = MemOpt()
    pen = (o.a, o.b, o.o_del, o.e_del, o.o_ins, o.e_ins)
    rng = np.random.default_rng(0x5EED)
    cases = []
    max_err = 0
    main_shape = None
    for W, tmax in ((128, 256), (256, 512)):
        for n in (512, 8192):
            for zdrop in (0, 100):
                q, t, p = (torch.from_numpy(x).to(DEV)
                           for x in make_jobs(rng, n, W, tmax))

                def kern():
                    return ek.extend_batch(q, t, p, *pen, zdrop)

                def plain():
                    return ek.extend_batch_plain(q, t, p, *pen, zdrop)
                got, want = kern(), plain()
                torch.cuda.synchronize()
                err = int((got.long() - want.long()).abs().max())
                if not torch.equal(got, want):
                    bad = (got != want).any(1).nonzero()[:3, 0].tolist()
                    raise AssertionError(
                        f"kernel != plain at W={W} tmax={tmax} n={n} "
                        f"zdrop={zdrop}: rows {bad}: "
                        f"{got[bad].tolist()} vs {want[bad].tolist()}")
                ms = cuda_ms(kern, 20)
                plain_ms = cuda_ms(plain, 3)
                max_err = max(max_err, err)
                case = {"W": W, "tmax": tmax, "n": n, "zdrop": zdrop,
                        "equal": True, "ms": round(ms, 4),
                        "plain_ms": round(plain_ms, 3)}
                cases.append(case)
                if (W, tmax, n, zdrop) == (128, 256, 8192, 100):
                    main_shape = case
    desc = phase_desc(torch, np)
    print("[3 kernel==plain] " + json.dumps(
        {"tolerance": 0, "cases": cases, "desc": desc,
         "max_abs_err": max_err}),
        flush=True)
    return main_shape, max_err


def phase_kernel16(torch, np):
    """The int16 kernel against its plain version and K1's kernel on
    phase 3's job shapes (all inside the int16 domain: h0 < 60,
    qlen < 256), then the ported experiment with the counts set to 0
    just before it and read just after."""
    from tpubwa.opts import MemOpt
    from tpubwa_torch.device import extend_kernel as ek
    from tpubwa_torch.scripts import exp_int16_kernel as x16
    o = MemOpt()
    pen = (o.a, o.b, o.o_del, o.e_del, o.o_ins, o.e_ins)
    rng = np.random.default_rng(0x16)
    cases = []
    max_err = 0
    main_shape = None
    for W, tmax in ((128, 256), (256, 512)):
        for n in (512, 8192):
            for zdrop in (0, 100):
                q, t, p = (torch.from_numpy(x).to(DEV)
                           for x in make_jobs(rng, n, W, tmax))

                def kern():
                    return x16.extend_batch16(q, t, p, *pen, zdrop)

                def k1():
                    return ek.extend_batch(q, t, p, *pen, zdrop)

                def plain():
                    return x16.extend_batch16_plain(q, t, p, *pen, zdrop)

                def kern_alone():   # no input checks, no host sync
                    return x16._extend16_cuda(q, t, p, *pen, zdrop)

                def k1_alone():
                    return ek._extend_cuda(q, t, p, *pen, zdrop)
                got, want, ref = kern(), plain(), k1()
                torch.cuda.synchronize()
                err = max(int((got.long() - x.long()).abs().max())
                          for x in (want, ref))
                for other, x in (("plain", want), ("K1", ref)):
                    if not torch.equal(got, x):
                        bad = (got != x).any(1).nonzero()[:3, 0].tolist()
                        raise AssertionError(
                            f"int16 kernel != {other} at W={W} "
                            f"tmax={tmax} n={n} zdrop={zdrop}: rows {bad}: "
                            f"{got[bad].tolist()} vs {x[bad].tolist()}")
                case = {"W": W, "tmax": tmax, "n": n, "zdrop": zdrop,
                        "equal": True, "ms": round(cuda_ms(kern, 20), 4),
                        "k1_ms": round(cuda_ms(k1, 20), 4),
                        "kernel_alone_ms": round(cuda_ms(kern_alone, 20), 4),
                        "k1_alone_ms": round(cuda_ms(k1_alone, 20), 4),
                        "plain_ms": round(cuda_ms(plain, 3), 3)}
                max_err = max(max_err, err)
                cases.append(case)
                if (W, tmax, n, zdrop) == (128, 256, 8192, 100):
                    main_shape = case
    ek.extend_batch.launches = 0
    x16.extend_batch16.launches = 0
    res = x16.main(["--device", DEV, "--jobs", "512,1024,16384,131072"])
    launches = x16.extend_batch16.launches
    k1_launches = ek.extend_batch.launches
    if launches <= 0 or k1_launches <= 0:
        raise AssertionError("the int16 experiment launched "
                             f"{launches} int16 and {k1_launches} K1 "
                             "kernels")
    if res["fuzz_mismatches"] != 0 or res["fuzz_jobs"] != 1920:
        raise AssertionError(f"int16 fuzz: {res}")
    print("[3b int16 kernel==plain==K1] " + json.dumps(
        {"tolerance": 0, "cases": cases, "max_abs_err": max_err,
         "experiment": {"timing": [{k: round(v, 4) for k, v in r.items()}
                                   for r in res["timing"]],
                        "fuzz_jobs": res["fuzz_jobs"],
                        "fuzz_mismatches": res["fuzz_mismatches"],
                        "i16_launches": launches,
                        "k1_launches": k1_launches}}),
        flush=True)
    return main_shape, max_err, launches


def phase_desc(torch, np):
    """Descriptor extension (tile gather + four extension passes) with
    the kernel vs with the plain version on the card, on the
    adversarial descriptor set; both also vs the scalar oracle."""
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    from chip_desc_equality import materialize, mk_descs
    from tpubwa.index import FMIndex
    from tpubwa.opts import MemOpt
    from tpubwa.sim import make_bench_bnt
    from tpubwa_torch.device.extend_fused import (extend_seed_desc_np,
                                                  scalar_fused)
    from tpubwa_torch.device.extend_kernel import extend_batch_plain
    from tpubwa_torch.device.occ import DeviceIndex
    rng = np.random.default_rng(11)
    fmi = FMIndex.build(make_bench_bnt(400_000, rng, realistic=True))
    didx = DeviceIndex.from_fmindex(fmi, DEV)
    opt = MemOpt()
    mat = opt.scoring_matrix()
    rng = np.random.default_rng(0xD35C)
    B, L, n = 32, 100, 1024
    reads = rng.integers(0, 4, (B, L)).astype(np.uint8)
    text = fmi.bnt.doubled()
    for i in range(0, B, 2):   # genome-echo reads: high-score paths
        s = int(rng.integers(0, len(text) - L))
        reads[i] = text[s:s + L]
    reads[1, 40:42] = 4        # N codes in a query
    da = mk_descs(rng, fmi.bnt.l_pac, B, L, n - 128)
    # jobs that take the second band trial, on reads of their own
    r2, d2 = retry_descs(fmi.bnt, rng, 128, L)
    d2[:, 0] += B
    reads = np.concatenate([reads, r2])
    da = np.concatenate([da, d2])
    qd = torch.from_numpy(reads).to(DEV)
    args = (mat, opt.o_del, opt.e_del, opt.o_ins, opt.e_ins, opt.zdrop,
            512)
    got = extend_seed_desc_np(didx, qd, da, *args)
    want = extend_seed_desc_np(didx, qd, da, *args,
                               extend=extend_batch_plain)
    if not np.array_equal(got, want):
        bad = np.nonzero((got != want).any(1))[0][:3].tolist()
        raise AssertionError(f"descriptor kernel != plain at rows {bad}")
    n_oracle = 0
    for i in range(n):
        job = materialize(fmi.bnt, reads, da[i])
        ref = scalar_fused(job, mat, opt.o_del, opt.e_del, opt.o_ins,
                           opt.e_ins, opt.zdrop)
        ok = bool(got[i, 14] == ref[14] and got[i, 15] == ref[15])
        if job[0] > 0:
            ok &= (got[i, :6].tolist() == ref[:6].tolist()
                   and got[i, 12] == ref[12])
        if job[4] > 0:
            ok &= (got[i, 6:12].tolist() == ref[6:12].tolist()
                   and got[i, 13] == ref[13])
        if not ok:
            raise AssertionError(f"descriptor row {i} != scalar oracle: "
                                 f"{got[i].tolist()} vs {ref.tolist()}")
        n_oracle += 1
    retried = int(((got[:, 12] == 2 * da[:, 7])
                   | (got[:, 13] == 2 * da[:, 7])).sum())
    # a realistic wave: 4,096 descriptors over 1,024 reads
    rng = np.random.default_rng(7)
    reads = rng.integers(0, 4, (1024, L)).astype(np.uint8)
    wave = mk_descs(rng, fmi.bnt.l_pac, 1024, L, 4096)
    qd = torch.from_numpy(reads).to(DEV)
    ms = cuda_ms(lambda: extend_seed_desc_np(didx, qd, wave, *args), 10)
    plain_ms = cuda_ms(lambda: extend_seed_desc_np(
        didx, qd, wave, *args, extend=extend_batch_plain), 3)
    return {"n": n, "equal": True, "oracle_equal": n_oracle,
            "band_retries": retried, "wave4096_ms": round(ms, 3),
            "wave4096_plain_ms": round(plain_ms, 3)}


def phase_golden(torch):
    """`mem --device cuda` on the golden corpus: SE through
    `python -m tpubwa_torch` in a child process, PE through the CLI's
    main() in this process (so the kernel's launch count is visible)."""
    import tempfile
    from tpubwa_torch.cli import main as cli_main
    from tpubwa_torch.device import extend_kernel as ek
    gold = os.path.join(ROOT, "tests", "golden")
    os.makedirs(BUILD, exist_ok=True)
    res = {}
    with tempfile.TemporaryDirectory(dir=BUILD) as d:
        prefix = os.path.join(d, "g")
        assert cli_main(["index", os.path.join(gold, "ref.fa"), "-p",
                         prefix]) == 0
        mem = ["mem", "--device", DEV, prefix]
        subprocess.run([sys.executable, "-m", "tpubwa_torch", *mem,
                        os.path.join(gold, "se.fq"), "-o",
                        os.path.join(d, "se.sam")],
                       cwd=ROOT, check=True, capture_output=True)
        before = ek.extend_batch.launches
        assert cli_main([*mem, os.path.join(gold, "pe1.fq"),
                         os.path.join(gold, "pe2.fq"), "-o",
                         os.path.join(d, "pe.sam")]) == 0
        launched = ek.extend_batch.launches - before
        for name in ("se.sam", "pe.sam"):
            with open(os.path.join(d, name)) as fh:
                got = "".join(l for l in fh if not l.startswith("@PG"))
            with open(os.path.join(gold, name)) as fh:
                if got != fh.read():
                    raise AssertionError(f"golden {name} differs on {DEV}")
            res[name] = len(got.splitlines())
    if launched <= 0:
        raise AssertionError("golden PE mem never launched the kernel")
    print("[4 golden] " + json.dumps({"byte_equal": res,
                                      "pe_kernel_launches": launched}),
          flush=True)


def phase_main_path(torch, np):
    from tpubwa.host.pipeline import process_batches
    from tpubwa.opts import MEM_F_PE, MemOpt
    from tpubwa.sim import bench_index, simulate_pe
    from tpubwa_torch.device import extend_kernel as ek
    from tpubwa_torch.device.pipeline import make_device_aligner
    t0 = time.perf_counter()
    fmi = bench_index(GENOME_MB, realistic=True,
                      cache_dir=os.path.join(BUILD, "bench-cache"))
    index_s = time.perf_counter() - t0
    opt = MemOpt(flag=MEM_F_PE)
    rng = np.random.default_rng(1)
    aligner = make_device_aligner(opt, fmi, device=DEV)
    # warm-up batch (first use of every path), not timed
    warm = simulate_pe(fmi.bnt, 1024, 100, rng)
    for _ in process_batches(opt, fmi, iter([warm]), 0, align_fn=aligner):
        pass
    batches = [simulate_pe(fmi.bnt, PAIRS, 100, rng) for _ in range(2)]
    n_reads = sum(len(b) for b in batches)
    w0, j0 = aligner.extender.n_waves, aligner.extender.n_jobs
    ek.extend_batch.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    n_lines = n_mapped = 0
    for batch, lines in process_batches(opt, fmi, iter(batches), 0,
                                        align_fn=aligner):
        for line in lines:
            f = line.split("\t")
            if len(f) < 11:
                raise AssertionError(f"malformed SAM line: {line[:80]}")
            n_mapped += not int(f[1]) & 4
        n_lines += len(lines)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = ek.extend_batch.launches
    n_waves = aligner.extender.n_waves - w0
    n_jobs = aligner.extender.n_jobs - j0
    if launches <= 0:
        raise AssertionError("the main path never launched the kernel")
    if n_lines < n_reads or n_mapped < 0.8 * n_reads:
        raise AssertionError(f"{n_lines} SAM lines, {n_mapped} mapped "
                             f"for {n_reads} reads")
    # the first 512 pairs again: through the plain version on the CPU,
    # and through tpubwa's scalar host pipeline (align_fn=None, the
    # path tpubwa's own tests hold its device pipeline to)
    first = batches[0][:1024]
    cpu = make_device_aligner(opt, fmi, device="cpu")
    sam = {}
    for name, fn in ((DEV, aligner), ("cpu", cpu), ("scalar", None)):
        sam[name] = [l for _, lines in process_batches(
            opt, fmi, iter([first]), 0, align_fn=fn) for l in lines]
    for name in ("cpu", "scalar"):
        if sam[DEV] != sam[name]:
            raise AssertionError(f"first 512 pairs: {DEV} SAM != {name}")
    print("[5 main path] " + json.dumps({
        "genome": f"{GENOME_MB} Mbp repeat-realistic "
                  f"(tpubwa.sim.bench_index({GENOME_MB}, realistic=True))",
        "index_s": round(index_s, 1), "reads": n_reads,
        "seconds": round(dt, 3), "reads_per_s": round(n_reads / dt, 1),
        "sam_lines": n_lines, "mapped": n_mapped,
        "n_waves": n_waves, "n_jobs": n_jobs,
        "kernel_launches": launches,
        "cpu_and_scalar_equal_pairs": len(first) // 2}), flush=True)
    return launches


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        sys.stderr.write("chip_smoke: torch sees no CUDA device\n")
        return 2
    sys.path.insert(0, ROOT)
    # native host code builds inside the checkout, not under $HOME
    os.environ.setdefault("TPUBWA_NATIVE_CACHE",
                          os.path.join(BUILD, "native"))
    import numpy as np
    import tpubwa_torch  # noqa: F401  (fails outside a checkout)
    phase_toolchain(torch)
    phase_build()
    main_case, max_err = phase_kernel(torch, np)
    case16, err16, launches16 = phase_kernel16(torch, np)
    phase_golden(torch)
    launches = phase_main_path(torch, np)
    if "jax" in sys.modules:
        raise AssertionError("jax was imported")
    print(json.dumps({"kernels": [{
        "name": "ksw_extend", "route": "cuda",
        "source": "tpubwa_torch/csrc/extend.cu",
        "replaces": "tpubwa/device/extend_pallas.py:162",
        "launches": launches, "max_abs_err": max_err,
        "ms": main_case["ms"], "plain_ms": main_case["plain_ms"]}, {
        "name": "ksw_extend16", "route": "cuda",
        "source": "tpubwa_torch/csrc/extend16.cu",
        "replaces": "scripts/exp_int16_kernel.py:48",
        "launches": launches16, "max_abs_err": err16,
        "ms": case16["ms"], "plain_ms": case16["plain_ms"]}]}),
        flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

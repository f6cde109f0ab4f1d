"""tpubwa_torch command line: ``mem`` runs the PyTorch/CUDA aligner;
``index``, ``fastmap``, ``merge`` and ``shm`` touch no device (the
port's copies of tpubwa's, over the port's own host code).  Same
bwa-compatible flags as ``tpubwa mem``, with ``--device cuda|cpu``
(default ``cuda``: the CPU runs only when asked for).  ``mem --dist``
runs one record shard a process of a torch.distributed run (gloo), and
rank 0 merges the shards' SAM."""

from __future__ import annotations

import argparse
import contextlib
import logging
import sys
import time

from . import __version__
from .index.fmindex import FMIndex
from .io.fastq import FastqReader, read_fastq_batch
from .opts import (MEM_F_ALL, MEM_F_KEEP_SUPP_MAPQ, MEM_F_NOPAIRING,
                   MEM_F_NO_MULTI, MEM_F_NO_RESCUE, MEM_F_PE,
                   MEM_F_PRIMARY5, MEM_F_REF_HDR, MEM_F_SMARTPE,
                   MEM_F_SOFTCLIP, MemOpt, preset)

log = logging.getLogger("tpubwa")


def load_index(prefix: str, ignore_alt: bool = False) -> FMIndex:
    """bwa_idx_load equivalent: prefer the shm cache (mmap, shared page
    cache across processes), then our npz, then stock bwa index files
    (bwa.c:~260).  A ``<prefix>.alt`` file (bwa.kit ALT-contig list,
    SAM-ish lines whose first field is the contig name) marks anns as
    ALT, exactly as bwa_idx_load_from_disk does."""
    import os
    if os.path.isdir(prefix + ".tpubwa.shm"):
        fmi = FMIndex.load_shm(prefix)
    elif os.path.exists(prefix + ".tpubwa.npz"):
        fmi = FMIndex.load(prefix)
    elif os.path.exists(prefix + ".bwt"):
        fmi = FMIndex.load_bwa(prefix)
    else:
        raise FileNotFoundError(
            f"no index found at {prefix}[.tpubwa.npz|.bwt]")
    alt_path = prefix + ".alt"
    if ignore_alt:
        return fmi  # -j: ALT contigs are part of the primary assembly
    if os.path.exists(alt_path):
        names = set()
        with open(alt_path) as fh:
            for line in fh:
                line = line.strip()
                if line and not line.startswith("@"):
                    names.add(line.split("\t")[0].split()[0])
        n_alt = 0
        for a in fmi.bnt.anns:
            if a.name in names:
                a.is_alt = 1
                n_alt += 1
        log.info("[index] %d ALT contigs from %s", n_alt, alt_path)
    return fmi


def main_shm(argv) -> int:
    """bwa shm analogue (bwashm.c): `tpubwa shm ref.fa` materializes a
    raw mmap-able cache so concurrent processes share one resident
    index copy; `tpubwa shm -d ref.fa` drops it."""
    import os
    import shutil
    ap = argparse.ArgumentParser(prog="tpubwa_torch shm")
    ap.add_argument("-d", action="store_true", dest="drop",
                    help="drop the cache")
    ap.add_argument("prefix")
    args = ap.parse_args(argv)
    d = args.prefix + ".tpubwa.shm"
    if args.drop:
        if os.path.isdir(d):
            shutil.rmtree(d)
            log.info("[shm] dropped %s", d)
        return 0
    fmi = load_index(args.prefix)
    fmi.save_shm(args.prefix)
    log.info("[shm] cached %s (%d bp)", d, fmi.seq_len)
    return 0


def main_index(argv) -> int:
    ap = argparse.ArgumentParser(prog="tpubwa_torch index")
    ap.add_argument("-p", dest="prefix", default=None,
                    help="index name prefix")
    ap.add_argument("-a", dest="algo", default="auto",
                    choices=["auto", "is", "bwtsw", "rb2"],
                    help="SA construction algorithm (accepted for "
                         "bwa CLI compatibility; the C SA-IS builder "
                         "handles all genome sizes)")
    ap.add_argument("-b", dest="block_size", type=int, default=None,
                    help="accepted for bwa compatibility (unused)")
    ap.add_argument("--bwa-compat", action="store_true",
                    help="also write stock-bwa .pac/.ann/.amb/.bwt/.sa")
    ap.add_argument("fasta")
    args = ap.parse_args(argv)
    prefix = args.prefix or args.fasta
    t0 = time.time()
    fmi = FMIndex.from_fasta(args.fasta)
    fmi.save(prefix)
    if args.bwa_compat:
        fmi.save_bwa(prefix)
    log.info("[index] %d bp, %d sequences, %.2f s", fmi.bnt.l_pac,
             len(fmi.bnt.anns), time.time() - t0)
    return 0


def _add_mem_opts(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("-t", type=int, default=1, dest="n_threads")
    ap.add_argument("-k", type=int, default=19, dest="min_seed_len")
    ap.add_argument("-w", type=int, default=100, dest="band_width")
    ap.add_argument("-d", type=int, default=100, dest="zdrop")
    ap.add_argument("-r", type=float, default=1.5, dest="split_factor")
    ap.add_argument("-y", type=int, default=20, dest="max_mem_intv")
    ap.add_argument("-c", type=int, default=500, dest="max_occ")
    ap.add_argument("-D", type=float, default=0.50, dest="drop_ratio")
    ap.add_argument("-W", type=int, default=0, dest="min_chain_weight")
    ap.add_argument("-m", type=int, default=50, dest="max_matesw")
    ap.add_argument("-S", action="store_true", dest="skip_matesw")
    ap.add_argument("-P", action="store_true", dest="skip_pairing")
    ap.add_argument("-A", type=int, default=1, dest="match")
    ap.add_argument("-B", type=int, default=4, dest="mismatch")
    ap.add_argument("-O", default="6,6", dest="gap_open")
    ap.add_argument("-E", default="1,1", dest="gap_ext")
    ap.add_argument("-L", default="5,5", dest="clip_pen")
    ap.add_argument("-U", type=int, default=17, dest="pen_unpaired")
    ap.add_argument("-x", default=None, dest="preset")
    ap.add_argument("-p", action="store_true", dest="smart_pairing")
    ap.add_argument("-R", default=None, dest="rg_line")
    ap.add_argument("-T", type=int, default=30, dest="score_thres")
    ap.add_argument("-a", action="store_true", dest="output_all")
    ap.add_argument("-C", action="store_true", dest="append_comment")
    ap.add_argument("-Y", action="store_true", dest="softclip_supp")
    ap.add_argument("-M", action="store_true", dest="mark_short_split")
    # bwa >= 0.7.15 surface (the version this CLI is pinned to):
    ap.add_argument("-h", dest="xa_hits", default=None, metavar="INT[,INT]",
                    help="max XA hits to output [5,200]")
    ap.add_argument("-V", action="store_true", dest="ref_hdr",
                    help="output the reference FASTA header in the XR tag")
    ap.add_argument("-j", action="store_true", dest="ignore_alt",
                    help="treat ALT contigs as primary (ignore .alt file)")
    ap.add_argument("-5", action="store_true", dest="primary5",
                    help="smallest-coordinate split hit as primary "
                         "(implies -q)")
    ap.add_argument("-q", action="store_true", dest="keep_supp_mapq",
                    help="don't cap supplementary mapQ by the primary's")
    ap.add_argument("-H", dest="hdr_lines", action="append", default=None,
                    metavar="STR/@file",
                    help="insert STR to the header; if it starts with "
                         "@, treat as a file of header lines")
    ap.add_argument("-I", default=None, dest="insert_spec",
                    help="mean[,std[,max[,min]]] insert size override")
    ap.add_argument("-v", type=int, default=3, dest="verbosity")
    ap.add_argument("-K", type=int, default=None, dest="chunk_size")
    ap.add_argument("-o", default=None, dest="out_file")
    ap.add_argument("--shard", default=None,
                    help="I/N: process the I-th of N deterministic "
                         "record-range shards (manual multi-host mode)")
    ap.add_argument("--dist", action="store_true",
                    help="one shard a process of a torch.distributed "
                         "run (RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT "
                         "and LOCAL_RANK as torchrun sets them); rank 0 "
                         "merges the shards into -o")
    ap.add_argument("--journal", default=None,
                    help="checkpoint journal for resumable runs "
                         "(requires -o)")
    ap.add_argument("--metrics", default=None,
                    help="append JSONL metrics to this file")
    ap.add_argument("--profile-dir", default=None, dest="profile_dir",
                    help="write a torch.profiler trace here")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the seed extension runs: cuda (the "
                         "default; raises without a card) or cpu (the "
                         "plain PyTorch versions)")


def build_opt(args) -> MemOpt:
    kw = {}
    if args.preset:
        kw.update(preset(args.preset))
    o_del, o_ins = ([int(x) for x in (args.gap_open.split(",") * 2)[:2]])
    e_del, e_ins = ([int(x) for x in (args.gap_ext.split(",") * 2)[:2]])
    clip5, clip3 = ([int(x) for x in (args.clip_pen.split(",") * 2)[:2]])
    explicit = dict(
        n_threads=args.n_threads, min_seed_len=args.min_seed_len,
        w=args.band_width, zdrop=args.zdrop,
        split_factor=args.split_factor, max_mem_intv=args.max_mem_intv,
        max_occ=args.max_occ, drop_ratio=args.drop_ratio,
        min_chain_weight=args.min_chain_weight,
        max_matesw=args.max_matesw, a=args.match, b=args.mismatch,
        o_del=o_del, o_ins=o_ins, e_del=e_del, e_ins=e_ins,
        pen_clip5=clip5, pen_clip3=clip3,
        pen_unpaired=args.pen_unpaired, T=args.score_thres)
    # presets override only defaults the user did not set explicitly;
    # bwa applies presets after parsing with "changed" tracking — we
    # apply explicit values on top of presets, which matches when the
    # user doesn't contradict the preset
    kw.update({k: v for k, v in explicit.items()})
    if args.preset:
        defaults = MemOpt()
        for k, v in preset(args.preset).items():
            if explicit.get(k) == getattr(defaults, k):
                kw[k] = v
    flag = 0
    if args.output_all:
        flag |= MEM_F_ALL
    if args.skip_matesw:
        flag |= MEM_F_NO_RESCUE
    if args.skip_pairing:
        flag |= MEM_F_NOPAIRING
    if args.smart_pairing:
        flag |= MEM_F_SMARTPE
    if args.softclip_supp:
        flag |= MEM_F_SOFTCLIP
    if args.mark_short_split:
        flag |= MEM_F_NO_MULTI
    if getattr(args, "ref_hdr", False):
        flag |= MEM_F_REF_HDR
    if getattr(args, "primary5", False):
        # fastmap.c: -5 always applies MEM_F_KEEP_SUPP_MAPQ too
        flag |= MEM_F_PRIMARY5 | MEM_F_KEEP_SUPP_MAPQ
    if getattr(args, "keep_supp_mapq", False):
        flag |= MEM_F_KEEP_SUPP_MAPQ
    kw["flag"] = flag
    if getattr(args, "xa_hits", None):
        parts = [int(x) for x in args.xa_hits.split(",")]
        kw["max_XA_hits"] = parts[0]
        kw["max_XA_hits_alt"] = parts[1] if len(parts) > 1 else parts[0]
    if args.chunk_size:
        kw["chunk_size"] = args.chunk_size
    return MemOpt(**kw)


def _parse_rg_id(rg_line: str) -> str:
    for fld in rg_line.replace("\\t", "\t").split("\t"):
        if fld.startswith("ID:"):
            return fld[3:]
    return ""


def parse_insert_spec(spec: str):
    """-I mean[,std[,max[,min]]] -> fixed FR insert distribution
    (fastmap.c:~170 semantics: std defaults to 10% of mean, high/low
    default to mean +- 4*std)."""
    from .host.pair import PEStat
    parts = [float(x) for x in spec.split(",")]
    pes = [PEStat() for _ in range(4)]
    fr = pes[1]
    fr.failed = 0
    fr.avg = parts[0]
    fr.std = parts[1] if len(parts) > 1 else fr.avg * 0.1
    fr.high = int(parts[2] + 0.499) if len(parts) > 2 \
        else int(fr.avg + 4.0 * fr.std + 0.499)
    fr.low = int(parts[3] + 0.499) if len(parts) > 3 \
        else max(int(fr.avg - 4.0 * fr.std + 0.499), 1)
    return pes


@contextlib.contextmanager
def _cpu_threads(device, n):
    """bwa's -t on the CPU: torch's intra-op pool, which runs the plain
    kernels' tensor ops, capped at ``n`` threads for the run and restored
    after.  Beside other busy processes a larger pool's threads wait on
    each other far longer than they work.  A card's run is untouched."""
    if device.type != "cpu":
        yield
        return
    import torch
    before = torch.get_num_threads()
    torch.set_num_threads(max(1, n))
    try:
        yield
    finally:
        torch.set_num_threads(before)


@contextlib.contextmanager
def _profile(trace_dir):
    """torch.profiler trace of the run (CPU, plus CUDA when a card is
    visible), written as a Chrome trace under ``trace_dir``."""
    if not trace_dir:
        yield
        return
    import os
    import torch
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield
    path = os.path.join(trace_dir, f"tpubwa_torch-{os.getpid()}.json")
    prof.export_chrome_trace(path)
    log.info("[profile] trace written to %s", path)


def main_mem(argv, out=None) -> int:
    # add_help=False: bwa's -h is the XA-cap option; use --help
    ap = argparse.ArgumentParser(prog="tpubwa_torch mem", add_help=False)
    ap.add_argument("--help", action="help")
    _add_mem_opts(ap)
    ap.add_argument("prefix")
    ap.add_argument("reads")
    ap.add_argument("mates", nargs="?", default=None)
    args = ap.parse_args(argv)
    if args.dist and not args.out_file:
        ap.error("--dist requires -o")
    if args.dist and args.shard:
        ap.error("--dist computes shards from process_index; "
                 "drop --shard")
    # no fallback: a device that cannot be had raises before any work
    from .device.pipeline import make_device_aligner, resolve_device
    device = resolve_device(args.device)
    opt = build_opt(args)
    dist_ctx = None
    if args.dist:
        # SURVEY.md §5.8: a shard a process, computed from the rank, its
        # own SAM file, the merge on rank 0
        device, dist_ctx = _dist_init(device, [args.reads] + (
            [args.mates] if args.mates else []), args.out_file)
        args.shard = f"{dist_ctx[0]}/{dist_ctx[1]}"
        args.out_file = f"{args.out_file}.shard{dist_ctx[0]:05d}"
        log.info("[dist] process %d/%d -> %s", dist_ctx[0], dist_ctx[1],
                 args.out_file)
    # -v: bwa verbosity levels 1=err 2=warn 3=info 4+=debug
    log.setLevel({1: logging.ERROR, 2: logging.WARNING}.get(
        args.verbosity, logging.INFO if args.verbosity == 3
        else logging.DEBUG))
    close_out = False
    if out is None:
        if args.out_file:
            # journaled runs must not clobber a resumable output
            out = open(args.out_file, "a" if args.journal else "w")
            close_out = True
        else:
            out = sys.stdout
    fmi = load_index(args.prefix, ignore_alt=args.ignore_alt)
    from .host.pipeline import process_batches, sam_header

    paired = args.mates is not None or args.smart_pairing
    if paired:
        opt = opt.replace(flag=opt.flag | MEM_F_PE)
    rg_id = _parse_rg_id(args.rg_line) if args.rg_line else ""
    cl = "tpubwa_torch mem " + " ".join(argv)
    from .utils import Journal, MetricsWriter, StageTimers
    timers = StageTimers()
    metrics = MetricsWriter(args.metrics)
    journal = None
    if args.journal:
        if not args.out_file:
            ap.error("--journal requires -o")
        journal = Journal.load(args.journal)
        out.close()
        keep = max(journal.bytes_done, 0)
        with open(args.out_file, "a"):
            pass  # ensure it exists
        with open(args.out_file, "r+") as fh:
            fh.truncate(keep)
        out = open(args.out_file, "a")
        if journal.bytes_done >= 0:
            log.info("[resume] %d batches (%d reads) already done",
                     journal.done_batches, journal.reads_done)
    if journal is None or journal.bytes_done < 0:
        hdr_extra = []
        for h in args.hdr_lines or []:
            if h.startswith("@"):
                hdr_extra.append(h)
            else:  # a file of header lines (fastmap.c -H semantics)
                with open(h) as fh:
                    hdr_extra += [l.rstrip("\n") for l in fh
                                  if l.strip()]
        out.write(sam_header(fmi, args.rg_line, cl, __version__,
                             hdr_lines=hdr_extra))

    pes0 = parse_insert_spec(args.insert_spec) if args.insert_spec \
        else None
    if args.shard:
        shard_i, shard_n = (int(x) for x in args.shard.split("/"))
        from .dist.records import shard_readers
        readers = shard_readers([args.reads] +
                                ([args.mates] if args.mates else []),
                                shard_i, shard_n)
    else:
        readers = [FastqReader(args.reads)]
        if args.mates:
            readers.append(FastqReader(args.mates))
    align_fn = make_device_aligner(opt, fmi, device=device)
    log.info("[tpubwa_torch] extension on %s", align_fn.device)
    # a shard counts its reads from its first record's global index, so
    # that mark_primary's read ids and the pair ids (the tie-breaks)
    # equal the unsharded run's
    base_offset = getattr(readers[0], "global_offset", 0)
    n_processed = base_offset
    chunk = opt.chunk_size * opt.n_threads
    t0 = time.time()
    batch_id = 0
    skipped = 0
    resume_reads = journal.reads_done if journal is not None else 0

    def batch_source():
        while True:
            with timers.stage("read"):
                b = read_fastq_batch(readers, chunk,
                                     smart_pairing=args.smart_pairing)
            if not b:
                return
            yield b

    with _profile(args.profile_dir), _cpu_threads(device,
                                                  opt.n_threads):
        src = batch_source()
        # journal resume: skip whole completed batches
        while journal is not None and skipped < resume_reads:
            b = next(src, None)
            if b is None:
                break
            skipped += len(b)
            n_processed += len(b)
            batch_id += 1
        for batch, lines in process_batches(
                opt, fmi, src, n_processed, rg_id=rg_id,
                align_fn=align_fn, pes0=pes0):
            with timers.stage("write"):
                out.write("\n".join(lines) + "\n")
                out.flush()
            n_processed += len(batch)
            done = n_processed - base_offset
            rate = done / (time.time() - t0)
            log.info("[M::mem] processed %d reads (%.1f reads/s)",
                     done, rate)
            metrics.emit(event="batch", batch=batch_id,
                         reads=len(batch), reads_per_s=round(rate, 1))
            if journal is not None:
                journal.mark(batch_id, done, out.tell())
            batch_id += 1
    for r in readers:
        r.close()
    log.info("[M::mem] stage times: %s", timers.report())
    log.info("%s", timers.final_lines())
    metrics.emit(event="done", reads=n_processed - base_offset,
                 **{k: round(v, 3) for k, v in timers.wall.items()})
    if close_out:
        out.close()
    if dist_ctx is not None:
        _dist_finish(dist_ctx, n_processed - base_offset,
                     time.time() - t0, metrics)
    metrics.close()
    return 0


def _dist_init(device, inputs, out_file):
    """Join the torch.distributed run that ``torchrun`` (or the caller)
    describes in RANK, WORLD_SIZE, MASTER_ADDR and MASTER_PORT, over
    gloo: its one collective is the end-of-run gather of host counters,
    and NCCL refuses two ranks on one card.  On a card the process takes
    cuda:(LOCAL_RANK mod the cards).  Rank 0 writes each input's record
    sidecar before a barrier, so that no two ranks build it at once.
    Returns (device, (rank, world size, out_file))."""
    import os
    import torch
    import torch.distributed as tdist
    from .dist.records import ensure_sidecar
    tdist.init_process_group("gloo", init_method="env://")
    rank, world = tdist.get_rank(), tdist.get_world_size()
    if device.type == "cuda":
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0))
                              % torch.cuda.device_count())
        torch.cuda.set_device(device)
    if rank == 0:
        for path in inputs:
            ensure_sidecar(path)
    tdist.barrier()
    return device, (rank, world, out_file)


def _dist_finish(dist_ctx, done, wall, metrics):
    """The end of a --dist run: a gather of every rank's [reads, wall
    ms] and a barrier; then rank 0 merges the shards into the output
    and emits ``dist_done``."""
    import torch
    import torch.distributed as tdist
    rank, world, final_out = dist_ctx
    mine = torch.tensor([done, wall * 1000.0], dtype=torch.float64)
    counters = [torch.zeros(2, dtype=torch.float64) for _ in range(world)]
    tdist.all_gather(counters, mine)
    tdist.barrier()
    if rank == 0:
        shards = [f"{final_out}.shard{i:05d}" for i in range(world)]
        main_merge(["-o", final_out] + shards)
        counters = torch.stack(counters)
        total = int(counters[:, 0].sum())
        rate = total / max(float(counters[:, 1].max()) / 1000.0, 1e-9)
        log.info("[dist] merged %d shards -> %s: %d reads, %.1f reads/s "
                 "aggregate", world, final_out, total, rate)
        metrics.emit(event="dist_done", processes=world, reads=total,
                     reads_per_s=round(rate, 1),
                     per_host=[int(x) for x in counters[:, 0]])
    tdist.destroy_process_group()


def main_merge(argv) -> int:
    """Deterministic shard merge: bodies concatenated in argument
    order under the first shard's header (SURVEY.md §5.8)."""
    ap = argparse.ArgumentParser(prog="tpubwa_torch merge")
    ap.add_argument("-o", dest="out_file", default=None)
    ap.add_argument("shards", nargs="+")
    args = ap.parse_args(argv)
    out = open(args.out_file, "w") if args.out_file else sys.stdout
    with open(args.shards[0]) as fh:
        for line in fh:
            if line.startswith("@"):
                out.write(line)
            else:
                break
    for path in args.shards:
        with open(path) as fh:
            for line in fh:
                if not line.startswith("@"):
                    out.write(line)
    if args.out_file:
        out.close()
    return 0


def main_fastmap(argv, out=None) -> int:
    """SMEM dump (fastmap.c:main_fastmap; SURVEY.md §2 row 23)."""
    ap = argparse.ArgumentParser(prog="tpubwa_torch fastmap")
    ap.add_argument("-l", type=int, default=17, dest="min_len")
    ap.add_argument("-w", type=int, default=20, dest="max_print")
    ap.add_argument("prefix")
    ap.add_argument("reads")
    args = ap.parse_args(argv)
    out = out if out is not None else sys.stdout
    fmi = load_index(args.prefix)
    opt = MemOpt(min_seed_len=args.min_len, max_mem_intv=0)
    from .ref.smem import collect_intv, sa_positions
    for read in FastqReader(args.reads):
        out.write(f"SQ\t{read.name}\t{read.l_seq}\n")
        for m in collect_intv(opt, fmi, read.seq):
            out.write(f"EM\t{m.qb}\t{m.qe}\t{m.size}")
            if m.size <= args.max_print:
                for rbeg, _rank in sa_positions(fmi, m, m.size):
                    fpos, is_rev = fmi.bnt.depos(
                        rbeg if rbeg < fmi.bnt.l_pac
                        else rbeg + (m.qe - m.qb) - 1)
                    rid = fmi.bnt.pos2rid(fpos)
                    out.write(f"\t{fmi.bnt.anns[rid].name}:"
                              f"{'+-'[is_rev]}{fpos - fmi.bnt.anns[rid].offset + 1}")
            else:
                out.write("\t*")
            out.write("\n")
        out.write("//\n")
    return 0


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    logging.basicConfig(level=logging.INFO,
                        format="[%(levelname).1s::%(name)s] %(message)s",
                        stream=sys.stderr)
    commands = {"index": main_index, "mem": main_mem,
                "fastmap": main_fastmap, "merge": main_merge,
                "shm": main_shm}
    if not argv or argv[0] not in commands:
        sys.stderr.write(
            f"Program: tpubwa_torch (BWA-MEM on PyTorch/CUDA)\n"
            f"Version: {__version__}\n"
            "Usage: tpubwa_torch <index|mem|fastmap|merge|shm> "
            "[options]\n")
        return 1
    return commands[argv[0]](argv[1:])


if __name__ == "__main__":
    sys.exit(main())

"""tpubwa_torch command line: ``mem`` runs the PyTorch/CUDA aligner;
``index``, ``fastmap``, ``merge`` and ``shm`` are tpubwa's own (they
touch no device).  Same bwa-compatible flags as ``tpubwa mem``, with
``--device auto|cuda|cpu``."""

from __future__ import annotations

import argparse
import contextlib
import logging
import sys
import time

from tpubwa.cli import (_add_mem_opts, _parse_rg_id, build_opt,
                        load_index, main_fastmap, main_index, main_merge,
                        main_shm, parse_insert_spec)
from tpubwa.io.fastq import FastqReader, read_fastq_batch
from tpubwa.opts import MEM_F_PE

from . import __version__

log = logging.getLogger("tpubwa")


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
    # add_help=False: bwa's -h is the XA-cap option; use --help.
    # conflict_handler: the port replaces tpubwa's --device choices
    ap = argparse.ArgumentParser(prog="tpubwa_torch mem", add_help=False,
                                 conflict_handler="resolve")
    ap.add_argument("--help", action="help")
    _add_mem_opts(ap)
    ap.add_argument("--device", default="auto",
                    choices=["auto", "cuda", "cpu"],
                    help="where the seed extension runs (auto: cuda when "
                         "a card is visible)")
    ap.add_argument("--profile-dir", default=None, dest="profile_dir",
                    help="write a torch.profiler trace here")
    ap.add_argument("prefix")
    ap.add_argument("reads")
    ap.add_argument("mates", nargs="?", default=None)
    args = ap.parse_args(argv)
    if args.dist:
        raise NotImplementedError("--dist needs multi-GPU support "
                                  "(ROADMAP Queue 1 item 7)")
    if args.shard:
        raise NotImplementedError("--shard needs the record sharding of "
                                  "tpubwa.dist (ROADMAP Queue 1 item 7)")
    opt = build_opt(args)
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
    from tpubwa.host.pipeline import process_batches, sam_header

    paired = args.mates is not None or args.smart_pairing
    if paired:
        opt = opt.replace(flag=opt.flag | MEM_F_PE)
    rg_id = _parse_rg_id(args.rg_line) if args.rg_line else ""
    cl = "tpubwa_torch mem " + " ".join(argv)
    from tpubwa.utils import Journal, MetricsWriter, StageTimers
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
    readers = [FastqReader(args.reads)]
    if args.mates:
        readers.append(FastqReader(args.mates))
    # no fallback: a device that cannot be had raises here
    from .device.pipeline import make_device_aligner
    align_fn = make_device_aligner(opt, fmi, device=args.device)
    log.info("[tpubwa_torch] extension on %s", align_fn.device)
    n_processed = 0
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

    with _profile(args.profile_dir):
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
            rate = n_processed / (time.time() - t0)
            log.info("[M::mem] processed %d reads (%.1f reads/s)",
                     n_processed, rate)
            metrics.emit(event="batch", batch=batch_id,
                         reads=len(batch), reads_per_s=round(rate, 1))
            if journal is not None:
                journal.mark(batch_id, n_processed, out.tell())
            batch_id += 1
    for r in readers:
        r.close()
    log.info("[M::mem] stage times: %s", timers.report())
    log.info("%s", timers.final_lines())
    metrics.emit(event="done", reads=n_processed,
                 **{k: round(v, 3) for k, v in timers.wall.items()})
    if close_out:
        out.close()
    metrics.close()
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

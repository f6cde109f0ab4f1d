"""Observability + checkpoint/resume (SURVEY.md §5.1, §5.4, §5.5).

The reference's tracing is stderr '[M::func]' progress lines and final
real/CPU timers (utils.c:cputime/realtime, fastmap.c:~340); here the
same greppable style is kept, plus structured per-stage timers and an
optional JSONL metrics stream (the port's CLI has its own torch.profiler
hook, ``cli._profile``).

Checkpoint/resume (absent in the reference — reruns from scratch) is
batch-granular: a journal records (batch_id, reads consumed, bytes
written); resume truncates the output to the last complete batch and
skips the consumed reads.  State is nothing but the index, so this is
cheap and exact.
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import resource
import time
from dataclasses import dataclass, field
from typing import Dict, Optional

log = logging.getLogger("tpubwa")


def serial_pipeline() -> bool:
    """True when the chunk/batch prefetch threads should be disabled
    (single shared helper for host/pipeline.py and device/pipeline.py
    — ADVICE round-2 items 1-2).

    TPUBWA_NO_PREFETCH forces the choice: '0'/'false'/'no'/'off' keeps
    the overlap threads; any other non-empty value forces serial.
    Unset -> auto: serial when the process has ONE usable core.  Uses
    sched_getaffinity (the cores this process may actually run on),
    not cpu_count (visible CPUs) — a cgroup/affinity-pinned container
    can show many CPUs while being allocated one."""
    pf = os.environ.get("TPUBWA_NO_PREFETCH")
    if pf is not None and pf.strip():
        return pf.strip().lower() not in ("0", "false", "no", "off")
    try:
        n = len(os.sched_getaffinity(0))
    except (AttributeError, OSError):  # pragma: no cover - non-Linux
        n = os.cpu_count() or 1
    return n <= 1


def cputime() -> float:
    """utils.c:cputime — user+sys seconds of this process."""
    ru = resource.getrusage(resource.RUSAGE_SELF)
    return ru.ru_utime + ru.ru_stime


@dataclass
class StageTimers:
    """Accumulating per-stage wall timers + counters."""
    wall: Dict[str, float] = field(default_factory=dict)
    counts: Dict[str, float] = field(default_factory=dict)
    t_start: float = field(default_factory=time.time)
    cpu_start: float = field(default_factory=cputime)

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.wall[name] = self.wall.get(name, 0.0) \
                + time.perf_counter() - t0

    def bump(self, name: str, n: float = 1) -> None:
        self.counts[name] = self.counts.get(name, 0) + n

    def report(self) -> str:
        parts = [f"{k}={v:.2f}s" for k, v in sorted(self.wall.items())]
        parts += [f"{k}={v:g}" for k, v in sorted(self.counts.items())]
        return " ".join(parts)

    def final_lines(self) -> str:
        """bwa's closing '[main] Real time: ...' format."""
        return (f"[main] Real time: {time.time() - self.t_start:.3f} sec; "
                f"CPU: {cputime() - self.cpu_start:.3f} sec")


class MetricsWriter:
    """Optional JSONL metrics stream (reads/s, GCUPS, wave occupancy)."""

    def __init__(self, path: Optional[str]):
        self.fh = open(path, "a") if path else None

    def emit(self, **kv) -> None:
        if self.fh:
            kv.setdefault("ts", time.time())
            self.fh.write(json.dumps(kv) + "\n")
            self.fh.flush()

    def close(self):
        if self.fh:
            self.fh.close()


class Journal:
    """Batch-granular checkpoint journal for resumable runs.

    Line format (JSONL): {"batch": i, "reads": n_consumed_after,
    "bytes": out_bytes_after}.  A line is written only after the
    batch's SAM text is flushed, so the journal never runs ahead of
    the output file."""

    def __init__(self, path: str):
        self.path = path
        self.done_batches = 0
        self.reads_done = 0
        self.bytes_done = -1  # -1: no journal yet (keep header)

    @classmethod
    def load(cls, path: str) -> "Journal":
        j = cls(path)
        if os.path.exists(path):
            with open(path) as fh:
                for line in fh:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        rec = json.loads(line)
                    except json.JSONDecodeError:
                        break  # torn write: resume from last good line
                    j.done_batches = rec["batch"] + 1
                    j.reads_done = rec["reads"]
                    j.bytes_done = rec["bytes"]
        return j

    def mark(self, batch: int, reads: int, nbytes: int) -> None:
        with open(self.path, "a") as fh:
            fh.write(json.dumps(
                {"batch": batch, "reads": reads, "bytes": nbytes}) + "\n")
            fh.flush()
            os.fsync(fh.fileno())
        self.done_batches = batch + 1
        self.reads_done = reads
        self.bytes_done = nbytes

"""Data-parallel scaling (SURVEY.md §2.2, §5.8), the counterpart of
tpubwa/dist/sharding.py.

* Several processes: deterministic FASTQ byte ranges, and the merge of
  per-shard SAM files.  Every host computes the same shards from the
  file alone, so no collective is needed for correctness: each writes
  its shards' SAM, and the bodies are concatenated in shard order.
  These are the JAX-free helpers of tpubwa/dist/sharding.py, copied
  verbatim.
* Several devices in one process: ``DataParallel``, ported rather than
  copied (tpubwa's wraps a JAX ``Mesh``).  The FM-index is replicated,
  one ``DeviceIndex`` a replica, and the read and job axes are split
  into contiguous parts, one a replica; each part runs on a worker
  thread of its own, on a CUDA stream of its replica's, so that the
  wrappers' synchronising copies do not put the cards one after the
  other.  Results are per row, so the parts need no padding.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor, wait
from typing import Callable, List, Sequence, Tuple

import numpy as np
import torch

from ..device import counts


def byte_range_shards(path: str, n_shards: int) -> List[Tuple[int, int]]:
    """Split a PLAIN (non-gz) FASTQ into n byte ranges snapped to record
    boundaries: each shard starts at the first '@' header line at or
    after its nominal offset.  Deterministic for any reader count."""
    size = os.path.getsize(path)
    nominal = [size * i // n_shards for i in range(n_shards)] + [size]
    starts = []
    with open(path, "rb") as fh:
        for off in nominal[:-1]:
            starts.append(_snap_to_record(fh, off, size))
    # degenerate shards (snapped past the next) become empty
    out = []
    for i in range(n_shards):
        lo = starts[i]
        hi = starts[i + 1] if i + 1 < n_shards else size
        out.append((lo, max(hi, lo)))
    return out


def _snap_to_record(fh, off: int, size: int) -> int:
    """First FASTQ record start at or after off.  A line starting with
    '@' is a header iff two lines later comes '+' (quality lines can
    also start with '@')."""
    if off == 0:
        return 0
    fh.seek(off)
    fh.readline()  # discard partial line
    while True:
        pos = fh.tell()
        line = fh.readline()
        if not line:
            return size
        if line.startswith(b"@"):
            fh.readline()            # seq
            plus = fh.readline()
            if plus.startswith(b"+"):
                return pos
            fh.seek(pos)
            fh.readline()
        # else keep scanning


def fastq_shard_reader(path: str, lo: int, hi: int):
    """Iterate reads of byte range [lo, hi) of a plain FASTQ.  A record
    whose header starts at < hi is fully consumed even if it crosses hi
    (ranges from byte_range_shards are record-aligned)."""
    from ..io.fastq import Read, encode_seq
    with open(path, "rb") as fh:
        fh.seek(lo)
        while fh.tell() < hi:
            hdr = fh.readline()
            if not hdr:
                break
            if not hdr.startswith(b"@"):
                raise ValueError(f"shard not record-aligned at {lo}")
            seq = fh.readline().rstrip()
            fh.readline()
            qual = fh.readline().rstrip()
            h = hdr[1:].rstrip().split(None, 1)
            yield Read(name=h[0].decode(), seq=encode_seq(seq),
                       qual=qual.decode() if qual else None,
                       comment=h[1].decode() if len(h) > 1 else "")


def plan_shards(path: str, process_index: int, process_count: int,
                shards_per_process: int = 1) -> List[Tuple[int, int, int]]:
    """(shard_id, lo, hi) list owned by this process — computed
    independently and identically on every host (no communication)."""
    total = process_count * shards_per_process
    ranges = byte_range_shards(path, total)
    return [(i, *ranges[i]) for i in range(total)
            if i % process_count == process_index]


def merge_shard_files(shard_paths: Sequence[str], out_path: str,
                      header: str = "") -> None:
    """Deterministic SAM merge: concatenate per-shard bodies in shard
    order (shard_paths must be pre-sorted by shard_id)."""
    with open(out_path, "w") as out:
        if header:
            out.write(header)
        for p in shard_paths:
            with open(p) as fh:
                for line in fh:
                    if not line.startswith("@"):
                        out.write(line)


# ---------------------------------------------------------------------
# Device-level sharding: replicas of the index, the job axis split
# ---------------------------------------------------------------------

def resolve(d) -> torch.device:
    """``d`` as a torch.device; 'cuda' without an index is the current
    card.  Raises where torch sees no card, and for a type other than
    cuda and cpu."""
    d = torch.device(d)
    if d.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {d} requested but torch sees no "
                               "CUDA device")
        if d.index is None:
            d = torch.device("cuda", torch.cuda.current_device())
    elif d.type != "cpu":
        raise ValueError(f"unsupported device {d}")
    return d


class DataParallel:
    """Replicas of the aligner's device state over ``devices`` (a list of
    ``torch.device``; one may be named more than once, so that one card
    runs several replicas), and the map that runs a part on each.

    ``tally[i]`` is replica i's: ``reads`` seeded, ``ranks`` walked and
    ``jobs`` extended (``note``), and ``"<function>.<count>"`` for each
    kernel launch a wrapper made in one of its parts (``device/counts``).
    Its worker threads live until ``close``."""

    def __init__(self, devices: Sequence):
        devices = [resolve(d) for d in devices]
        if not devices:
            raise ValueError("DataParallel needs at least one device")
        self.devices = devices
        # one stream a replica, made once; None on the CPU
        self.streams = [torch.cuda.Stream(d) if d.type == "cuda" else None
                        for d in devices]
        self.tally = [{} for _ in devices]
        self._pool = ThreadPoolExecutor(max_workers=len(devices),
                                        thread_name_prefix="tpubwa-dp")

    @classmethod
    def over(cls, devices=None) -> "DataParallel":
        """Over ``devices``, by default every visible CUDA device; raises
        where torch sees none (it never picks the CPU)."""
        if devices is None:
            n = torch.cuda.device_count() if torch.cuda.is_available() \
                else 0
            if not n:
                raise RuntimeError("DataParallel.over(): torch sees no "
                                   "CUDA device")
            devices = [torch.device("cuda", i) for i in range(n)]
        return cls(devices)

    @property
    def n(self) -> int:
        return len(self.devices)

    def split(self, m: int) -> List[Tuple[int, int]]:
        """Contiguous (lo, hi) bounds, one a replica in order, covering
        range(m) exactly; sizes differ by one at most, and a part may
        be empty."""
        return [(m * i // self.n, m * (i + 1) // self.n)
                for i in range(self.n)]

    def map(self, fn: Callable, parts: Sequence) -> list:
        """[fn(i, parts[i]) for each replica i], each on a worker thread
        and, on a card, on replica i's stream.  Waits for every part;
        then the first exception, in replica order, propagates."""
        parts = list(parts)
        if len(parts) != self.n:
            raise ValueError(f"{len(parts)} parts for {self.n} replicas")
        futs = [self._pool.submit(self._run, i, fn, p)
                for i, p in enumerate(parts)]
        wait(futs)
        return [f.result() for f in futs]

    def _run(self, i, fn, part):
        with counts.tallying(self.tally[i]):
            if self.streams[i] is None:
                return fn(i, part)
            with torch.cuda.stream(self.streams[i]):
                return fn(i, part)

    def map_rows(self, run: Callable, n: int, key: str) -> np.ndarray:
        """``run(i, lo, hi)`` (an array of hi - lo rows) for each
        replica's part of range(n), n > 0, concatenated in order; an
        empty part runs nothing, and each part's rows go to its tally
        of ``key``."""
        def part(i, bounds):
            lo, hi = bounds
            if hi == lo:
                return None
            self.note(i, key, hi - lo)
            return run(i, lo, hi)

        return np.concatenate([r for r in self.map(part, self.split(n))
                               if r is not None])

    def note(self, i: int, key: str, n: int) -> None:
        """Add ``n`` to replica i's tally of ``key``."""
        counts.add(self.tally[i], key, n)

    def replicate_index(self, fmi) -> list:
        """One ``DeviceIndex`` of ``fmi`` a replica (its FM arrays go up
        at first use, on the replica's stream)."""
        from ..device.occ import DeviceIndex
        out = [DeviceIndex.from_fmindex(fmi, d) for d in self.devices]
        self.synchronize()
        return out

    def replicate(self, a: np.ndarray) -> list:
        """One tensor of ``a`` a replica, each uploaded on its stream."""
        a = torch.from_numpy(np.ascontiguousarray(a))
        return self.map(lambda i, _: a.to(self.devices[i]), [None] * self.n)

    def close(self) -> None:
        """Stop the worker threads (after the parts they run)."""
        self._pool.shutdown(wait=True)

    def synchronize(self) -> None:
        """Wait for every card of the replicas."""
        for d in dict.fromkeys(self.devices):
            if d.type == "cuda":
                torch.cuda.synchronize(d)

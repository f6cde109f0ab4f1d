"""Host-level sharding: deterministic FASTQ byte ranges, and the merge
of per-shard SAM files (SURVEY.md §5.8).

Every host computes the same shards from the file alone, so no
collective is needed for correctness: each writes its shards' SAM, and
the bodies are concatenated in shard order.  These are the JAX-free
helpers of tpubwa/dist/sharding.py, copied verbatim; its data-parallel
mesh wrapper belongs to multi-GPU data parallelism (ROADMAP Queue 1
[dist]).
"""

from __future__ import annotations

import os
from typing import List, Sequence, Tuple


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

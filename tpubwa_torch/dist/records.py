"""Record-range sharding for paired/gz FASTQ inputs (SURVEY.md §5.8).

Byte-range sharding (sharding.py) is fastest for one plain FASTQ, but
paired files need CONSISTENT record ranges across both mates and gz
streams can't seek.  This module shards by record index: shard i of N
owns records [i*n/N, (i+1)*n/N) where n is counted once — identical
arithmetic on every host, no communication.

A sidecar file (<path>.tpubwa.fai, JSON) caches the record count plus
decompressed-byte offsets of every EVERY-th record, so opening shard
i/N costs one seek (plain) or one forward-inflate (gz) plus < EVERY
record parses — instead of parsing i*n/N records per host per run
(hours at WGS scale).  The sidecar is built on first use in one
streaming pass and invalidated by (size, mtime).
"""

from __future__ import annotations

import gzip
import json
import os
from typing import List, Optional

from ..io.fastq import FastqReader, Read

SIDECAR_EVERY = 4096


def _sidecar_path(path: str) -> str:
    return str(path) + ".tpubwa.fai"


def build_sidecar(path: str, every: int = SIDECAR_EVERY) -> dict:
    """One streaming pass: record count + offsets (in the DECOMPRESSED
    byte stream) of records 0, every, 2*every, ...  Dense offsets are
    recorded only for strict 4-line FASTQ (the overwhelmingly common
    case); otherwise just the count is cached and shard opening falls
    back to parse-skip."""
    op = gzip.open if str(path).endswith(".gz") else open
    n_lines = 0
    off = 0            # decompressed bytes consumed from the stream
    offsets: List[int] = []
    fourline = True
    fasta = False
    first = True
    n_fasta = 0
    carry = b""        # partial line split by a chunk boundary
    with op(path, "rb") as fh:
        while True:
            chunk = fh.read(1 << 20)
            if not chunk:
                break
            data = carry + chunk
            base = off - len(carry)   # stream offset of data[0]
            pos = 0
            while True:
                nl = data.find(b"\n", pos)
                if nl < 0:
                    break
                ch = data[pos:pos + 1]
                if first:
                    fasta = ch == b">"
                    first = False
                if fasta:
                    if ch == b">":
                        n_fasta += 1
                else:
                    r = n_lines & 3
                    if r == 0:
                        if ch != b"@":
                            fourline = False
                        elif fourline and (n_lines >> 2) % every == 0:
                            offsets.append(base + pos)
                    elif r == 2 and ch != b"+":
                        fourline = False
                n_lines += 1
                pos = nl + 1
            carry = data[pos:]
            off += len(chunk)
    if carry:  # unterminated trailing line
        if fasta:
            if carry[:1] == b">":
                n_fasta += 1
        else:
            n_lines += 1
    if fasta:
        n = n_fasta
        fourline = False
    else:
        n = n_lines // 4
    st = os.stat(path)
    sc = {"format": "tpubwa-fai-v1", "n": n,
          "every": every if (fourline and not fasta) else 0,
          "offsets": offsets if (fourline and not fasta) else [],
          "size": st.st_size, "mtime": st.st_mtime}
    try:
        tmp = _sidecar_path(path) + ".tmp"
        with open(tmp, "w") as fh:
            json.dump(sc, fh)
        os.replace(tmp, _sidecar_path(path))
    except OSError:
        pass  # read-only input dir: keep the in-memory sidecar
    return sc


def ensure_sidecar(path: str) -> dict:
    sp = _sidecar_path(path)
    if os.path.exists(sp):
        try:
            with open(sp) as fh:
                sc = json.load(fh)
            st = os.stat(path)
            if (sc.get("format") == "tpubwa-fai-v1"
                    and sc.get("size") == st.st_size
                    and sc.get("mtime") == st.st_mtime):
                return sc
        except (OSError, json.JSONDecodeError):
            pass
    return build_sidecar(path)


def count_records(path: str) -> int:
    """Number of FASTQ records (4-line records; FASTA counts '>')."""
    return ensure_sidecar(path)["n"]


class ShardedReader:
    """Reads records [start, stop) of a FASTQ/FASTA file.  With a
    dense sidecar the skip to `start` is one seek + < EVERY record
    parses (O(1) w.r.t. the shard index); otherwise parse-skip."""

    def __init__(self, path: str, start: int, stop: int,
                 sidecar: Optional[dict] = None):
        self.inner = FastqReader(path)
        self.stop = stop - start
        self.n = 0
        skip = start
        sc = sidecar if sidecar is not None else ensure_sidecar(path)
        every = sc.get("every", 0)
        if every and start:
            ck = min(start // every, len(sc["offsets"]) - 1)
            if ck > 0:
                self.inner.seek_raw(sc["offsets"][ck])
                skip = start - ck * every
        for _ in range(skip):  # remaining records to the shard start
            try:
                next(self.inner)
            except StopIteration:
                break

    def __iter__(self):
        return self

    def __next__(self) -> Read:
        if self.n >= self.stop:
            raise StopIteration
        self.n += 1
        return next(self.inner)

    def close(self):
        self.inner.close()


def shard_readers(paths: List[str], shard_i: int,
                  shard_n: int) -> List[ShardedReader]:
    """Consistent record-range shard readers for 1 (SE/-p) or 2 (PE)
    files.  Pair counts are taken from the first file so both mates
    stay aligned."""
    if not (0 <= shard_i < shard_n):
        raise ValueError(f"bad shard {shard_i}/{shard_n}")
    scs = [ensure_sidecar(p) for p in paths]
    n = scs[0]["n"]
    lo = n * shard_i // shard_n
    hi = n * (shard_i + 1) // shard_n
    readers = [ShardedReader(p, lo, hi, sidecar=sc)
               for p, sc in zip(paths, scs)]
    for r in readers:
        # global record offset: keeps mark_primary's hash_64 read ids
        # (and thus tie-breaking) identical to an unsharded run
        r.global_offset = lo * (2 if len(paths) == 2 else 1)
    return readers

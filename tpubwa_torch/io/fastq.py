"""FASTQ/FASTA streaming (kseq.h/kopen.c equivalents; SURVEY.md §2
row 21).  Transparent gzip; batches sized by total bases like bwa's
chunk_size protocol (fastmap.c:~300: read ~chunk_size*n_threads bp per
pipeline step — chunk semantics affect PE insert stats, see §3.2)."""

from __future__ import annotations

import gzip
from dataclasses import dataclass
from typing import IO, Iterator, List, Optional, Tuple

import numpy as np

_NT4 = np.full(256, 4, dtype=np.uint8)
for _b, _c in zip(b"ACGTacgt", [0, 1, 2, 3, 0, 1, 2, 3]):
    _NT4[_b] = _c


@dataclass
class Read:
    name: str
    seq: np.ndarray          # uint8 codes 0..4
    qual: Optional[str]
    comment: str = ""

    @property
    def l_seq(self) -> int:
        return len(self.seq)


def _open(path: str) -> IO[bytes]:
    if str(path).endswith(".gz"):
        return gzip.open(path, "rb")
    return open(path, "rb")


def encode_seq(seq: bytes) -> np.ndarray:
    return _NT4[np.frombuffer(seq, dtype=np.uint8)].copy()


class _NativeBackend:
    """Buffered record source over the C batch parser (fastq.cpp).
    Pulls ~4 MB of records per call; per-record work in Python is one
    Read construction over blob views."""

    # batch sizing: big enough to amortize the call, small enough to
    # keep latency/memory modest
    MAX_REC = 16384
    SEQ_CAP = 4 << 20
    STR_CAP = 2 << 20

    def __init__(self, path: str):
        import ctypes
        from ..native import load_fastq
        self.lib = load_fastq()
        self.h = self.lib.tpubwa_fq_open(str(path).encode())
        if not self.h:
            raise OSError(f"cannot open {path}")
        self.ct = ctypes
        self.seq_buf = np.empty(self.SEQ_CAP, np.uint8)
        self.name_buf = self.ct.create_string_buffer(self.STR_CAP)
        self.qual_buf = self.ct.create_string_buffer(self.SEQ_CAP)
        self.comm_buf = self.ct.create_string_buffer(self.STR_CAP)
        self.offs = [np.zeros(self.MAX_REC + 1, np.int64)
                     for _ in range(4)]
        self.flags = np.zeros(self.MAX_REC, np.uint8)

    def fill(self) -> List["Read"]:
        ct = self.ct
        i64p = ct.POINTER(ct.c_int64)
        u8p = ct.POINTER(ct.c_uint8)
        so, no, qo, co = self.offs
        n = self.lib.tpubwa_fq_read_batch(
            self.h, self.MAX_REC, self.SEQ_CAP - 65536,
            self.seq_buf.ctypes.data_as(u8p), self.SEQ_CAP,
            so.ctypes.data_as(i64p),
            self.name_buf, self.STR_CAP, no.ctypes.data_as(i64p),
            self.qual_buf, self.SEQ_CAP, qo.ctypes.data_as(i64p),
            self.comm_buf, self.STR_CAP, co.ctypes.data_as(i64p),
            self.flags.ctypes.data_as(u8p))
        if n < 0:
            raise ValueError("malformed FASTQ/FASTA record")
        if n == 0:
            return []
        # one bulk decode per blob (a per-record bytes.decode costs
        # ~100 ns of overhead each), and views into a freshly
        # allocated seq buffer instead of per-record copies — the
        # buffer is retired here so the views stay valid
        names = self.name_buf.raw[:no[n]].decode()
        quals = self.qual_buf.raw[:qo[n]].decode()
        comms = self.comm_buf.raw[:co[n]].decode()
        sb, fl = self.seq_buf, self.flags
        self.seq_buf = np.empty(self.SEQ_CAP, np.uint8)
        has_comm = co[n] > 0
        return [Read(
            name=names[no[i]:no[i + 1]],
            seq=sb[so[i]:so[i + 1]],
            qual=(quals[qo[i]:qo[i + 1]] if fl[i] else None),
            comment=comms[co[i]:co[i + 1]] if has_comm else "")
            for i in range(n)]

    def close(self):
        if self.h:
            self.lib.tpubwa_fq_close(self.h)
            self.h = None


class FastqReader:
    """Streaming FASTQ/FASTA parser.  Uses the native (C, zlib) batch
    parser when buildable — the reference spends ~550 lines of C on
    this (kseq.h + kopen.c) because record decode starves the
    accelerator otherwise; TPUBWA_NO_NATIVE_IO=1 forces the Python
    line parser."""

    def __init__(self, path: str):
        import os
        import sys as _sys
        self._native = None
        self._queue: List[Read] = []
        self._qpos = 0
        self.fh = None
        if str(path) == "-":  # stdin pipe (kopen.c's '-' convention)
            self.fh = _sys.stdin.buffer
            self._peek = None
            return
        if not os.environ.get("TPUBWA_NO_NATIVE_IO"):
            try:
                self._native = _NativeBackend(path)
            except OSError:
                raise FileNotFoundError(path)
            except Exception:
                self._native = None
        if self._native is None:
            self.fh = _open(path)
        self._peek: Optional[bytes] = None

    def close(self):
        import sys as _sys
        if self._native is not None:
            self._native.close()
        if self.fh is not None and self.fh is not _sys.stdin.buffer:
            self.fh.close()

    def seek_raw(self, offset: int) -> None:
        """Jump to a DECOMPRESSED byte offset that is a record
        boundary (shard sidecar checkpoints).  gzip decompresses
        forward; plain files seek directly."""
        self._queue, self._qpos, self._peek = [], 0, None
        if self._native is not None:
            if self._native.lib.tpubwa_fq_seek(self._native.h,
                                               offset) != 0:
                raise OSError(f"seek({offset}) failed")
            return
        self.fh.seek(offset)

    def _readline(self) -> bytes:
        if self._peek is not None:
            line, self._peek = self._peek, None
            return line
        return self.fh.readline()

    def _peekline(self) -> bytes:
        if self._peek is None:
            self._peek = self.fh.readline()
        return self._peek

    def __iter__(self) -> Iterator[Read]:
        return self

    def __next__(self) -> Read:
        if self._native is not None:
            if self._qpos >= len(self._queue):
                self._queue = self._native.fill()
                self._qpos = 0
                if not self._queue:
                    raise StopIteration
            r = self._queue[self._qpos]
            self._qpos += 1
            return r
        while True:
            line = self._readline()
            if not line:
                raise StopIteration
            line = line.rstrip()
            if line:
                break
        if line.startswith(b"@"):  # FASTQ (multi-line seq/qual, kseq)
            hdr = line[1:].split(None, 1)
            seq_parts: List[bytes] = []
            while True:
                ln = self._readline()
                if not ln or ln.startswith(b"+"):
                    break
                seq_parts.append(ln.rstrip())
            seq = b"".join(seq_parts)
            qual_parts: List[bytes] = []
            qlen = 0
            while qlen < len(seq):
                ln = self._readline()
                if not ln:
                    break
                ln = ln.rstrip()
                qual_parts.append(ln)
                qlen += len(ln)
            qual = b"".join(qual_parts)
            if qual and len(qual) != len(seq):
                raise ValueError(
                    f"FASTQ qual length {len(qual)} != seq {len(seq)}")
            return Read(name=hdr[0].decode(), seq=encode_seq(seq),
                        qual=qual.decode() if qual else None,
                        comment=hdr[1].decode() if len(hdr) > 1 else "")
        if line.startswith(b">"):  # FASTA (multi-line)
            hdr = line[1:].split(None, 1)
            chunks: List[bytes] = []
            while True:
                nxt = self._peekline()
                if not nxt or nxt.startswith(b">") or nxt.startswith(b"@"):
                    break
                chunks.append(self._readline().rstrip())
            return Read(name=hdr[0].decode(),
                        seq=encode_seq(b"".join(chunks)), qual=None,
                        comment=hdr[1].decode() if len(hdr) > 1 else "")
        raise ValueError(f"malformed FASTQ/FASTA line: {line[:50]!r}")


def read_fastq_batch(readers: List[FastqReader], chunk_bases: int,
                     smart_pairing: bool = False) -> List[Read]:
    """bseq_read equivalent: pull reads until >= chunk_bases total bases.
    Two readers -> interleave mates; smart_pairing -> one reader supplies
    consecutive mate pairs (-p)."""
    out: List[Read] = []
    bases = 0
    if len(readers) == 2:
        it1, it2 = readers
        while bases < chunk_bases:
            try:
                r1 = next(it1)
            except StopIteration:
                break
            try:
                r2 = next(it2)
            except StopIteration:
                raise ValueError("paired FASTQ files have different length")
            out.extend([r1, r2])
            bases += r1.l_seq + r2.l_seq
        return out
    it = readers[0]
    while bases < chunk_bases:
        try:
            r = next(it)
        except StopIteration:
            break
        out.append(r)
        bases += r.l_seq
        if smart_pairing:  # always keep pairs together
            try:
                r2 = next(it)
            except StopIteration:
                break
            out.append(r2)
            bases += r2.l_seq
    return out

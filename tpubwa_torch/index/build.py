"""Reference preparation: FASTA -> packed 2-bit reference + metadata.

Semantics follow upstream bwa's bntseq.c:bns_fasta2bntseq (~250-340):
  * every base is mapped A/C/G/T -> 0/1/2/3;
  * ambiguous bases (N etc.) are replaced by a PSEUDO-RANDOM base drawn
    from lrand48() seeded with srand48(11) — replicated bit-exactly here
    so indexes are reproducible against stock bwa;
  * runs of ambiguous bases are recorded as "amb" (holes) intervals;
  * the packed reference (.pac) stores the FORWARD strand only; the BWT
    is built over forward + reverse-complement (length 2*l_pac).

This module is pure host-side Python/NumPy (index build is offline).
"""

from __future__ import annotations

import gzip
from dataclasses import dataclass
from typing import Iterator, List, Tuple

import numpy as np

# base encoding, identical to bwa's nst_nt4_table for the 16 IUPAC codes
# collapsed to {A,C,G,T}=0..3, everything else = 4 (ambiguous)
_NT4 = np.full(256, 4, dtype=np.uint8)
for _b, _c in zip(b"ACGTacgt", [0, 1, 2, 3, 0, 1, 2, 3]):
    _NT4[_b] = _c

CODE2BASE = np.frombuffer(b"ACGTN", dtype=np.uint8)


class LRand48:
    """Bit-exact emulation of glibc srand48()/lrand48().

    X_{n+1} = (a * X_n + c) mod 2^48 with a=0x5DEECE66D, c=0xB;
    srand48(s) sets X = (s << 16) | 0x330E; lrand48() returns X >> 17
    (a 31-bit non-negative integer).  bwa seeds with 11 (bntseq.c:~260).
    """

    _A = 0x5DEECE66D
    _C = 0xB
    _M = (1 << 48) - 1

    def __init__(self, seed: int = 11):
        self.x = ((seed << 16) | 0x330E) & self._M

    def next(self) -> int:
        self.x = (self._A * self.x + self._C) & self._M
        return self.x >> 17

    def fill_bases(self, n: int) -> np.ndarray:
        """n consecutive lrand48()&3 draws (the N-replacement stream)."""
        out = np.empty(n, dtype=np.uint8)
        x, A, C, M = self.x, self._A, self._C, self._M
        for i in range(n):
            x = (A * x + C) & M
            out[i] = (x >> 17) & 3
        self.x = x
        return out


@dataclass
class SeqAnn:
    """Per-sequence annotation (one .ann record)."""
    name: str
    anno: str
    offset: int
    length: int
    n_ambs: int
    gi: int = 0
    is_alt: int = 0


@dataclass
class Amb:
    """One ambiguous-base run (one .amb record)."""
    offset: int
    length: int
    amb: str = "N"


@dataclass
class BntSeq:
    """In-memory equivalent of bwa's bntseq_t: reference metadata + codes.

    ``codes`` is the forward reference as uint8 0..3 (Ns already
    randomized) — the authoritative array the BWT and .pac derive from.
    """
    l_pac: int
    anns: List[SeqAnn]
    ambs: List[Amb]
    seed: int
    codes: np.ndarray  # uint8[l_pac], values 0..3

    # ---------------- coordinate folding (bntseq.c:~380-420) -----------
    def depos(self, pos: int) -> Tuple[int, int]:
        """Doubled coordinate -> (forward pos, is_rev). bns_depos."""
        is_rev = 1 if pos >= self.l_pac else 0
        return ((self.l_pac << 1) - 1 - pos, is_rev) if is_rev else (pos, is_rev)

    def pos2rid(self, pos: int) -> int:
        """Forward position -> sequence id, -1 if out of range. bns_pos2rid."""
        if pos >= self.l_pac:
            return -1
        lo, hi = 0, len(self.anns) - 1
        while lo <= hi:  # binary search over offsets
            mid = (lo + hi) >> 1
            a = self.anns[mid]
            if a.offset <= pos < a.offset + a.length:
                return mid
            if pos < a.offset:
                hi = mid - 1
            else:
                lo = mid + 1
        return -1

    def intv2rid(self, rb: int, re: int) -> int:
        """bns_intv2rid: rid if [rb,re) lies in one sequence on one strand."""
        if rb < self.l_pac and re > self.l_pac:
            return -2  # crosses the forward-reverse boundary
        fb, _ = self.depos(rb if rb < self.l_pac else re - 1)
        fe, _ = self.depos(re - 1 if rb < self.l_pac else rb)
        if fb > fe:
            fb, fe = fe, fb
        rid_b = self.pos2rid(fb)
        rid_e = self.pos2rid(fe)
        return rid_b if rid_b == rid_e else -1

    # ---------------- sequence fetch (bntseq.c:~420) -------------------
    def fetch_bounds(self, beg: int, mid: int, end: int
                     ) -> Tuple[int, int, int]:
        """bns_fetch_seq's clipping without materializing the codes:
        (rid, beg', end') — used when the reference window is extracted
        on DEVICE from the resident pac."""
        if end < beg:
            beg, end = end, beg
        assert beg <= mid < end
        fm, is_rev = self.depos(mid)
        rid = self.pos2rid(fm)
        a = self.anns[rid]
        if is_rev:
            lo = (self.l_pac << 1) - (a.offset + a.length)
            hi = (self.l_pac << 1) - a.offset
        else:
            lo, hi = a.offset, a.offset + a.length
        return rid, max(beg, lo), min(end, hi)

    def fetch_seq(self, beg: int, mid: int, end: int) -> Tuple[np.ndarray, int, int, int]:
        """bns_fetch_seq: fetch [beg,end) in doubled coords, clipped to the
        sequence containing ``mid``. Returns (codes, rid, beg', end')."""
        if end < beg:
            beg, end = end, beg
        assert beg <= mid < end
        fm, is_rev = self.depos(mid)
        rid = self.pos2rid(fm)
        a = self.anns[rid]
        if is_rev:
            lo = (self.l_pac << 1) - (a.offset + a.length)
            hi = (self.l_pac << 1) - a.offset
        else:
            lo, hi = a.offset, a.offset + a.length
        beg = max(beg, lo)
        end = min(end, hi)
        seq = self.get_seq(beg, end)
        return seq, rid, beg, end

    def get_seq(self, beg: int, end: int) -> np.ndarray:
        """Codes for doubled-coordinate interval [beg, end)."""
        if beg >= self.l_pac:  # entirely on reverse strand image
            fb = (self.l_pac << 1) - end
            fe = (self.l_pac << 1) - beg
            return (3 - self.codes[fb:fe])[::-1].copy()
        if end <= self.l_pac:
            return self.codes[beg:end].copy()
        fwd = self.codes[beg:self.l_pac]
        fb = (self.l_pac << 1) - end
        rev = (3 - self.codes[fb:self.l_pac])[::-1]
        return np.concatenate([fwd, rev])

    def doubled(self) -> np.ndarray:
        """forward + reverse-complement codes, length 2*l_pac (bwt text)."""
        return np.concatenate([self.codes, 3 - self.codes[::-1]])


def read_fasta(path: str) -> Iterator[Tuple[str, str, bytes]]:
    """Yield (name, comment, seq_bytes) per record; transparent gzip."""
    op = gzip.open if str(path).endswith(".gz") else open
    name = None
    comment = ""
    chunks: List[bytes] = []
    with op(path, "rb") as fh:
        for line in fh:
            line = line.rstrip(b"\r\n")
            if line.startswith(b">"):
                if name is not None:
                    yield name, comment, b"".join(chunks)
                hdr = line[1:].split(None, 1)
                name = hdr[0].decode()
                comment = hdr[1].decode() if len(hdr) > 1 else ""
                chunks = []
            elif line:
                chunks.append(line)
    if name is not None:
        yield name, comment, b"".join(chunks)


def fasta2bnt(path: str, seed: int = 11) -> BntSeq:
    """FASTA -> BntSeq with bwa's exact N-randomization protocol.

    bwa draws one lrand48() per ambiguous base, in reference order,
    from a generator seeded once with 11 before the first sequence.
    """
    rng = LRand48(seed)
    anns: List[SeqAnn] = []
    ambs: List[Amb] = []
    parts: List[np.ndarray] = []
    offset = 0
    for name, comment, seq in read_fasta(path):
        codes = _NT4[np.frombuffer(seq, dtype=np.uint8)].copy()
        is_amb = codes > 3
        n_ambs_before = len(ambs)
        if is_amb.any():
            # record runs of ambiguity (bwa records per-run offset/len)
            idx = np.flatnonzero(is_amb)
            run_starts = idx[np.r_[True, np.diff(idx) != 1]]
            run_ends = idx[np.r_[np.diff(idx) != 1, True]]
            for s, e in zip(run_starts, run_ends):
                ambs.append(Amb(offset=offset + int(s), length=int(e - s + 1)))
            codes[is_amb] = rng.fill_bases(int(is_amb.sum()))
        anns.append(SeqAnn(name=name, anno=comment or "(null)", offset=offset,
                           length=len(codes),
                           n_ambs=len(ambs) - n_ambs_before))
        parts.append(codes)
        offset += len(codes)
    if not anns:
        raise ValueError(f"no sequences in {path}")
    return BntSeq(l_pac=offset, anns=anns, ambs=ambs, seed=seed,
                  codes=np.concatenate(parts) if parts else
                  np.zeros(0, np.uint8))


# --------------------------- 2-bit packing -----------------------------

def pack_pac(codes: np.ndarray) -> np.ndarray:
    """Pack 0..3 codes 4-per-byte, base i at shift ((~i & 3) << 1)
    (bwa's _set_pac layout: first base in the high bits)."""
    n = len(codes)
    pad = (-n) % 4
    c = np.concatenate([codes, np.zeros(pad, np.uint8)]).reshape(-1, 4)
    return (c[:, 0] << 6 | c[:, 1] << 4 | c[:, 2] << 2 | c[:, 3]).astype(np.uint8)


def unpack_pac(pac: np.ndarray, l_pac: int) -> np.ndarray:
    b = pac[:, None] >> np.array([6, 4, 2, 0], np.uint8)[None, :]
    return (b & 3).reshape(-1).astype(np.uint8)[:l_pac]


def write_pac(path: str, codes: np.ndarray) -> None:
    """bwa .pac file: packed bytes; if l%4==0 an extra 0 byte; then a
    final byte holding l%4 (bntseq.c:bns_fasta2bntseq tail)."""
    data = pack_pac(codes).tobytes()
    if len(codes) % 4 == 0:
        data += b"\x00"
    data += bytes([len(codes) % 4])
    with open(path, "wb") as fh:
        fh.write(data)


def read_pac(path: str, l_pac: int) -> np.ndarray:
    raw = np.fromfile(path, dtype=np.uint8)
    return unpack_pac(raw, l_pac)


# --------------------------- .ann / .amb text --------------------------

def write_ann(path: str, bnt: BntSeq) -> None:
    """bwa .ann: header 'l_pac n_seqs seed', then per seq two lines."""
    with open(path, "w") as fh:
        fh.write(f"{bnt.l_pac} {len(bnt.anns)} {bnt.seed}\n")
        for a in bnt.anns:
            fh.write(f"{a.gi} {a.name} {a.anno}\n")
            fh.write(f"{a.offset} {a.length} {a.n_ambs}\n")


def write_amb(path: str, bnt: BntSeq) -> None:
    with open(path, "w") as fh:
        fh.write(f"{bnt.l_pac} {len(bnt.anns)} {len(bnt.ambs)}\n")
        for h in bnt.ambs:
            fh.write(f"{h.offset} {h.length} {h.amb}\n")


def read_ann_amb(ann_path: str, amb_path: str) -> Tuple[int, List[SeqAnn], List[Amb], int]:
    with open(ann_path) as fh:
        l_pac, n_seqs, seed = (int(x) for x in fh.readline().split())
        anns = []
        for _ in range(n_seqs):
            line1 = fh.readline().split(None, 2)
            gi, name = int(line1[0]), line1[1]
            anno = line1[2].strip() if len(line1) > 2 else ""
            off, ln, na = (int(x) for x in fh.readline().split())
            anns.append(SeqAnn(name=name, anno=anno, offset=off, length=ln,
                               n_ambs=na, gi=gi))
    ambs = []
    with open(amb_path) as fh:
        _, _, n_holes = (int(x) for x in fh.readline().split())
        for _ in range(n_holes):
            parts = fh.readline().split()
            ambs.append(Amb(offset=int(parts[0]), length=int(parts[1]),
                            amb=parts[2]))
    return l_pac, anns, ambs, seed

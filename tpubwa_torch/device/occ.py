"""Batched FM-index primitives on the device, the counterpart of
tpubwa/device/occ.py (bwt.c:bwt_occ4/bwt_2occ4/bwt_extend/bwt_sa).

Layout, as tpubwa's: one fused row per 128-base block, 4 checkpoint
counts then 8 packed-base words (``occ_blocks``, [n_blocks, 12]), so one
occ4 query is one 48-byte row read and masked popcounts.

Two versions of the two functions that walk the index, bit-identical by
test, as extend_kernel.py has them:

* ``sa_lookup_plain`` and ``bwt_extend_plain``: PyTorch ops over the
  plain primitives below (``occ4``, ``inv_psi``, the mark-row lookups);
* the hand-written CUDA kernels of ``csrc/occ.cu`` over the device
  functions of ``csrc/fm.cuh``, reached through ``sa_lookup`` (K-sa, a
  persistent grid whose lanes take ranks from a rank queue) and
  ``bwt_extend`` (K-ext, one query a thread) for CUDA tensors.

``sa_lookup`` and ``bwt_extend`` route by the tensors' device: a CPU
tensor takes the plain version, a CUDA tensor launches the kernel or
raises.  Nothing falls back from one to the other.  Over an index split
into row slabs across devices (``dist/index_tp.py:TpIndex``) the plain
versions read through its routed accessors and the kernels' TP
instantiations take each row from the slab that holds it.

Unsigned words.  torch has no ``>>``, ``>`` or popcount for uint32 on
the CPU, so the index's uint32 arrays are kept as int32 bit patterns and
the plain functions read them as int64 values (``& 0xFFFFFFFF``) and
count bits with a SWAR popcount in int64.  The checkpoint counts are
unsigned too: at GRCh38 scale (doubled length 6.2e9) they pass 2^31, so
they are never read as signed int32 (the kernels read them as
``uint32_t``).

The FM arrays (occ blocks, SA samples and marks, about 170 MB at
64 Mbp) go to the device at first use, not when the index is made: the
main path (an index with text-position marks, whose SA walk runs in
native code on the host) never reads them.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass, field
from typing import Callable, Mapping, Optional

import numpy as np
import torch

from ..index.fmindex import FMIndex, SA_INTV, WORDS_PER_BLOCK, pack_bwt_words
from . import _build
from .counts import bump

I64 = torch.int64
_M32 = 0xFFFFFFFF
# base c matches where its 2 bits equal those of c * 0x55555555
_PATTERNS = (0x00000000, 0x55555555, 0xAAAAAAAA, 0xFFFFFFFF)
# the FM arrays of a DeviceIndex, uploaded at first use
FM_ARRAYS = ("occ_blocks", "sa_sample", "L2", "mark_rows", "sa_marked")


def _fits_i32(seq_len: int) -> bool:
    """Ranks/positions live in [-1, seq_len+1]; int32 covers genomes
    under 2^31-2 doubled bases, human-scale indexes take int64."""
    return seq_len + 2 < (1 << 31)


def _host_tensor(a, dtype) -> torch.Tensor:
    """A CPU tensor of ``a`` as numpy ``dtype`` (a copy where ``a`` is
    read-only or of another layout); uint32 as int32 bit patterns."""
    a = np.require(a, dtype, ["C", "W"])
    return torch.from_numpy(a.view(np.int32) if dtype == np.uint32 else a)


@dataclass
class DeviceIndex:
    """FM-index arrays on ``device`` + static scalars.  ``idt`` is the
    dtype of ranks and positions (int32 when they fit).  ``pac_words``
    goes to the device when the index is made; the FM arrays
    (``FM_ARRAYS``) when one of them is first read."""
    pac_words: torch.Tensor   # int32 bit patterns [ceil(l_pac/16)]
    l_pac: int
    seq_len: int              # doubled text length (FMIndex.seq_len)
    primary: int
    mark_D: int               # 0: no text-position marks (stock bwa)
    idt: torch.dtype
    device: torch.device
    # () -> {name of FM_ARRAYS: numpy array}; read once, at first use
    fm_source: Callable = field(repr=False)
    _fm: Optional[dict] = field(default=None, repr=False)

    @property
    def np_idt(self):
        """numpy dtype for ranks and positions."""
        return np.int64 if self.idt == I64 else np.int32

    def upload_fm(self) -> dict:
        """The FM arrays on the device, uploaded on the first call:
        ``occ_blocks`` int32 bits [n_blocks, 12], ``sa_sample`` idt,
        ``L2`` idt [5], ``mark_rows`` int32 bits [nb, 8], ``sa_marked``
        idt (1-row zero arrays when the index has no marks)."""
        if self._fm is None:
            arrays = self.fm_source()
            fm = {}
            for name in FM_ARRAYS:
                a = arrays[name]
                fm[name] = _host_tensor(a, np.uint32 if name in (
                    "occ_blocks", "mark_rows") else self.np_idt).to(
                        self.device)
            self._fm = fm
        return self._fm

    @property
    def occ_blocks(self):
        return self.upload_fm()["occ_blocks"]

    @property
    def sa_sample(self):
        return self.upload_fm()["sa_sample"]

    @property
    def L2(self):
        return self.upload_fm()["L2"]

    @property
    def mark_rows(self):
        return self.upload_fm()["mark_rows"]

    @property
    def sa_marked(self):
        return self.upload_fm()["sa_marked"]

    # -- index row accessors -------------------------------------------
    # The only surface through which the plain functions read the big
    # index arrays: the port's index split into row slabs across devices,
    # tpubwa_torch/dist/index_tp.py:TpIndex, has its own four.
    def occ_row(self, blk):
        """Fused occ row(s) [.., 12] for block index blk."""
        return self.occ_blocks[blk]

    def mark_row_at(self, blk):
        """Text-position-mark row(s) [.., 8] for block index blk."""
        return self.mark_rows[blk]

    def sa_marked_at(self, idx):
        """Marked-SA value(s) at idx."""
        return self.sa_marked[idx]

    def sa_sample_at(self, idx):
        """Rank-sampled SA value(s) at idx (stock-bwa indexes)."""
        return self.sa_sample[idx]

    @classmethod
    def from_fmindex(cls, fmi: FMIndex, device) -> "DeviceIndex":
        """The index of ``fmi`` on ``device``; its FM arrays are built
        and uploaded at first use."""
        D = int(getattr(fmi, "sa_mark_D", 0) or 0)

        def source():
            n_blocks = fmi.occ_ckpt.shape[0] - 1
            words = np.zeros(n_blocks * WORDS_PER_BLOCK, np.uint32)
            words[:len(fmi.bwt_words)] = fmi.bwt_words
            blocks = np.concatenate(
                [fmi.occ_ckpt[:-1], words.reshape(n_blocks, WORDS_PER_BLOCK)],
                axis=1).astype(np.uint32)
            if D:
                marks = (fmi.sa_mark_rows, fmi.sa_marked)
            else:
                marks = (np.zeros((1, 8), np.uint32), np.zeros(1, np.int64))
            return {"occ_blocks": blocks, "sa_sample": fmi.sa_sample,
                    "L2": fmi.L2, "mark_rows": marks[0],
                    "sa_marked": marks[1]}

        idt = torch.int32 if _fits_i32(int(fmi.seq_len)) else I64
        return cls._make(pack_bwt_words(fmi.bnt.codes), int(fmi.bnt.l_pac),
                         int(fmi.seq_len), int(fmi.primary), D, idt, device,
                         source)

    @classmethod
    def from_numpy(cls, arrays: Mapping, device="cuda") -> "DeviceIndex":
        """Carry a tpubwa DeviceIndex, fetched as numpy arrays (the
        uint32 ``occ_blocks``, ``pac_words`` and ``mark_rows``, and
        ``sa_sample``, ``L2`` and ``sa_marked``) and scalars (``primary``,
        ``seq_len``, ``l_pac``, ``mark_D``), into the port.  ``idt`` is
        ``sa_sample``'s dtype, int32 or int64 (int32 only where the
        ranks fit it)."""
        dt = np.asarray(arrays["sa_sample"]).dtype
        seq_len = int(arrays["seq_len"])
        if dt not in (np.int32, np.int64) or (
                dt == np.int32 and not _fits_i32(seq_len)):
            raise TypeError(f"sa_sample of dtype {dt} for seq_len "
                            f"{seq_len}")
        fm = {k: np.asarray(arrays[k]) for k in FM_ARRAYS}
        return cls._make(np.asarray(arrays["pac_words"]),
                         int(arrays["l_pac"]), seq_len,
                         int(arrays["primary"]), int(arrays["mark_D"]),
                         torch.int32 if dt == np.int32 else I64, device,
                         lambda: fm)

    @classmethod
    def _make(cls, words, l_pac, seq_len, primary, mark_D, idt, device,
              source) -> "DeviceIndex":
        pac = _host_tensor(words, np.uint32).clone().to(device)
        return cls(pac_words=pac, l_pac=l_pac, seq_len=seq_len,
                   primary=primary, mark_D=mark_D, idt=idt,
                   device=pac.device, fm_source=source)


# ---------------------------------------------------------------------
# the plain primitives (tpubwa/device/occ.py, function for function)

def _u32(x: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns -> their unsigned values, as int64."""
    return x.long() & _M32


def _popcount(v: torch.Tensor) -> torch.Tensor:
    """Bits set in each int64 value of [0, 2^32) (SWAR: torch has no
    popcount op)."""
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return ((v * 0x01010101) & _M32) >> 24


def _match(words: torch.Tensor, pat) -> torch.Tensor:
    """One bit (the low bit of the pair) per base of ``words`` (uint32
    values in int64) equal to the base whose pattern is ``pat``."""
    nx = (words ^ pat) ^ _M32
    return nx & (nx >> 1) & 0x55555555


def _cover(nb: torch.Tensor) -> torch.Tensor:
    """[..., 8] masks of the first nb (int64 [...], in [0, 128]) bases
    of a block's 8 words."""
    lane = torch.arange(8, dtype=I64, device=nb.device)
    cov = torch.clamp(nb[..., None] - lane * 16, 0, 16)
    shift = 2 * (16 - torch.clamp(cov, 1, 16))
    return torch.where(cov > 0, (_M32 << shift) & _M32, 0)


def _block_counts(words: torch.Tensor, nb: torch.Tensor) -> torch.Tensor:
    """#occurrences of each base among the first nb bases of a block.

    words: uint32 values in int64 [..., 8]; nb: int64 [...] in [0, 128].
    Returns int64 [..., 4]."""
    pat = torch.tensor(_PATTERNS, dtype=I64, device=words.device)
    y = _match(words[..., None, :], pat[:, None])         # [..., 4, 8]
    return _popcount(y & _cover(nb)[..., None, :]).sum(-1)


def _occ4_kk(didx: DeviceIndex, k: torch.Tensor) -> torch.Tensor:
    """The stored row of occ4's query k: k - (k >= primary), clamped
    into [0, seq_len)."""
    return torch.clamp(torch.where(k >= didx.primary, k - 1, k), 0,
                       didx.seq_len - 1)


def _lf_x(didx: DeviceIndex, k: torch.Tensor) -> torch.Tensor:
    """The stored row of inv_psi's k: k - (k > primary), clamped into
    [0, seq_len)."""
    return torch.clamp(k - (k > didx.primary).long(), 0, didx.seq_len - 1)


def occ4(didx: DeviceIndex, k: torch.Tensor) -> torch.Tensor:
    """occ(k, c) for all 4 bases; k [...] conceptual rows in
    [-1, seq_len].  Returns idt [..., 4]."""
    k = k.long()
    kk = _occ4_kk(didx, k)
    blk = kk >> 7
    row = _u32(didx.occ_row(blk))                         # [..., 12]
    cnt = row[..., :4] + _block_counts(row[..., 4:], kk - (blk << 7) + 1)
    cnt = torch.where((k < 0)[..., None], 0, cnt)
    L2 = didx.L2.long()
    cnt = torch.where((k == didx.seq_len)[..., None], L2[1:5] - L2[0:4],
                      cnt)
    return cnt.to(didx.idt)


def occ1(didx: DeviceIndex, k: torch.Tensor, c: torch.Tensor):
    """occ(k, c) for one base per query."""
    return torch.gather(occ4(didx, k), -1, c.long()[..., None])[..., 0]


def _word_code(row: torch.Tensor, within: torch.Tensor) -> torch.Tensor:
    """The base at ``within`` (int64 [...], in [0, 128)) of the block
    whose fused row (uint32 values in int64 [..., 12]) is ``row``."""
    w = torch.gather(row, -1, (4 + (within >> 4))[..., None])[..., 0]
    return (w >> ((15 - (within & 15)) << 1)) & 3


def bwt_code(didx: DeviceIndex, x: torch.Tensor) -> torch.Tensor:
    """stored BWT[x] (x stored index, [...] in [0, seq_len))."""
    x = x.long()
    blk = x >> 7
    return _word_code(_u32(didx.occ_row(blk)), x - (blk << 7)).to(didx.idt)


def set_intv(didx: DeviceIndex, c: torch.Tensor) -> torch.Tensor:
    """bwt_set_intv batched: [..., 3] (x0, x1, size) for single bases."""
    c = c.long()
    L2 = didx.L2
    return torch.stack([L2[c] + 1, L2[3 - c] + 1, L2[c + 1] - L2[c]], -1)


def bwt_extend_plain(didx: DeviceIndex, ik: torch.Tensor, is_back: bool,
                     stats=None) -> torch.Tensor:
    """Batched bidirectional extension (bwt.c:bwt_extend).

    ik: [..., 3] = (x0, x1, size).  Returns idt [..., 4, 3] indexed by
    the base in the extension direction.  A ``stats`` dict gets
    ``occ_rows``, the occ rows the two occ4 queries read (1-D)."""
    ik = ik.long()
    piv = ik[..., 0] if is_back else ik[..., 1]
    oth = ik[..., 1] if is_back else ik[..., 0]
    sz = ik[..., 2]
    if stats is not None:
        rows = torch.cat([_occ4_row(didx, k).reshape(-1)
                          for k in (piv - 1, piv - 1 + sz)])
        stats["occ_rows"] = rows[rows >= 0]
    tk = occ4(didx, piv - 1).long()
    tl = occ4(didx, piv - 1 + sz).long()
    sizes = tl - tk
    new_piv = didx.L2[:4].long() + 1 + tk
    sent = ((piv <= didx.primary) & (piv + sz - 1 >= didx.primary)).long()
    acc3 = oth + sent
    acc2 = acc3 + sizes[..., 3]
    acc1 = acc2 + sizes[..., 2]
    acc0 = acc1 + sizes[..., 1]
    accs = torch.stack([acc0, acc1, acc2, acc3], -1)
    parts = [new_piv, accs, sizes] if is_back else [accs, new_piv, sizes]
    return torch.stack(parts, -1).to(didx.idt)


def _occ4_row(didx: DeviceIndex, k: torch.Tensor) -> torch.Tensor:
    """The occ row occ4(k) reads, -1 where it reads none (k < 0 or
    k == seq_len)."""
    return torch.where((k < 0) | (k == didx.seq_len), -1,
                       _occ4_kk(didx, k) >> 7)


def _lf_row(didx: DeviceIndex, k: torch.Tensor) -> torch.Tensor:
    """The occ row inv_psi(k) reads (k in [0, seq_len], k != primary)."""
    return _lf_x(didx, k) >> 7


def inv_psi(didx: DeviceIndex, k: torch.Tensor) -> torch.Tensor:
    """LF mapping on conceptual rows k in [0, seq_len], batched.

    x = k - (k > primary) equals occ4's kk = k - (k >= primary) except
    at k == primary (whose result is 0), so one row read serves the BWT
    code and the single-base count."""
    k = k.long()
    x = _lf_x(didx, k)
    blk = x >> 7
    row = _u32(didx.occ_row(blk))                         # [..., 12]
    within = x - (blk << 7)
    c = _word_code(row, within)
    base = torch.gather(row, -1, c[..., None])[..., 0]
    pat = torch.tensor(_PATTERNS, dtype=I64, device=k.device)[c]
    y = _match(row[..., 4:], pat[..., None])
    cnt = _popcount(y & _cover(within + 1)).sum(-1)
    lf = didx.L2.long()[c] + base + cnt
    return torch.where(k == didx.primary, 0, lf).to(didx.idt)


def _mark_row(didx: DeviceIndex, k: torch.Tensor):
    """The 8-lane mark row (uint32 values in int64) of conceptual rank
    k, with (row, word, bitpos, within): word holds k's bit at bitpos."""
    k = k.long()
    blk = k >> 7
    row = _u32(didx.mark_row_at(blk))                     # [..., 8]
    within = k - (blk << 7)
    w = torch.gather(row, -1, (1 + (within >> 5))[..., None])[..., 0]
    return row, w, 31 - (within & 31), within


def _mark_bit(didx: DeviceIndex, k: torch.Tensor) -> torch.Tensor:
    _, w, bp, _ = _mark_row(didx, k)
    return ((w >> bp) & 1).int()


def _mark_index(didx: DeviceIndex, k: torch.Tensor) -> torch.Tensor:
    """# of marked ranks before k (k itself marked) = index into
    sa_marked."""
    row, w, bp, within = _mark_row(didx, k)
    lane = torch.arange(4, dtype=I64, device=k.device)
    full = torch.where(lane < (within >> 5)[..., None],
                       _popcount(row[..., 1:5]), 0).sum(-1)
    # bits above bp in k's own word = marked ranks earlier in the word
    # (w < 2^32, so w >> 32 is 0 where bp is 31)
    part = _popcount(w >> (bp + 1))
    return (row[..., 0] + full + part).to(didx.idt)


def sa_lookup_plain(didx: DeviceIndex, ranks: torch.Tensor,
                    stats=None) -> torch.Tensor:
    """Batched bwt_sa: the SA value (text position) of each rank in
    [0, seq_len] (ranks outside are clamped into it).  Returns idt.

    With text-position marks (mark_D > 0) each walk takes at most
    mark_D - 1 LF steps; without them, LF steps until the rank is a
    multiple of SA_INTV (geometric, mean 32, no bound), then
    sa_sample[k // SA_INTV].  A ``stats`` dict gets ``steps`` (LF steps
    a rank) and what the walks read, one entry a read (1-D):
    ``occ_rows`` (an LF step's occ row), ``mark_rows`` (a mark test's
    row) and ``samples`` (the index of the value the walk ends on, in
    sa_marked or sa_sample)."""
    k = torch.clamp(ranks.long(), 0, didx.seq_len)
    steps = torch.zeros_like(k)
    reads = {"occ_rows": [], "mark_rows": []}
    if didx.mark_D:
        done = torch.zeros(k.shape, dtype=torch.bool, device=k.device)
        for _ in range(didx.mark_D - 1):
            reads["mark_rows"].append((k >> 7)[~done])
            done = done | (_mark_bit(didx, k) == 1)
            reads["occ_rows"].append(_lf_row(didx, k)[~done])
            k = torch.where(done, k, inv_psi(didx, k).long())
            steps = steps + (~done).long()
        if not done.all():
            reads["mark_rows"].append((k >> 7)[~done])
        idx = _mark_index(didx, k)
        pos = steps + didx.sa_marked_at(idx).long()
    else:
        active = (k % SA_INTV) != 0
        while bool(active.any()):
            reads["occ_rows"].append(_lf_row(didx, k)[active])
            k = torch.where(active, inv_psi(didx, k).long(), k)
            steps = steps + active.long()
            active = (k % SA_INTV) != 0
        idx = k // SA_INTV
        pos = steps + didx.sa_sample_at(idx).long()
    if stats is not None:
        stats["steps"] = steps
        stats["samples"] = idx.reshape(-1).long()
        for name, parts in reads.items():
            stats[name] = (torch.cat([p.reshape(-1) for p in parts]) if parts
                           else torch.zeros(0, dtype=I64, device=k.device))
    return pos.to(didx.idt)


def get_ref_batch(didx: DeviceIndex, starts: torch.Tensor,
                  length: int) -> torch.Tensor:
    """Fetch ``length`` forward-reference codes from each start (int32
    [n, length]; doubled coordinates are NOT handled here: callers fold
    strands)."""
    pos = starts.long()[:, None] + torch.arange(length, dtype=I64,
                                                device=starts.device)
    pos = torch.clamp(pos, 0, didx.l_pac - 1)
    w = _u32(didx.pac_words[pos >> 4])
    return ((w >> ((15 - (pos & 15)) << 1)) & 3).int()


# ---------------------------------------------------------------------
# the kernels of csrc/occ.cu

_VP, _CI, _CL = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
_SIGNATURES = {
    # (occ, L2, mark_rows, sa_marked, sa_sample, primary, seq_len,
    #  mark_D, idx64, ranks, out, n, queue, lanes, max_blocks, device,
    #  stream) -> cudaError_t
    "tpubwa_sa_lookup": (_CI, [_VP] * 5 + [_CL, _CL, _CI, _CI, _VP, _VP,
                                          _CL, _VP, _VP, _CI, _CI, _VP]),
    # (idx64, marked, n, max_blocks, device, out[3]) -> cudaError_t
    "tpubwa_sa_lookup_shape": (_CI, [_CI, _CI, _CL, _CI, _CI, _VP]),
    # (occ, L2, primary, seq_len, idx64, is_back, ik, out, n, device,
    #  stream) -> cudaError_t
    "tpubwa_bwt_extend": (_CI, [_VP, _VP, _CL, _CL, _CI, _CI, _VP, _VP,
                                _CL, _CI, _VP]),
    # K-reach: (occ, L2, primary, seq_len, idx64, q, L, lens, read_idx,
    #  starts, min_intv, ik, e, n, queue, device, stream) -> cudaError_t
    "tpubwa_rightmost_reach": (_CI, [_VP, _VP, _CL, _CL, _CI, _VP, _CI]
                               + [_VP] * 6 + [_CL, _VP, _CI, _VP]),
    # the TP instantiations: (n_slabs, the slab tables, then the flat
    # entry's arguments from L2 on, sa_sample dropped) -> cudaError_t
    "tpubwa_sa_lookup_tp": (_CI, [_CI, _VP, _VP, _VP, _VP, _CL, _CL, _CI,
                                  _CI, _VP, _VP, _CL, _VP, _VP, _CI, _CI,
                                  _VP]),
    "tpubwa_bwt_extend_tp": (_CI, [_CI, _VP, _VP, _CL, _CL, _CI, _CI, _VP,
                                   _VP, _CL, _CI, _VP]),
}


def _check(didx: DeviceIndex, x: torch.Tensor, what: str, tail: tuple):
    """Raise unless ``x`` is an idt tensor [n, *tail] on the index's
    device."""
    if x.dtype != didx.idt:
        raise TypeError(f"{what} must be {didx.idt}, got {x.dtype}")
    if x.device != didx.device:
        raise ValueError(f"{what} is on {x.device}, the index on "
                         f"{didx.device}")
    if x.dim() != 1 + len(tail) or tuple(x.shape[1:]) != tail:
        raise ValueError(f"{what} must be [n{''.join(f', {d}' for d in tail)}"
                         f"], got {tuple(x.shape)}")


def _kernel_route(x: torch.Tensor) -> bool:
    """False for a CPU tensor (the plain version), True for a CUDA one
    (the kernel); raises for any other device."""
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"no FM-index kernel for device {x.device}")
    return True


def _raise_on(rc: int, what: str):
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: cudaError {rc}")


def sharded(didx):
    """``didx`` where it is an index split into row slabs
    (``dist/index_tp.py:TpIndex``), else None."""
    from ..dist.index_tp import TpIndex
    return didx if isinstance(didx, TpIndex) else None


def _sa_lookup_tp(lib, tp, ranks: torch.Tensor, out: torch.Tensor):
    """K-sa's TP instantiation (the marked walk) on ``tp``'s slabs."""
    tp.check_marked()
    queue = torch.empty(1, dtype=torch.int32, device=ranks.device)
    rc = lib.tpubwa_sa_lookup_tp(
        tp.n, *(tp.kernel_table(k) for k in (
            "occ_blocks", "mark_rows", "sa_marked")),
        tp.L2.data_ptr(), tp.primary, tp.seq_len, tp.mark_D,
        int(tp.idt == I64), ranks.data_ptr(), out.data_ptr(), len(ranks),
        queue.data_ptr(), None, 0, ranks.device.index,
        torch.cuda.current_stream(ranks.device).cuda_stream)
    _raise_on(rc, "sa_lookup (tp)")
    bump(sa_lookup, "tp_launches")


def sa_lookup(didx: DeviceIndex, ranks: torch.Tensor) -> torch.Tensor:
    """tpubwa's sa_lookup contract: ranks idt [n] in [0, seq_len] ->
    text positions idt [n].  CPU tensors run ``sa_lookup_plain``; CUDA
    tensors launch csrc/occ.cu's walk (``sa_lookup.launches`` counts
    its launches, ``sa_lookup.marked_launches`` those of the marked
    walk): the marked walk where the index has marks, else the
    rank-sampled one, on a persistent grid whose lanes take ranks from a
    rank queue (an int32 allocated here).  Over a ``TpIndex`` the marked
    walk's TP instantiation (``sa_lookup.tp_launches``; a mark-less one
    raises NotImplementedError on both routes).  Raises RuntimeError
    where the launch fails or the entry refuses it (n past the queue's
    range, about 2^31 ranks; a slab on a card the launch's cannot
    reach)."""
    _check(didx, ranks, "ranks", ())
    if not _kernel_route(ranks):
        return sa_lookup_plain(didx, ranks)
    lib = _build.load("occ", _SIGNATURES)
    ranks = ranks.contiguous()
    out = torch.empty_like(ranks)
    if not len(ranks):
        return out
    if sharded(didx):
        _sa_lookup_tp(lib, didx, ranks, out)
        return out
    fm = didx.upload_fm()
    queue = torch.empty(1, dtype=torch.int32, device=ranks.device)
    rc = lib.tpubwa_sa_lookup(
        fm["occ_blocks"].data_ptr(), fm["L2"].data_ptr(),
        fm["mark_rows"].data_ptr(), fm["sa_marked"].data_ptr(),
        fm["sa_sample"].data_ptr(), didx.primary, didx.seq_len,
        didx.mark_D, int(didx.idt == I64), ranks.data_ptr(),
        out.data_ptr(), len(ranks), queue.data_ptr(), None, 0,
        ranks.device.index,
        torch.cuda.current_stream(ranks.device).cuda_stream)
    _raise_on(rc, "sa_lookup")
    bump(sa_lookup)
    bump(sa_lookup, "marked_launches", int(didx.mark_D > 0))
    return out


def sa_lookup_shape(lib, didx: DeviceIndex, n: int, device_index: int,
                    max_blocks: int = 0):
    """(the error a launch of ``n`` ranks would return before it runs,
    {"blocks_per_sm", "sms", "blocks"}): K-sa's grid on this card, from
    ``lib``'s ``tpubwa_sa_lookup_shape``."""
    out = (ctypes.c_int64 * 3)()
    rc = lib.tpubwa_sa_lookup_shape(int(didx.idt == I64),
                                    int(didx.mark_D > 0), n, max_blocks,
                                    device_index, out)
    return rc, dict(zip(("blocks_per_sm", "sms", "blocks"), out))


def bwt_extend(didx: DeviceIndex, ik: torch.Tensor,
               is_back: bool) -> torch.Tensor:
    """tpubwa's bwt_extend contract: ik idt [n, 3] (x0, x1, size) ->
    idt [n, 4, 3].  CPU tensors run ``bwt_extend_plain``; CUDA tensors
    launch csrc/occ.cu's extension (``bwt_extend.launches``), over a
    ``TpIndex`` its TP instantiation (``bwt_extend.tp_launches``)."""
    _check(didx, ik, "ik", (3,))
    if not _kernel_route(ik):
        return bwt_extend_plain(didx, ik, is_back)
    lib = _build.load("occ", _SIGNATURES)
    ik = ik.contiguous()
    out = torch.empty((len(ik), 4, 3), dtype=ik.dtype, device=ik.device)
    if not len(ik):
        return out
    tp = sharded(didx)
    if tp:
        rc = lib.tpubwa_bwt_extend_tp(
            tp.n, tp.kernel_table("occ_blocks"), tp.L2.data_ptr(),
            tp.primary, tp.seq_len, int(tp.idt == I64), int(bool(is_back)),
            ik.data_ptr(), out.data_ptr(), len(ik), ik.device.index,
            torch.cuda.current_stream(ik.device).cuda_stream)
        _raise_on(rc, "bwt_extend (tp)")
        bump(bwt_extend, "tp_launches")
        return out
    fm = didx.upload_fm()
    rc = lib.tpubwa_bwt_extend(
        fm["occ_blocks"].data_ptr(), fm["L2"].data_ptr(), didx.primary,
        didx.seq_len, int(didx.idt == I64), int(bool(is_back)),
        ik.data_ptr(), out.data_ptr(), len(ik), ik.device.index,
        torch.cuda.current_stream(ik.device).cuda_stream)
    _raise_on(rc, "bwt_extend")
    bump(bwt_extend)
    return out


sa_lookup.launches = 0
sa_lookup.marked_launches = 0
sa_lookup.tp_launches = 0
bwt_extend.launches = 0
bwt_extend.tp_launches = 0

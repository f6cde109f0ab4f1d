"""The FM-index split into row slabs across devices, the counterpart of
tpubwa/dist/index_tp.py (tensor-parallel, "tp": SURVEY.md §2.2's TP row,
"shard occ/SA arrays by k-range").

For a reference whose index does not fit one device, the row-heavy
arrays (``occ_blocks``, ``mark_rows`` and ``sa_marked``) are padded with
zero rows to a multiple of n and cut into n contiguous slabs, slab i its
own tensor on ``devices[i]``; the small ``L2`` is on every device.  A
device's index memory is then 1/n of those arrays.

tpubwa routes every row read by ownership: each shard answers the rows
it holds, the others add zeros, and one ``psum`` delivers the row, a
collective per step of a chain of dependent LF steps.  The port keeps
what is computed and moves the routing into the row's address:

* ``TpIndex`` is a ``DeviceIndex`` duck type (``idt``, ``primary``,
  ``seq_len``, ``L2``, ``device``, the launch device, ...).  Its row
  accessors (``occ_row``, ``mark_row_at``, ``sa_marked_at``) gather each
  slab's own rows and zeros elsewhere and sum them, the ``psum``'s
  counterpart, so ``device/occ.py``'s plain functions and
  ``smem_fused.rounds12_plain`` run over it unchanged on the CPU;
* on a card, the wrappers ``occ.sa_lookup``, ``occ.bwt_extend`` and
  ``smem_fused.rounds12_megaq`` launch the TP instantiations of K-sa
  (the marked walk), K-ext and K2: the kernels of ``csrc/occ.cu`` and
  ``csrc/smem.cu`` with each row's address taken from a slab table
  (``kernel_table``: the slabs' addresses, first rows and devices) by
  an unrolled select on the first rows (``csrc/fm.cuh:Slabs``).  A slab
  on another card is read through peer access, which the C entry
  enables, or refuses with an error the wrapper raises; slabs are never
  copied to the launch device.

``occ4`` has no kernel and stays the plain function.  Seeding over the
slabs is mode megaq's (``device/smem.py:collect_intv_device(...,
tp=)``): K2 and the fused SA walk on the slabs, round 3 (K3), the
extension and ``pac`` on the aligner's whole index, as tpubwa does.  A
stock-bwa index (no text-position marks) has no walk over the slabs:
seeding and the SA walk raise, as tpubwa's do.
"""

from __future__ import annotations

import copy
import ctypes
from typing import Sequence

import numpy as np
import torch

from ..device.occ import DeviceIndex
from .sharding import resolve

MAX_SLABS = 8   # slabs at most (tpubwa's test mesh, csrc/fm.cuh:kMaxSlabs)
SLABBED = ("occ_blocks", "mark_rows", "sa_marked")
_NO_MARKS = "TP seeding needs a marked index"


def _pad_rows(a: np.ndarray, mult: int) -> np.ndarray:
    """``a`` with zero rows appended to a multiple of ``mult`` rows
    (tpubwa/dist/index_tp.py:_pad_rows)."""
    n = a.shape[0]
    m = ((n + mult - 1) // mult) * mult
    if m == n:
        return a
    return np.concatenate([a, np.zeros((m - n,) + a.shape[1:], a.dtype)])


class TpIndex:
    """The FM-index of ``fmi`` with ``occ_blocks``, ``mark_rows`` and
    ``sa_marked`` in ``len(devices)`` row slabs (at most ``MAX_SLABS``),
    slab i on ``devices[i]``, and ``L2`` on each.  ``slab_rows[name]`` is
    the rows of each of an array's slabs, ``rows_total[name]`` its padded
    total (``slab_rows * n``); ``slabs[name]`` the slabs.  A mark-less
    index slabs ``occ_blocks`` alone.  ``device`` is the launch device,
    ``devices[0]`` (``at`` gives the same slabs for another)."""

    def __init__(self, fmi, devices: Sequence):
        self._cut(DeviceIndex.from_fmindex(fmi, "cpu"), devices)

    @classmethod
    def from_index(cls, didx: DeviceIndex, devices: Sequence) -> "TpIndex":
        """The slabs of the port's ``didx`` (one made by
        ``DeviceIndex.from_numpy`` from tpubwa's arrays too)."""
        self = cls.__new__(cls)
        self._cut(didx, devices)
        return self

    def _cut(self, didx: DeviceIndex, devices: Sequence):
        devices = [resolve(d) for d in devices]
        n = len(devices)
        if not 1 <= n <= MAX_SLABS:
            raise ValueError(f"{n} slabs: a TpIndex takes 1 to {MAX_SLABS}")
        self.devices, self.n, self.device = devices, n, devices[0]
        self.idt, self.primary, self.seq_len = (didx.idt, didx.primary,
                                                didx.seq_len)
        self.l_pac, self.mark_D = didx.l_pac, didx.mark_D
        fm = {k: v.cpu().numpy() for k, v in didx.upload_fm().items()}
        self.slabs, self.slab_rows, self.rows_total = {}, {}, {}
        for name in SLABBED if self.mark_D else SLABBED[:1]:
            a = _pad_rows(fm[name], n)
            per = len(a) // n
            self.rows_total[name], self.slab_rows[name] = len(a), per
            self.slabs[name] = [
                torch.from_numpy(a[i * per:(i + 1) * per].copy()).to(d)
                for i, d in enumerate(devices)]
        L2 = torch.from_numpy(fm["L2"].copy())
        self._l2 = {d: L2.to(d) for d in dict.fromkeys(devices)}

    @property
    def np_idt(self):
        """numpy dtype for ranks and positions."""
        return np.int64 if self.idt == torch.int64 else np.int32

    @property
    def L2(self) -> torch.Tensor:
        """L2 on the launch device."""
        t = self._l2.get(self.device)
        if t is None:
            t = self._l2.setdefault(self.device,
                                    self._l2[self.devices[0]].to(self.device))
        return t

    def at(self, device) -> "TpIndex":
        """The same slabs, launched from ``device`` (a replica's card; L2
        goes there, 5 values)."""
        view = copy.copy(self)
        view.device = resolve(device)
        return view

    def check_marked(self):
        """Raise NotImplementedError where the index has no text-position
        marks: no walk runs over the slabs then (tpubwa's)."""
        if not self.mark_D:
            raise NotImplementedError(_NO_MARKS)

    # -- the row accessors of the plain functions (device/occ.py) -----
    def _routed(self, name: str, idx: torch.Tensor, row: bool):
        """Rows (``row``) or values ``idx`` of array ``name``: each slab's
        own, zeros elsewhere, summed."""
        per = self.slab_rows[name]
        out = None
        for s, slab in enumerate(self.slabs[name]):
            li = idx.long() - s * per
            mine = (li >= 0) & (li < per)
            v = slab[torch.clamp(li, 0, per - 1).to(slab.device)].to(
                idx.device)
            v = torch.where(mine[..., None] if row else mine, v,
                            torch.zeros_like(v))
            out = v if out is None else out + v
        return out

    def occ_row(self, blk):
        return self._routed("occ_blocks", blk, True)

    def mark_row_at(self, blk):
        return self._routed("mark_rows", blk, True)

    def sa_marked_at(self, idx):
        return self._routed("sa_marked", idx, False)

    def sa_sample_at(self, idx):
        # the rank-sampled SA serves only mark-less (stock bwa) indexes,
        # which have no walk over the slabs
        raise NotImplementedError(_NO_MARKS)

    # -- the kernels' slab tables ------------------------------------
    def kernel_table(self, name: str):
        """Array ``name``'s slab table as the TP entries of csrc/occ.cu
        and csrc/smem.cu take it (csrc/fm.cuh:slab_table): int64 [3 n],
        the slabs' device addresses, their first rows and their
        devices."""
        per = self.slab_rows[name]
        slabs = self.slabs[name]
        return (ctypes.c_int64 * (3 * self.n))(
            *(s.data_ptr() for s in slabs),
            *(i * per for i in range(self.n)),
            *(s.device.index for s in slabs))

    def nbytes(self) -> dict:
        """{device: bytes of the slabs on it}."""
        out = {}
        for slabs in self.slabs.values():
            for s in slabs:
                out[str(s.device)] = (out.get(str(s.device), 0)
                                      + s.numel() * s.element_size())
        return out

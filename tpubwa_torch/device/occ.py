"""Index state resident on the device, the counterpart of
tpubwa/device/occ.py's ``DeviceIndex``.

This slice seeds on the host, so the device holds only what the
descriptor extension reads: the 2-bit forward reference packed 16
codes per word (``pac_words``) and its length.  The occ blocks and the
SA arrays come up with the seeding port (ROADMAP Queue 1 items 4-5).

torch has no ``>>`` or ``>`` for uint32 on the CPU, so pac words are
kept as int32 bit patterns; every consumer masks after each shift.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Mapping

import numpy as np
import torch

from ..index.fmindex import FMIndex, pack_bwt_words


def _fits_i32(seq_len: int) -> bool:
    """Ranks/positions live in [-1, seq_len+1]; int32 covers genomes
    under 2^31-2 doubled bases, human-scale indexes take int64."""
    return seq_len + 2 < (1 << 31)


@dataclass
class DeviceIndex:
    """Reference arrays resident on ``device`` + static scalars."""
    pac_words: torch.Tensor   # int32 bit patterns [ceil(l_pac/16)]
    l_pac: int
    seq_len: int              # doubled text length + 1 (FMIndex.seq_len)

    @property
    def np_idt(self):
        """Dtype for positions (int32 when they fit)."""
        return np.int32 if _fits_i32(self.seq_len) else np.int64

    @property
    def device(self) -> torch.device:
        return self.pac_words.device

    @classmethod
    def from_fmindex(cls, fmi: FMIndex, device) -> "DeviceIndex":
        pw = pack_bwt_words(fmi.bnt.codes)
        return cls._from_words(pw, int(fmi.bnt.l_pac), int(fmi.seq_len),
                               device)

    @classmethod
    def from_numpy(cls, arrays: Mapping, device="cuda") -> "DeviceIndex":
        """Carry a tpubwa DeviceIndex, fetched as numpy arrays
        (``pac_words`` uint32) and scalars (``l_pac``, ``seq_len``),
        into the port.  Other fields of the mapping are not used yet."""
        return cls._from_words(np.asarray(arrays["pac_words"]),
                               int(arrays["l_pac"]),
                               int(arrays["seq_len"]), device)

    @classmethod
    def _from_words(cls, words, l_pac, seq_len, device) -> "DeviceIndex":
        bits = np.ascontiguousarray(words, np.uint32).view(np.int32)
        return cls(pac_words=torch.from_numpy(bits.copy()).to(device),
                   l_pac=l_pac, seq_len=seq_len)

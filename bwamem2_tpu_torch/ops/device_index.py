"""Device-resident FM-index tables (torch).

This slice moves only what seed extension reads: the doubled genome
(forward + reverse complement, the .0123 buffer), uint8[2*l_pac] with one
2-bit code per byte, or packed 4 chars/byte once 2*l_pac reaches
REF_PACK_MIN (a human-scale doubled genome is 6.2 GB unpacked, 1.55 GB
packed).  The occurrence and suffix-array tables arrive with device seeding.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..index.fmindex import FMIndex
from . import resolve_device


@dataclass
class DeviceFMIndex:
    ref: torch.Tensor         # uint8[2*l_pac], or 2-bit packed (ref_packed)
    ref_packed: bool
    device: torch.device

    REF_PACK_MIN = 1 << 31

    @classmethod
    def from_host(cls, fm: FMIndex, device=None) -> "DeviceFMIndex":
        """Carry the loaded index's genome onto `device` ("cuda" unless
        "cpu" is asked for).  Packing: char k of byte b sits at bits 2k..2k+1
        (LSB first), the tail padded with zeros to whole bytes."""
        dev = resolve_device(device)
        ref = np.ascontiguousarray(fm.ref_string, np.uint8)
        ref_packed = ref.shape[0] >= cls.REF_PACK_MIN
        if ref_packed:
            pad = (-ref.shape[0]) % 4
            if pad:
                ref = np.concatenate([ref, np.zeros(pad, np.uint8)])
            r = ref.reshape(-1, 4)
            ref = (r[:, 0] | (r[:, 1] << 2) | (r[:, 2] << 4)
                   | (r[:, 3] << 6)).astype(np.uint8)
        return cls(ref=torch.from_numpy(ref).to(dev), ref_packed=ref_packed,
                   device=dev)


def take_ref(ref: torch.Tensor, pos: torch.Tensor, packed: bool
             ) -> torch.Tensor:
    """Doubled-genome char at int64 `pos` (int32 in [0,4)).

    Out-of-range positions are clipped (unpacked) or wrap within the last
    byte (packed) — callers mask those lanes, only in-range values are
    consumed."""
    n = ref.shape[0]
    if not packed:
        return ref[pos.clamp(0, n - 1)].to(torch.int32)
    b = ref[(pos >> 2).clamp(0, n - 1)].to(torch.int32)
    return (b >> ((pos.to(torch.int32) & 3) * 2)) & 3

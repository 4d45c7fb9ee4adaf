"""Torch device backend: feeds the host pipeline (align/pipeline.py) with
seeding results and scores the extension pairs on the device.

This slice runs one device stage, banded-SW extension scoring (ops/bsw.py,
the CUDA kernel csrc/bsw_extend.cu).  Seeding and SA resolution run in the
port's native host runtime (the exact C++ oracle the JAX package falls back
to for long and overflowed reads), and mate rescue runs on the host scalar
path inside hostrt.sam_pe_batch: the backend has no `rescue_batch` yet.

Uploading each chunk's padded read grid (`_bsw.encj`) is what engages the
all-native flat extension path (Aligner._flat_ext_ok), whose scoring
rounds call DeviceBSW.run_arrays.
"""

from __future__ import annotations

import numpy as np
import torch

from ..index.fmindex import FMIndex
from ..native import hostrt
from ..utils.profiling import PROF
from . import resolve_device, round_up
from .bsw import DeviceBSW
from .device_index import DeviceFMIndex


def _pad_reads(encs: list[np.ndarray], L: int | None = None):
    """nt4 reads -> int8[N, L] grid padded with 4 (L a multiple of 8)."""
    N = len(encs)
    L = round_up(L or max((len(e) for e in encs), default=1), 8)
    enc = np.full((N, L), 4, dtype=np.int8)
    lens = np.zeros((N,), dtype=np.int32)
    for i, e in enumerate(encs):
        enc[i, : len(e)] = e
        lens[i] = len(e)
    return enc, lens


class TorchBackend:
    # the object-path extension (long reads, where the flat path does not
    # apply) keeps the native host kernels: extend_chains' defaults
    left_bsw_kernel = None
    right_bsw_kernel = None

    def __init__(self, fm: FMIndex, opt, device=None):
        """device: "cuda" (the default) or "cpu"; CUDA without a card
        raises."""
        self.fm = fm
        self.opt = opt
        self.device = resolve_device(device)
        self.dfm = DeviceFMIndex.from_host(fm, self.device)
        self._bsw = DeviceBSW(self.dfm, opt)

    def collect_smems(self, encs: list[np.ndarray], opt) -> list[list[tuple]]:
        enc, _ = _pad_reads(encs)
        N, L = enc.shape
        # the extension kernels flatten (seqid, qoff) to seqid*L+qoff in
        # int32 — guard the precondition here, at attach time
        if N * L >= 2**31:
            raise ValueError(f"read grid {N}x{L} overflows int32 flat "
                             "offsets")
        self._bsw.encj = torch.from_numpy(enc).to(self.device)
        with PROF("seeding.host"):
            return hostrt.collect_smems_reads(self.fm, encs, opt)

    def sa_lookup(self, positions: np.ndarray) -> np.ndarray:
        with PROF("sa_lookup"):
            return hostrt.sa_entries_host(self.fm, positions)

    def read_grid_width(self) -> int:
        encj = self._bsw.encj
        return 0 if encj is None else int(encj.shape[1])

"""Torch device backend: feeds the host pipeline (align/pipeline.py) with
seeding results and scores the extension pairs and the mate-rescue
problems on the device.

Three device stages run here:
  * seeding + SA resolution (`collect_chunk`): ops/seed.py:FusedSeeder
    with the kernels csrc/smem_collect.cu and csrc/sa_resolve.cu; reads
    whose SMEMs outrun the per-read slot cap are re-seeded exactly by the
    native host oracle (`_patch_chunk`) and counted as
    `overflow.fused_read`;
  * banded-SW extension scoring (ops/bsw.py, csrc/bsw_extend.cu);
  * mate rescue (`rescue_batch`): ops/kswv.py:DeviceKswv with the kernel
    csrc/kswv.cu, for every problem of the chunk whatever its length; a
    rescue SW that later finds no batch result runs on the host scalar
    kernel and is counted as `overflow.rescue_miss` (align/pipeline.py).
Every chunk seeds on the device, whatever its read count and read length
(the kernel's candidate scratch is sized per grid).

Uploading each chunk's padded read grid (`_bsw.encj`) is what engages the
all-native flat extension path (Aligner._flat_ext_ok), whose scoring
rounds call DeviceBSW.run_arrays.
"""

from __future__ import annotations

import numpy as np
import torch

from ..align.chain import sa_positions_batch
from ..index.fmindex import FMIndex
from ..native import hostrt
from ..utils.profiling import PROF
from . import resolve_device, round_up
from .bsw import DeviceBSW
from .device_index import DeviceFMIndex
from .kswv import DeviceKswv
from .seed import FusedSeeder


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
        self._kswv = DeviceKswv(self.dfm, opt)
        self.seeder = FusedSeeder(self.dfm)

    def _attach_grid(self, encs):
        enc, lens = _pad_reads(encs)
        N, L = enc.shape
        # the extension kernels flatten (seqid, qoff) to seqid*L+qoff in
        # int32 — guard the precondition here, at attach time
        if N * L >= 2**31:
            raise ValueError(f"read grid {N}x{L} overflows int32 flat "
                             "offsets")
        self._bsw.encj = torch.from_numpy(enc).to(self.device)
        return lens

    def collect_chunk(self, encs: list[np.ndarray], opt):
        """Fused seeding: (smem_off, m, n, s, occ_off, coords) ready for
        the native chainer — what collect_smems +
        chain.sa_positions_batch + sa_lookup give on the host."""
        lens = self._attach_grid(encs)
        if not lens.any():          # no bases: no SMEMs
            e32, e64 = np.zeros(0, np.int32), np.zeros(0, np.int64)
            return (np.zeros(len(encs) + 1, np.int64), e32, e32.copy(), e64,
                    np.zeros(1, np.int64), e64.copy())
        lensj = torch.from_numpy(lens).to(self.device)
        with PROF("seeding.device"):
            cnt, m, n, s, coords = self.seeder.run(self._bsw.encj, lensj,
                                                   opt)
        with PROF("seeding.assemble"):
            return self._assemble_chunk(encs, opt, cnt, m, n, s, coords)

    def _assemble_chunk(self, encs, opt, cnt, m, n, s, coords):
        NR = len(encs)
        bad = cnt < 0
        PROF.count("overflow.fused_read", int(bad.sum()), NR)
        smem_off = np.zeros(NR + 1, np.int64)
        np.cumsum(np.maximum(cnt, 0), out=smem_off[1:])
        if bad.any():
            return self._patch_chunk(encs, opt, bad, smem_off, m, n, s,
                                     coords)
        occ_off = np.zeros(len(s) + 1, np.int64)
        np.cumsum(np.minimum(s, opt.max_occ), out=occ_off[1:])
        return smem_off, m, n, s, occ_off, coords

    def _patch_chunk(self, encs, opt, bad, smem_off, m, n, s, coords):
        """Merge the exact host oracle's output for the reads that outran
        the device's slot cap (they hold no device entries) into the
        device arrays, keeping read order."""
        badidx = np.nonzero(bad)[0]
        sub = hostrt.collect_smems_reads(self.fm, [encs[r] for r in badidx],
                                         opt)
        pos_p, off_p, m_p, n_p, s_p, occ_p = sa_positions_batch(opt, sub)
        coords_p = hostrt.sa_entries_host(self.fm, pos_p)
        NR = len(encs)
        rid_d = np.repeat(np.arange(NR), np.diff(smem_off))
        rid_h = np.repeat(badidx, np.diff(off_p))
        rid = np.concatenate([rid_d, rid_h])
        order = np.argsort(rid, kind="stable")
        m_f = np.concatenate([m, m_p])[order].astype(np.int32)
        n_f = np.concatenate([n, n_p])[order].astype(np.int32)
        s_f = np.concatenate([s, s_p])[order].astype(np.int64)
        crid = np.concatenate([
            np.repeat(rid_d, np.minimum(s, opt.max_occ)),
            np.repeat(rid_h, np.diff(occ_p))])
        c_f = np.concatenate([coords, coords_p])[
            np.argsort(crid, kind="stable")].astype(np.int64)
        smem_off = np.zeros(NR + 1, np.int64)
        np.cumsum(np.bincount(rid, minlength=NR), out=smem_off[1:])
        occ_off = np.zeros(len(s_f) + 1, np.int64)
        np.cumsum(np.minimum(s_f, opt.max_occ), out=occ_off[1:])
        assert occ_off[-1] == len(c_f)
        return smem_off, m_f, n_f, s_f, occ_off, c_f

    def read_grid_width(self) -> int:
        encj = self._bsw.encj
        return 0 if encj is None else int(encj.shape[1])

    def rescue_batch(self, desc: dict) -> np.ndarray | None:
        """Score a chunk's pre-collected rescue problems (hostrt.
        rescue_pre_batch / pairing.batch_rescue_pre) against this thread's
        read grid: int32[n, 7] native ksw_align tuples; None when no grid is
        attached on this thread (no chunk in flight here)."""
        encj = self._bsw.encj
        if encj is None:
            return None
        return self._kswv.align_batch(encj, desc)

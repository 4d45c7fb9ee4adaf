"""Torch device backend: feeds the host pipeline (align/pipeline.py) with
seeding results and scores the extension pairs and the mate-rescue
problems on the device.

Three device stages run here:
  * seeding + SA resolution (`collect_chunk`): ops/seed.py:FusedSeeder
    with the kernels csrc/smem_collect.cu and csrc/sa_resolve.cu; reads
    whose SMEMs outrun their slots or the kernel's on-chip candidate list
    are re-seeded exactly by the native host oracle (`_patch_chunk`) and
    counted as `overflow.fused_read`;
  * banded-SW extension scoring (ops/bsw.py:DeviceBSW): in-cap pairs on
    csrc/bsw_extend.cu, long pairs (qlen > 256 or tlen > 608: long reads)
    on csrc/bsw_shear.cu;
  * mate rescue (`rescue_batch`): ops/kswv.py:DeviceKswv with the kernel
    csrc/kswv.cu, for every problem of the chunk whatever its length; a
    rescue SW that later finds no batch result runs on the host scalar
    kernel and is counted as `overflow.rescue_miss` (align/pipeline.py).
Every chunk seeds on the device whatever its read count.  A read longer
than the read grid takes (TorchBackend.grid_read_cap: GRID_MAX_READ_LEN
bases, or less where N x L would pass int32) gets an empty grid row and is
seeded alone on the exact host oracle through `_patch_chunk`, counted as
`overflow.long_read`; the chunk's other reads stay on the device.  The
seeding kernel's buffers are each read's own slots, linear in the chunk's
bases (SmemCollect.plan_bytes).

Uploading each chunk's padded read grid (`_bsw.encj`) is what engages the
all-native flat extension path (Aligner._flat_ext_ok), whose scoring
rounds call DeviceBSW.run_arrays.  A chunk the flat path does not take
(reads longer than about 720 bases at default options, every read of -x
pacbio / -x ont2d, or a read off the grid) extends on the object path
(align/extend.py:extend_chains), whose kernels are `left_bsw_kernel` /
`right_bsw_kernel`, DeviceBSW's left_kernel / right_kernel: the pairs of
a read off the grid run there on the native host kernel, counted as
`overflow.bsw_host_tail`, every other pair on the card.
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
from .cuda_build import launch_tally
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


def host_seeding(fm, encs, opt):
    """The exact host oracle's six seeding arrays (rt_collect_smems_reads,
    the max_occ sampling of sa_positions_batch, rt_sa_entries)."""
    sub = hostrt.collect_smems_reads(fm, encs, opt)
    pos, smem_off, m, n, s, occ_off = sa_positions_batch(opt, sub)
    return (smem_off, m.astype(np.int32), n.astype(np.int32),
            s.astype(np.int64), occ_off, hostrt.sa_entries_host(fm, pos))


class TorchBackend:
    # the longest read a chunk's read grid takes (the JAX package's limit
    # for device seeding); a longer one is seeded alone on the host oracle
    GRID_MAX_READ_LEN = 32000

    def __init__(self, fm: FMIndex, opt, device=None):
        """device: "cuda" (the default), "cuda:i" or "cpu"; CUDA without a
        card raises.  Everything the backend owns (the index, the read
        grid, scratch and outputs) lives on this one device.  `launches`
        counts the kernel launches of this backend's chunks by kernel name
        (cuda_build.launch_tally), whichever worker thread runs them."""
        self.fm = fm
        self.opt = opt
        self.device = resolve_device(device)
        self.dfm = DeviceFMIndex.from_host(fm, self.device)
        self._bsw = DeviceBSW(self.dfm, opt)
        self._kswv = DeviceKswv(self.dfm, opt)
        self.seeder = FusedSeeder(self.dfm)
        self.launches: dict[str, int] = {}

    @property
    def left_bsw_kernel(self):
        """The object path's extension kernels (extend_chains): DeviceBSW
        on this thread's read grid."""
        return self._bsw.left_kernel

    @property
    def right_bsw_kernel(self):
        return self._bsw.right_kernel

    @classmethod
    def grid_read_cap(cls, N: int) -> int:
        """The longest read a grid of N rows takes: GRID_MAX_READ_LEN, or
        less where the padded N x L would pass the int32 flat offsets
        (seqid * L + qoff) of the extension and rescue kernels."""
        return min(cls.GRID_MAX_READ_LEN, (2**31 - 1) // max(N, 1) // 8 * 8)

    def _attach_grid(self, encs):
        """Start a chunk on this thread: its read grid on the device, and
        this backend's tally for the thread's launches."""
        launch_tally(self.launches)
        enc, lens = _pad_reads(encs)
        self._bsw.encj = torch.from_numpy(enc).to(self.device)
        self._bsw.lens = lens
        return lens

    def collect_chunk(self, encs: list[np.ndarray], opt):
        """Fused seeding: (smem_off, m, n, s, occ_off, coords) ready for
        the native chainer — what collect_smems +
        chain.sa_positions_batch + sa_lookup give on the host.  A read
        over grid_read_cap(N) bases has an empty row in the read grid and
        is seeded on the host oracle."""
        NR = len(encs)
        long = np.array([len(e) for e in encs], np.int64) \
            > self.grid_read_cap(NR)
        PROF.count("overflow.long_read", int(long.sum()), NR)
        lens = self._attach_grid([e[:0] if lg else e
                                  for e, lg in zip(encs, long)])
        if lens.any():
            lensj = torch.from_numpy(lens).to(self.device)
            with PROF("seeding.device"):
                cnt, m, n, s, coords = self.seeder.run(self._bsw.encj,
                                                       lensj, opt)
        else:                       # no bases on the grid: no SMEMs
            cnt = np.zeros(NR, np.int32)
            m, n = np.zeros(0, np.int32), np.zeros(0, np.int32)
            s, coords = np.zeros(0, np.int64), np.zeros(0, np.int64)
        with PROF("seeding.assemble"):
            return self._assemble_chunk(encs, opt, cnt, m, n, s, coords,
                                        long)

    def _assemble_chunk(self, encs, opt, cnt, m, n, s, coords, long):
        NR = len(encs)
        bad = cnt < 0
        PROF.count("overflow.fused_read", int(bad.sum()),
                   NR - int(long.sum()))
        smem_off = np.zeros(NR + 1, np.int64)
        np.cumsum(np.maximum(cnt, 0), out=smem_off[1:])
        if bad.any() or long.any():
            return self._patch_chunk(encs, opt, bad | long, smem_off, m, n,
                                     s, coords)
        occ_off = np.zeros(len(s) + 1, np.int64)
        np.cumsum(np.minimum(s, opt.max_occ), out=occ_off[1:])
        return smem_off, m, n, s, occ_off, coords

    def _patch_chunk(self, encs, opt, bad, smem_off, m, n, s, coords):
        """Merge the exact host oracle's output for the reads that outran
        their device slots or candidate list, or that the read grid does
        not hold (none of them holds device entries), into the device
        arrays, keeping read order."""
        badidx = np.nonzero(bad)[0]
        off_p, m_p, n_p, s_p, occ_p, coords_p = host_seeding(
            self.fm, [encs[r] for r in badidx], opt)
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

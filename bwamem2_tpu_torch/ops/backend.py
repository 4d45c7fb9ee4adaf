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
Sharded index (`sharded=True`, parallel/shard_index.py): the occ and SA
tables split by row range over a list of cards (one card may hold several
shards).  `collect_chunk` then returns None and the pipeline seeds through
`collect_smems` and `sa_lookup` instead, the per-stage path of the JAX
package's mesh mode (bwamem2_tpu/ops/backend.py:410-695): round 1's pivot
chain (csrc/round1_chain.cu), the forward candidates and backward walks of
each pivot (csrc/round2_forward.cu, csrc/round2_backward.cu) for round 1
and for round 2's re-seeding, round 3 (csrc/round3_replay.cu), then
sa_resolve, each stage's lanes split over the cards
(shard_index.split_lanes).  A read with more pivots than pivot_cap(L) is
seeded on the host oracle (`overflow.r1_pivot_cap`), a pivot with more
forward candidates than ROUND2_MAX_CAND runs again on the card at width L,
which none passes (`seeding.cand_wide*`).
Extension and rescue run on the first card against its copy of the
genome, as in the replicated mode.
Legacy round 1 (`pivot_seeding=False`, DeviceBackend(pivot_seeding=False)
of the JAX package): `collect_chunk` returns None too, and round 1 of
`collect_smems` is the per-end grid walk with on-chip emission and
compaction (csrc/round1_compact.cu), each lane started from the K-mer
table of index/klut.py where it applies (`use_klut`, depth
klut.default_k(l_pac)); a read with more than ROUND1_CAP round-1 SMEMs is
seeded on the host oracle (`overflow.r1_compact_cap`).  Rounds 2 and 3 and
sa_resolve run on the per-stage kernels as over a sharded index; only the
replicated index takes this route, as in the JAX package.

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

import time

import numpy as np
import torch

from ..align.chain import sa_positions_batch
from ..index.fmindex import FMIndex
from ..index.klut import load_or_build_klut
from ..native import hostrt
from ..parallel.shard_index import shard_index, split_lanes
from ..utils.profiling import PROF
from . import bucket_pow2, resolve_device, round_up
from .bsw import DeviceBSW
from .cuda_build import launch_tally
from .device_index import DeviceFMIndex
from .kswv import DeviceKswv
from .seed import FusedSeeder, sa_resolve
from .smem import round1_chain, round1_compact, round2_backward, \
    round2_forward, round3_replay

# the per-stage seeding's route rules (bwamem2_tpu/ops/backend.py): they
# decide only where a pivot or a read is seeded, never what it gets
ROUND2_MAX_CAND = 24   # forward candidates a pivot keeps on the device
ROUND1_PIVOT_CAP = 48  # round-1 pivots a read of up to 512 bases keeps
ROUND1_CAP = 24        # round-1 SMEM slots a read keeps (legacy round 1)


def pivot_cap(L: int) -> int:
    """Round-1 pivot slots per read for a read grid of width L: about one
    pivot per SMEM, so L // 8 for long reads (~L / 18 observed at 10 %
    error)."""
    return ROUND1_PIVOT_CAP if L <= 512 else min(round_up(L // 8, 64), 4096)


def _lanes_of(counts: np.ndarray) -> tuple:
    """(owner int32, slot int32) of every lane, `counts[i]` lanes per
    owner i in order."""
    owner = np.repeat(np.arange(len(counts), dtype=np.int32), counts)
    slot = (np.arange(len(owner), dtype=np.int64)
            - np.repeat(np.cumsum(counts) - counts, counts)).astype(np.int32)
    return owner, slot


def _pad_t(t: torch.Tensor, n: int, fill) -> torch.Tensor:
    return torch.cat([t, torch.full((n - t.shape[0],), fill, dtype=t.dtype,
                                    device=t.device)]).contiguous()


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

    def __init__(self, fm: FMIndex, opt, device=None, devices=None,
                 sharded: bool = False, pivot_seeding: bool = True,
                 use_klut: bool = True, index_prefix: str | None = None):
        """device: "cuda" (the default), "cuda:i" or "cpu"; CUDA without a
        card raises.  Everything the backend owns (the index, the read
        grid, scratch and outputs) lives on this one device.  With
        `sharded`, the index is split over `devices` instead (one shard
        each; the same card may repeat), the first of which takes the
        device's part.  pivot_seeding=False seeds round 1 with the legacy
        per-end grid walk (round1_compact), started from the K-mer table
        where use_klut (built by index/klut.py, cached at
        {index_prefix}.klut{K}.npz when a prefix is given); it takes the
        replicated index only.  `launches` counts the kernel launches of
        this backend's chunks by kernel name (cuda_build.launch_tally),
        whichever worker thread runs them."""
        self.fm = fm
        self.opt = opt
        self.sharded = sharded
        self.pivot_seeding = pivot_seeding
        if sharded and not pivot_seeding:
            raise ValueError("a sharded index seeds round 1 through the "
                             "pivot chain (pivot_seeding=True)")
        lut = None
        if use_klut and not pivot_seeding:
            lut = load_or_build_klut(fm, index_prefix)
        self.lut_k = lut[0] if lut else 0
        if sharded:
            if not devices:
                raise ValueError("a sharded backend needs its devices")
            # the tables go from the host straight to their shards
            self.views = shard_index(DeviceFMIndex.from_host(fm, "cpu"),
                                     devices)
            self.dfm = self.views[0]
            self.device = self.dfm.device
        else:
            self.device = resolve_device(device)
            self.dfm = DeviceFMIndex.from_host(fm, self.device, lut)
            self.views = [self.dfm]
            self.seeder = FusedSeeder(self.dfm)
        self._bsw = DeviceBSW(self.dfm, opt)
        self._kswv = DeviceKswv(self.dfm, opt)
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

    def _attach_long(self, encs):
        """Attach the chunk's read grid with an empty row for each read
        longer than grid_read_cap (counted as overflow.long_read); returns
        (long bool[N], the grid's lengths)."""
        NR = len(encs)
        long = np.array([len(e) for e in encs], np.int64) \
            > self.grid_read_cap(NR)
        PROF.count("overflow.long_read", int(long.sum()), NR)
        return long, self._attach_grid([e[:0] if lg else e
                                        for e, lg in zip(encs, long)])

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
        is seeded on the host oracle.  None over a sharded index or with
        the legacy round 1: the caller seeds through collect_smems and
        sa_lookup."""
        if self.sharded or not self.pivot_seeding:
            return None
        NR = len(encs)
        long, lens = self._attach_long(encs)
        if lens.any():
            with PROF("seeding.device"):
                cnt, m, n, s, coords = self.seeder.run(self._bsw.encj, lens,
                                                       opt)
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

    # ------------------------------------------- per-stage seeding (sharded)
    def _lane_pad(self, n: int) -> int:
        """Lane counts split evenly over the index's cards."""
        return round_up(n, len(self.views))

    def collect_smems(self, encs: list[np.ndarray], opt) -> list[list[tuple]]:
        """mem_collect_smem's three rounds for every read of a chunk
        through the per-stage kernels: per read, (rid, m, n, k, 0, s)
        tuples sorted by (m, n), as the host oracle gives them.  The read
        grid is the chunk's (also the extension's), padded with empty reads
        to a multiple of the card count (they emit nothing); a read the
        grid does not hold (overflow.long_read) and one with more round-1
        pivots than pivot_cap (overflow.r1_pivot_cap) or, with the legacy
        round 1, more round-1 SMEMs than ROUND1_CAP
        (overflow.r1_compact_cap) go to the host oracle."""
        NR = len(encs)
        long, lens = self._attach_long(encs)
        enc = self._bsw.encj
        pad = self._lane_pad(NR) - NR
        enc = torch.cat([enc, torch.full((pad, enc.shape[1]), 4,
                                         dtype=enc.dtype, device=enc.device)])
        lensj = torch.from_numpy(np.concatenate(
            [lens, np.zeros(pad, np.int32)])).to(self.device)
        L = enc.shape[1]
        per_read: list[list[tuple]] = [[] for _ in encs]

        # ---- round 1: the pivot chain, then each pivot's candidates; or
        # the legacy per-end walk, compacted on the card ----
        t0 = time.perf_counter()
        if self.pivot_seeding:
            cap = pivot_cap(L)
            r1 = split_lanes(
                self.views, lambda v, e, ln: round1_chain(v, e, ln, cap),
                (enc, lensj))
        else:
            r1 = round1_compact(self.dfm, enc, lensj, self.lut_k,
                                opt.min_seed_len, ROUND1_CAP)
        r3 = None
        if opt.max_mem_intv > 0:
            msl1 = max(opt.min_seed_len + 1, 2)
            cap3 = L // msl1 + 1    # each seed advances x by >= msl1
            r3 = split_lanes(self.views, lambda v, e, ln: round3_replay(
                v, e, ln, int(opt.max_mem_intv), msl1, cap3),
                (enc, lensj))
        if self.pivot_seeding:
            npiv, px = (a[:NR].cpu().numpy() for a in r1)
            over = npiv > cap
            PROF.count("overflow.r1_pivot_cap", int(over.sum()), NR)
            host = over | long
            take = np.where(host, 0, npiv)
            rids = np.repeat(np.arange(NR, dtype=np.int32), take)
            xs = px[np.arange(cap)[None, :] < take[:, None]].astype(np.int32)
            PROF.add("seeding.round1", time.perf_counter() - t0)
            if len(rids):
                with PROF("seeding.round1b"):
                    self._round2(enc, rids, xs, np.ones(len(rids), np.int64),
                                 opt, per_read, "r1")
        else:
            cnt, n1, b1, s1, k1 = (a[:NR].cpu().numpy() for a in r1)
            over = cnt > ROUND1_CAP
            PROF.count("overflow.r1_compact_cap", int(over.sum()), NR)
            host = over | long
            rid, j = np.nonzero(np.arange(ROUND1_CAP)[None, :]
                                < np.where(host, 0, cnt)[:, None])
            for r, m, n, k, s in zip(rid.tolist(), b1[rid, j].tolist(),
                                     n1[rid, j].tolist(), k1[rid, j].tolist(),
                                     s1[rid, j].tolist()):
                per_read[r].append((r, m, n, k, 0, s))
            PROF.add("seeding.round1", time.perf_counter() - t0)

        # ---- round 2: re-seed long low-occurrence SMEMs ----
        split_len = int(opt.min_seed_len * opt.split_factor + 0.499)
        piv = [(rid, (n + 1 + m) >> 1, ss + 1)
               for rid in range(NR) if not host[rid]
               for (_, m, n, _, _, ss) in per_read[rid]
               if (n + 1 - m) >= split_len and ss <= opt.split_width]
        if piv:
            p = np.array(piv, np.int64)
            with PROF("seeding.round2"):
                self._round2(enc, p[:, 0].astype(np.int32),
                             p[:, 1].astype(np.int32), p[:, 2], opt,
                             per_read)

        # ---- round 3 ----
        if r3 is not None:
            t0 = time.perf_counter()
            n3, x3, e3, s3, k3 = (a[:NR].cpu().numpy() for a in r3)
            for rid in np.nonzero((n3 > 0) & ~host)[0].tolist():
                per_read[rid] += [(rid, int(x3[rid, j]), int(e3[rid, j]),
                                   int(k3[rid, j]), 0, int(s3[rid, j]))
                                  for j in range(int(n3[rid]))]
            PROF.add("seeding.round3", time.perf_counter() - t0)

        # ---- reads routed to the host oracle (sorted there) ----
        bad = np.nonzero(host)[0]
        if len(bad):
            sub = hostrt.collect_smems_reads(self.fm,
                                             [encs[r] for r in bad], opt)
            for r, out in zip(bad.tolist(), sub):
                per_read[r] = [(r,) + t[1:] for t in out]
        for rid in np.nonzero(~host)[0].tolist():
            per_read[rid].sort(key=lambda t: (t[1] << 32) | t[2])
        return per_read

    def _pivots(self, rids, xs, mis) -> tuple:
        """Pivot descriptors on the first card, padded to a lane count that
        splits over the cards with at least one dead pivot (rid -1, x 0)
        at the end: (rid int32, x int32, min_intv int64)."""
        n = len(rids)
        P = self._lane_pad(bucket_pow2(n + 1, 64))
        out = []
        for a, fill, dt in ((rids, -1, np.int32), (xs, 0, np.int32),
                            (mis, 1, np.int64)):
            b = np.full(P, fill, dt)
            b[:n] = a
            out.append(torch.from_numpy(b).to(self.device))
        return tuple(out)

    def _forward(self, enc, pivots: tuple, C: int) -> tuple:
        """round2_forward over the cards at width C: (n int32[P, C], k,
        s int64[P, C] on the first card, the counts as numpy)."""
        cn, ck, _, cs, ncand = split_lanes(
            self.views, lambda v, e, r, x, m: round2_forward(v, e, r, x, m,
                                                             C),
            pivots, (enc,))
        return cn, ck, cs, ncand.cpu().numpy()

    def _round2(self, enc, rids, xs, mis, opt, per_read,
                tag: str = "") -> None:
        """The SMEMs of the pivots (rids, xs) at min_intv mis: forward
        candidates per pivot, a backward walk per candidate, then the
        emission rule (bwamem2_tpu/ops/backend.py:_round2), appended to
        per_read.  The forward pass keeps ROUND2_MAX_CAND candidates a
        pivot; a pivot with more runs again at width L, which none passes
        (a walk pushes at most one candidate a step, and the last), counted
        as seeding.cand_wide*; its lanes walk from the candidates handed to
        round2_backward's resume entry."""
        NP = len(rids)
        L = enc.shape[1]
        t0 = time.perf_counter()
        piv = self._pivots(rids, xs, mis)
        cn, ck, cs, ncand = self._forward(enc, piv, ROUND2_MAX_CAND)
        ncand = ncand[:NP]
        wide = np.nonzero(ncand > ROUND2_MAX_CAND)[0]
        PROF.count(f"seeding.cand_wide{tag}", len(wide), NP)
        if len(wide):
            piv_w = self._pivots(rids[wide], xs[wide], mis[wide])
            cn_w, ck_w, cs_w, nc_w = self._forward(enc, piv_w, L)
        PROF.add(f"seeding.r2{tag}.fwd", time.perf_counter() - t0)

        # one lane per candidate (pad lanes are dead: the pad pivot's x is
        # 0); every lane walks to its end in one launch
        t0 = time.perf_counter()
        lane_piv, lane_slot = _lanes_of(np.where(ncand > ROUND2_MAX_CAND,
                                                 0, ncand))
        parts = []
        if len(lane_piv):
            M = self._lane_pad(bucket_pow2(len(lane_piv), 64))
            lanes = tuple(_pad_t(torch.from_numpy(a).to(self.device), M,
                                 fill)
                          for a, fill in ((lane_piv, len(piv[0]) - 1),
                                          (lane_slot, 0)))
            walk = split_lanes(
                self.views, lambda v, e, r, x, k, s, m, pi, si:
                round2_backward(v, e, r, x, k, s, pi, si, m),
                lanes, (enc, piv[0], piv[1], ck, cs, piv[2]))
            parts.append((lane_piv, lane_slot,
                          cn.cpu().numpy()[lane_piv, lane_slot], walk))
        if len(wide):
            lp, ls = _lanes_of(nc_w[:len(wide)])
            lp_t = torch.from_numpy(lp.astype(np.int64)).to(self.device)
            ls_t = torch.from_numpy(ls.astype(np.int64)).to(self.device)
            M = self._lane_pad(len(lp))
            # pad lanes: x 0, so they take no step
            col0 = torch.zeros_like(lp_t, dtype=torch.int32)
            lanes = tuple(_pad_t(t, M, fill) for t, fill in (
                (piv_w[0][lp_t], 0), (piv_w[1][lp_t], 0),
                (piv_w[2][lp_t], 1), (col0, 0), (ck_w[lp_t, ls_t], 0),
                (cs_w[lp_t, ls_t], 1)))
            walk = split_lanes(
                self.views, lambda v, e, r, x, m, c, k, s:
                round2_backward.resume(v, e, r, x, m, c, k, s, L), lanes,
                (enc,))
            parts.append((wide[lp].astype(np.int32), ls,
                          cn_w.cpu().numpy()[lp, ls], walk))
        if not parts:
            return
        lane_piv, lane_slot, n_off = (np.concatenate([p[i] for p in parts])
                                      for i in range(3))
        nl = len(lane_piv)
        steps, fk, fs, died = (np.concatenate([
            p[3][i][:len(p[0])].cpu().numpy() for p in parts])
            for i in range(4))
        PROF.add(f"seeding.r2{tag}.bwd", time.perf_counter() - t0)

        # emission: per pivot, candidates in descending slot order; each
        # died lane claims its death column (first claimant wins), and the
        # first surviving lane is the lone survivor emit.  "First in
        # descending slot order" == the largest slot of each group
        steps = steps.astype(np.int64)
        n_abs = xs[lane_piv] + n_off
        m_abs = xs[lane_piv] - steps
        ok_len = (n_abs - m_abs + 1) >= opt.min_seed_len
        grp = lane_piv.astype(np.int64) * (L + 2) \
            + np.where(died, steps + 1, 0)   # survivors share group 0/pivot
        order = np.lexsort((lane_slot, grp))
        g = grp[order]
        last_in_grp = np.ones(nl, bool)
        last_in_grp[:-1] = g[:-1] != g[1:]
        win = np.zeros(nl, bool)
        win[order] = last_in_grp
        for j in np.nonzero(win & ok_len)[0].tolist():
            r = int(rids[lane_piv[j]])
            per_read[r].append((r, int(m_abs[j]), int(n_abs[j]), int(fk[j]),
                                0, int(fs[j])))

    def sa_lookup(self, positions: np.ndarray) -> np.ndarray:
        """Reference coordinates of BWT positions (int64) through sa_resolve
        over the index's cards (bwamem2_tpu/ops/backend.py:sa_lookup); the
        lanes are padded with position 0, a sampled slot."""
        n = len(positions)
        if n == 0:
            return np.zeros(0, np.int64)
        pos = np.zeros(self._lane_pad(n), np.int64)
        pos[:n] = positions
        with PROF("sa_lookup"):
            (out,) = split_lanes(self.views,
                                 lambda v, p: (sa_resolve(v, p),),
                                 (torch.from_numpy(pos).to(self.device),))
            return out[:n].cpu().numpy()

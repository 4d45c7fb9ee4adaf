"""Batch alignment pipeline — mem_process_seqs analog (bwamem.cpp:1338-1390).

Three phases over a chunk of reads:
  1. seeding + SA lookup + chaining + chain filtering   (worker_bwt)
  2. banded-SW extension                                 (worker_aln)
  3. pair-end statistics + pairing/rescue + SAM          (worker_sam)

The seeding and extension kernels are pluggable (host oracle vs device);
the `backend` object provides collect_chunk (seeding + SA coordinates as
flat arrays; None over a sharded index, which seeds through collect_smems
and sa_lookup) and the extension kernels.
"""

from __future__ import annotations

import sys

import numpy as np

from ..index.fmindex import FMIndex
from ..options import (MEM_F_PE, MEM_F_PRIMARY5, MEM_F_SMARTPE, MemOptions)
from ..utils.profiling import PROF
from . import chain as chain_mod
from . import extend as extend_mod
from . import finalize as fin
from .seeding import collect_smems, encode_reads


class Aligner:
    def __init__(self, fm: FMIndex, opt: MemOptions, backend=None,
                 rg_id: str | None = None, verbose: int = 3,
                 native_rt: bool = True):
        self.fm = fm
        self.opt = opt
        self.backend = backend  # None = host oracle path
        self.rg_id = rg_id
        self.verbose = verbose
        # native host runtime (runtime.cpp): chunk-batched dedup/finalize/SAM
        # in C++; False = the pure-Python spec path (the differential oracle)
        self.native_rt = native_rt

    # ---- phase 1: seeds -> chains ----
    def _flat_ext_ok(self, encs, opt) -> bool:
        """True when the all-native extension path applies: device read
        grid present and holding every read, and mem_flt_chained_seeds
        provably a no-op for every read (its engage condition is monotonic
        in read length)."""
        import math
        bsw = getattr(self.backend, "_bsw", None)
        if bsw is None or bsw.encj is None:
            return False
        lmax = max((len(e) for e in encs), default=0)
        if lmax == 0 or lmax > bsw.encj.shape[1]:
            return False
        min_l = (1.1 * opt.min_chain_weight if opt.min_chain_weight
                 else 5.5 * math.log(lmax))
        return min_l > 0.05 * lmax

    def kernel1(self, encs, opt):
        fm = self.fm
        if self.backend is not None:
            # fused single-fetch seeding + SA on the device (ops/seed.py)
            flat = self.backend.collect_chunk(encs, opt)
            if flat is None:
                # the per-stage path (a sharded index, or the legacy
                # round 1): SMEMs, then every read's SA positions resolved
                # in one batch
                smems_per_read = self.backend.collect_smems(encs, opt)
                (allpos, smem_off, smem_m, smem_n, smem_s,
                 occ_off) = chain_mod.sa_positions_batch(opt,
                                                         smems_per_read)
                coords = self.backend.sa_lookup(allpos)
            else:
                (smem_off, smem_m, smem_n, smem_s, occ_off, coords) = flat
            if self.native_rt and self._flat_ext_ok(encs, opt):
                # flat survivor arrays straight into the native extension
                with PROF("chaining"):
                    return ("flat", chain_mod.chain_and_filter_flat(
                        fm, opt, encs, smem_off, smem_m, smem_n, smem_s,
                        occ_off, coords))
            with PROF("chaining"):
                chains_per_read = chain_mod.chain_and_filter_batch_native(
                    fm, opt, encs, smem_off, smem_m, smem_n, smem_s,
                    occ_off, coords)
                for seqid, (enc, chains) in enumerate(
                        zip(encs, chains_per_read)):
                    chain_mod.filter_chained_seeds(fm, opt, len(enc), enc,
                                                   chains)
            return chains_per_read
        smems_per_read = collect_smems(fm, encs, opt)
        chains_per_read = []
        with PROF("chaining"):
            for seqid, (enc, smems) in enumerate(zip(encs, smems_per_read)):
                chains = chain_mod.chain_seeds(fm, opt, seqid, len(enc),
                                               smems, coords=None)
                chains = chain_mod.chain_filter(opt, chains)
                chain_mod.filter_chained_seeds(fm, opt, len(enc), enc, chains)
                chains_per_read.append(chains)
        return chains_per_read

    # ---- phase 2: chains -> alignment regions ----
    def kernel2(self, reads, encs, chains_per_read, opt):
        fm = self.fm
        if isinstance(chains_per_read, tuple) \
                and chains_per_read[0] == "flat":
            # all-native extension: gather/acceptance/purge in C++, device
            # scoring between rounds (hostrt.extension_batch)
            from ..native import hostrt
            bsw = self.backend._bsw

            def score_fn(side, d, w, end_bonus):
                return bsw.run_arrays(d, w, opt, end_bonus)

            with PROF("extension.bsw"):
                fr = hostrt.extension_batch(fm, opt, reads,
                                            chains_per_read[1], score_fn)
            with PROF("dedup_patch"):
                hostrt.dedup_patch_batch(fm, opt, reads, fr)
            return fr
        kw = {}
        if self.backend is not None:
            kw = dict(left_kernel=self.backend.left_bsw_kernel,
                      right_kernel=self.backend.right_bsw_kernel)
            max_len = max((len(e) for e in encs), default=0)
            if max_len <= self.backend.grid_read_cap(len(encs)):
                # every read is on the chunk's read grid: the device
                # kernels gather the pairs' sequences from descriptors, so
                # only a pair beyond LONG_QCAP (none here) is materialized.
                # Otherwise every pair is, and the pairs of the reads off
                # the grid run on the host kernel (DeviceBSW._run)
                from ..ops.bsw import LONG_QCAP
                kw["device_caps"] = (LONG_QCAP, 1 << 62)
        with PROF("extension.bsw"):
            regs_per_read = extend_mod.extend_chains(fm, opt, encs,
                                                     chains_per_read, **kw)
        if self.native_rt:
            # chunk-batched native dedup (rt_dedup_patch_batch); returns the
            # flat SoA container consumed directly by the native finalizers
            from ..native import hostrt
            with PROF("dedup_patch"):
                fr = hostrt.FlatRegs.from_lists(regs_per_read)
                hostrt.dedup_patch_batch(fm, opt, reads, fr)
            return fr
        out = []
        with PROF("dedup_patch"):
            for seqid, (enc, regs) in enumerate(zip(encs, regs_per_read)):
                regs = [r for r in regs if r.qe > r.qb]
                regs = fin.sort_dedup_patch(fm, opt, enc, regs)
                for r in regs:
                    if r.rid >= 0 and fm.bns.anns[r.rid].is_alt:
                        r.is_alt = 1
                out.append(regs)
        return out

    # ---- phase 3: SAM ----
    def kernel3_se(self, reads, encs, regs_per_read, n_processed: int, opt=None):
        fm = self.fm
        opt = opt or self.opt
        for i, (read, enc, regs) in enumerate(zip(reads, encs,
                                                  regs_per_read)):
            regs, n_pri = fin.mark_primary(opt, regs, n_processed + i)
            if opt.flag & MEM_F_PRIMARY5:
                fin.reorder_primary5(opt.T, regs)
            read.sam = fin.reg2sam(fm, opt, read, enc, regs, 0, None,
                                   self.rg_id)

    def process(self, reads, n_processed: int, pes0=None):
        """Align one chunk; fills read.sam for every read."""
        if self.opt.flag & MEM_F_SMARTPE:
            return self._process_smartpe(reads, n_processed, pes0)
        return self._process_one(reads, n_processed, pes0, self.opt)

    @staticmethod
    def classify(reads) -> tuple[list, list]:
        """bseq_classify (bwa.cpp:226-242): split a smart-pairing chunk into
        SE and PE subsets — consecutive reads with equal names pair up."""
        se, pe = [], []
        has_last = True
        for i in range(1, len(reads)):
            if has_last:
                if reads[i].name == reads[i - 1].name:
                    pe.append(reads[i - 1])
                    pe.append(reads[i])
                    has_last = False
                else:
                    se.append(reads[i - 1])
            else:
                has_last = True
        if has_last and reads:
            se.append(reads[-1])
        return se, pe

    def _process_smartpe(self, reads, n_processed: int, pes0=None):
        """-p mixed-stream processing (fastmap.cpp:249-287): the SE subset
        runs without MEM_F_PE at base n_processed, the PE subset with it at
        base n_processed + n_se.  Reads are shared objects, so .sam lands on
        the original chunk without an id remap."""
        se, pe = self.classify(reads)
        if self.verbose >= 3:
            sys.stderr.write(f"[M::process] {len(se)} single-end sequences; "
                             f"{len(pe)} paired-end sequences.....\n")
        if se:
            tmp = self.opt.copy()
            tmp.flag &= ~(MEM_F_PE | MEM_F_SMARTPE)
            self._process_one(se, n_processed, pes0, tmp)
        if pe:
            tmp = self.opt.copy()
            tmp.flag = (tmp.flag | MEM_F_PE) & ~MEM_F_SMARTPE
            self._process_one(pe, n_processed + len(se), pes0, tmp)
        return len(reads)

    def _device_rescue(self) -> bool:
        """Rescue SW runs on the device only when the backend has a rescue
        kernel and this thread's chunk has a read grid attached; otherwise
        the scalar host path rescues inside sam_pe_batch / sam_pe."""
        return (getattr(self.backend, "rescue_batch", None) is not None
                and self.backend.read_grid_width() > 0)

    def _process_one(self, reads, n_processed: int, pes0, opt):
        encs = encode_reads([r.seq for r in reads])
        chains_per_read = self.kernel1(encs, opt)
        regs_per_read = self.kernel2(reads, encs, chains_per_read, opt)
        from ..native import hostrt
        if isinstance(regs_per_read, hostrt.FlatRegs):
            fr = regs_per_read
            if opt.flag & MEM_F_PE:
                with PROF("pestat"):
                    pes6 = (hostrt.pes_to_stats(pes0) if pes0 is not None
                            else hostrt.pestat_batch(self.fm, opt, fr,
                                                     self.verbose))
                keys = res = None
                device = self._device_rescue()
                if device:
                    # chunk-wide device rescue batch (mem_sam_pe_batch pre)
                    with PROF("matesw"):
                        desc, keys = hostrt.rescue_pre_batch(
                            self.fm, opt, reads, fr, pes6,
                            self.backend.read_grid_width())
                        if keys is not None:
                            res = self.backend.rescue_batch(desc)
                            if res is None:
                                keys = None
                with PROF("pairing"):
                    sams, n_host_sw = hostrt.sam_pe_batch(
                        self.fm, opt, reads, fr, pes6, n_processed,
                        self.rg_id, keys=keys, res7=res)
                    for r, s in zip(reads, sams):
                        r.sam = s.decode("ascii")
                if device:
                    # rescue SWs the device batch missed ran on the host
                    PROF.count("overflow.rescue_miss", n_host_sw)
                return len(reads)
            else:
                with PROF("finalize.sam"):
                    sams = hostrt.finalize_se_batch(
                        self.fm, opt, reads, fr, n_processed,
                        self.rg_id)
                    for r, s in zip(reads, sams):
                        r.sam = s.decode("ascii")
                return len(reads)
        if opt.flag & MEM_F_PE:
            from . import pairing
            with PROF("pestat"):
                pes = pes0 if pes0 is not None else pairing.pestat(
                    opt, self.fm.l_pac, regs_per_read,
                    verbose=self.verbose)
            # batch every rescue SW of the chunk on device up front
            # (mem_sam_pe_batch_{pre,post} analog); scalar path otherwise
            rescue = None
            if self._device_rescue():
                with PROF("matesw"):
                    desc, keys = pairing.batch_rescue_pre(
                        self.fm, opt, pes, regs_per_read, encs,
                        self.backend.read_grid_width())
                    rescue = {}       # matesw counts each lookup it misses
                    if keys:
                        out = self.backend.rescue_batch(desc)
                        if out is not None:
                            rescue = {k: out[j]
                                      for j, k in enumerate(keys)}
            with PROF("pairing"):
                for i in range(0, len(reads), 2):
                    pairing.sam_pe(self.fm, opt, pes,
                                   (n_processed >> 1) + (i >> 1),
                                   reads[i:i + 2], encs[i:i + 2],
                                   regs_per_read[i:i + 2], self.rg_id,
                                   rescue=rescue, pair_idx=i >> 1)
        else:
            with PROF("finalize.sam"):
                self.kernel3_se(reads, encs, regs_per_read, n_processed, opt)
        return len(reads)

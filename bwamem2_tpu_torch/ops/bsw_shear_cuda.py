"""The bsw_shear CUDA kernel (csrc/bsw_shear.cu): bind and launch.

Built by ops/cuda_build.py.  `bsw_shear(...)` is the wrapper: for tensors
on the CPU it runs the plain version (ops/bsw.py:bsw_shear_desc_ref); for
CUDA tensors it launches the kernel or raises — it never falls back.
`bsw_shear.launches` counts kernel launches, `bsw_shear.plain_calls` the
CPU calls.

A call's pairs go to at most two launches, one per body: the first
`n16` pairs (which must fit 16 bits, `fits16`: the caller orders them
first) to the 16-bit body, the rest to the int32 body; each launch runs
one warp per pair, its blocks in the order given (the dispatch gives each
part by descending row count).  When both bodies have pairs, the int32
launch goes to a second stream, joined to the caller's by events, so that
the two run at once.  `n16` may be an int32 tensor of one element on the
card (`fits16_t`'s count), which the host never reads: both launches are
then sized for every pair and each kernel reads its range.  A call of
fewer pairs than the card has SMs takes the split-band form instead: one
launch of every pair, K = 2 warps a pair (csrc/shear_group.cuh:
shear_pair_blk).  The frame's slots per lane come from Wh
(csrc/shear_group.cuh:SHEAR_BUCKETS); a band wider than the widest
bucket (Wh > 206) keeps the frame in shared memory instead, in the int32
body.  `bsw_shear.plan` reports a launch's shape; `BswShear.split`
forces K (0: the plan's choice; 1: one warp a pair), for the tests and
the probes that time both forms.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .bsw import bsw_shear_desc_ref
from .cuda_build import CSRC, I32, I64, VP, CudaKernel, check_tensors

__all__ = ["CSRC", "BswShear", "bsw_shear"]


class BswShear(CudaKernel):
    """Wrapper of the bsw_shear kernel (see the module docstring)."""

    NAME = "bsw_shear"
    SOURCES = ("bsw_shear.cu", "shear_group.cuh", "bsw_group.cuh",
               "bsw_common.cuh")
    SIGNATURE = ("bsw_shear_launch",
                 [VP, I64, VP, I64, I32] + [VP] * 9 + [I32] * 15
                 + [VP, VP])
    REG_WH_MAX = 206       # the widest register bucket's band radius

    def __init__(self, split: int = 0):
        super().__init__()
        self.split = split    # 0: the plan picks K; 1, 2: forced
        self._side = {}       # device index -> the int32 body's stream

    def __call__(self, ref, enc, qoff, qdir, qlen, toff, tdir, tlen, h0, w,
                 Wh: int, Tmax: int, mat_a: int, mat_b: int, o_del: int,
                 e_del: int, o_ins: int, e_ins: int, zdrop: int,
                 end_bonus: int, max_sc: int, ref_packed: bool = False,
                 n16=0) -> torch.Tensor:
        args = (ref, enc, qoff, qdir, qlen, toff, tdir, tlen, h0, w, Wh,
                Tmax, mat_a, mat_b, o_del, e_del, o_ins, e_ins, zdrop,
                end_bonus, max_sc, ref_packed)
        if enc.device.type == "cpu":
            self._plain()
            return bsw_shear_desc_ref(*args)
        return self.launch(*args, n16=n16)

    def plan(self, n: int, Wh: int, dev, s16: bool = False) -> tuple:
        """(C int32 slots per lane, R 16-bit registers per lane, blocks,
        threads per block, shared-memory bytes per block, K warps per
        pair) of a launch of n pairs in the 16-bit body (s16) or the int32
        one on CUDA device `dev`, at this wrapper's `split`; R = 0 and
        shared bytes > 0 for the shared-memory frame, K > 1 for the
        split-band form (both kinds of pair in one launch)."""
        plan = (ctypes.c_int * 6)()
        err = self._query(dev, "bsw_shear_plan", [I32, I32, I32, I32, VP],
                          Wh, n, int(bool(s16)), self.split,
                          ctypes.addressof(plan))
        if err:
            raise ValueError(f"bsw_shear: no launch for Wh={Wh}"
                             f"{' in 16 bits' if s16 else ''} at split="
                             f"{self.split} (CUDA error {err})")
        return tuple(plan)

    @classmethod
    def fits16(cls, qlen: np.ndarray, h0: np.ndarray, Wh: int, mat_a: int,
               mat_b: int, o_del: int, e_del: int, o_ins: int, e_ins: int,
               max_sc: int) -> np.ndarray:
        """Per pair: it may run in the 16-bit body (the only test; the
        kernel trusts the caller's n16).  Every H is at most h0 + qlen *
        max_sc and M = H + score one score more, so h0 + (qlen + 1) *
        max_sc <= 32767; the scores are signed bytes (a <= 127, -128 <= -b
        <= 127) and the gap terms small (a row's F may start R * e_ins
        below 0); and the band fits a register bucket (Wh <= 206)."""
        return cls.fits16_t(torch.as_tensor(np.asarray(qlen)),
                            torch.as_tensor(np.asarray(h0)), Wh, mat_a,
                            mat_b, o_del, e_del, o_ins, e_ins,
                            max_sc).numpy()

    @classmethod
    def fits16_t(cls, qlen: torch.Tensor, h0: torch.Tensor, Wh: int,
                 mat_a: int, mat_b: int, o_del: int, e_del: int, o_ins: int,
                 e_ins: int, max_sc: int) -> torch.Tensor:
        """fits16 on tensors, on their device (no copy to the host): a
        bool tensor per pair."""
        ok = (Wh <= cls.REG_WH_MAX and 0 <= mat_a <= 127
              and -127 <= mat_b <= 128 and max_sc >= 0
              and min(o_del, e_del, o_ins, e_ins) >= 0
              and o_del + e_del <= 1024 and o_ins + e_ins <= 1024)
        h0 = h0.to(torch.int64)
        return (h0 >= 0) & (h0 + (qlen.to(torch.int64) + 1) * max_sc
                            <= 32767) & ok

    def launch(self, ref, enc, qoff, qdir, qlen, toff, tdir, tlen, h0, w,
               Wh, Tmax, mat_a, mat_b, o_del, e_del, o_ins, e_ins, zdrop,
               end_bonus, max_sc, ref_packed=False, n16=0) -> torch.Tensor:
        """Launch the CUDA kernels on the current stream (no sync): every
        pair in the split-band form, or pairs [0, n16) in the 16-bit body
        and the rest in the int32 body (on a second stream when both have
        pairs), one launch each where it has pairs.  n16: an int, or an
        int32 tensor of one element on the card."""
        dev = enc.device
        if dev.type != "cuda":
            raise ValueError(f"bsw_shear kernel needs CUDA tensors, got {dev}")
        P = qoff.shape[0]
        want = dict(ref=(ref, torch.uint8, 1), enc=(enc, torch.int8, 2),
                    qoff=(qoff, torch.int32, 1), qdir=(qdir, torch.int32, 1),
                    qlen=(qlen, torch.int32, 1), toff=(toff, torch.int64, 1),
                    tdir=(tdir, torch.int32, 1), tlen=(tlen, torch.int32, 1),
                    h0=(h0, torch.int32, 1), w=(w, torch.int32, 1))
        on_card = isinstance(n16, torch.Tensor)
        if on_card:
            want["n16"] = (n16, torch.int32, 1)
        check_tensors("bsw_shear", dev, **want)
        for name, (t, _, nd) in want.items():
            if nd == 1 and name not in ("ref", "n16") and t.shape[0] != P:
                raise ValueError(f"bsw_shear: {name} has {t.shape[0]} "
                                 f"entries, expected {P}")
        if Wh < 0:
            raise ValueError(f"bsw_shear: band radius Wh={Wh} < 0")
        if on_card and n16.numel() != 1:
            raise ValueError("bsw_shear: n16 must hold one count")
        if not on_card and not 0 <= n16 <= P:
            raise ValueError(f"bsw_shear: n16={n16} outside [0, {P}]")
        shift = max(mat_b, 1)
        if not (0 <= mat_a + shift <= 255 and shift - mat_b <= 255):
            # the per-row score table holds score + max(b, 1) in one byte
            raise ValueError(f"bsw_shear: scores a={mat_a} b={mat_b} do "
                             "not fit the biased byte table")
        out = torch.empty((P, 6), dtype=torch.int32, device=dev)
        if P == 0:
            return out
        args = (enc.data_ptr(), enc.numel(), ref.data_ptr(), ref.numel(),
                int(bool(ref_packed)), qoff.data_ptr(), qdir.data_ptr(),
                qlen.data_ptr(), toff.data_ptr(), tdir.data_ptr(),
                tlen.data_ptr(), h0.data_ptr(), w.data_ptr())
        tail = (Wh, Tmax, mat_a, mat_b, o_del, e_del, o_ins, e_ins, zdrop,
                end_bonus, max_sc, out.data_ptr())
        # raises for a band beyond every bucket, or a forced K without one
        if self.plan(P, Wh, dev)[5] > 1:
            self._launch(dev, *args, None, 0, P, 0, self.split, *tail)
            return out
        if on_card:
            n16p, parts = n16.data_ptr(), ((1, 0, P), (0, 0, P))
        else:
            n16p, parts = None, [x for x in ((1, 0, n16), (0, n16, P))
                                 if x[2] > x[1]]
        side = None
        if len(parts) == 2:
            # the int32 body on its own stream, after what the caller's
            # stream has queued and before anything it queues next
            cur = torch.cuda.current_stream(dev)
            side = self._side.get(dev.index)
            if side is None:
                side = self._side[dev.index] = torch.cuda.Stream(dev)
            side.wait_stream(cur)
        for s16, p0, p1 in parts:
            # raises in 16 bits beyond the register buckets
            self.plan(p1 - p0, Wh, dev, bool(s16))
            with torch.cuda.stream(side if side is not None and not s16
                                   else torch.cuda.current_stream(dev)):
                self._launch(dev, *args, n16p, p0, p1, s16, 1, *tail)
        if side is not None:
            cur.wait_stream(side)
            for t in [out] + [t for t, _, _ in want.values()]:
                t.record_stream(side)
        return out


bsw_shear = BswShear()

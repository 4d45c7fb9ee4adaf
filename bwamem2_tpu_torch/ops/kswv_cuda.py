"""The kswv CUDA kernels (csrc/kswv.cu): bind and launch.

Built by ops/cuda_build.py.  `kswv(...)` is the wrapper of the two-phase
kernel: for tensors on the CPU it runs the plain version
(ops/kswv.py:kswv_two_phase_ref); for CUDA tensors it launches the kernel
or raises — it never falls back.  `kswv.launches` counts kernel launches,
`kswv.plain_calls` the CPU calls.  `kswv_phase(...)` is the wrapper of the
one-phase kernel of the same library (the counterpart of
bwamem2_tpu/ops/kswv.py:kswv_kernel: per problem the caller's target
direction, stop score and live flag), whose plain version is
ops/kswv.py:kswv_phase_ref; it counts its own launches.

The kernel runs one lane group per problem (16 lanes u8, 8 lanes i16) and
keeps the striped H, E and Hmax in registers or shared memory, so a launch
allocates only its output and the int16 row maxima, [P, Tmax rounded up to
8].  `kswv.plan` reports the launch's shape: the register bucket (0 for
shared-memory stripes), groups per block, shared memory per block and S,
the threads a lane.  kswv_phase spreads each lane's segments over S = 2, 4
or 8 threads when the batch's lanes are too few to hide a lane's chain of
segments (the split form, csrc/kswv.cu:kswv_plan); `KswvPhase.split`
forces S (0: the plan's choice), for the tests and the probes that time
both forms.
"""

from __future__ import annotations

import ctypes

import torch

from .cuda_build import I32, I64, VP, CudaKernel, check_tensors
from .kswv import kswv_phase_ref, kswv_two_phase_ref

__all__ = ["Kswv", "KswvPhase", "kswv", "kswv_phase"]


class Kswv(CudaKernel):
    """Wrapper of the kswv kernel: (r0, r1), int32[P, 6] each (see
    kswv_two_phase_ref for the arguments)."""

    NAME = "kswv"
    SOURCES = ("kswv.cu", "kswv_group.cuh", "bsw_common.cuh")
    SIGNATURE = ("kswv_launch",
                 [VP, I64, VP, I64, I32] + [VP] * 6 + [I32] * 12
                 + [VP] * 3)

    def __call__(self, ref, enc, qoff, qdir, qcomp, qlen, toff, tlen,
                 Qmax: int, Tmax: int, minsc: int, mat_a: int, mat_b: int,
                 o_del: int, e_del: int, o_ins: int, e_ins: int,
                 ref_packed: bool = False, u8: bool = True):
        args = (ref, enc, qoff, qdir, qcomp, qlen, toff, tlen, Qmax, Tmax,
                minsc, mat_a, mat_b, o_del, e_del, o_ins, e_ins, ref_packed,
                u8)
        if enc.device.type == "cpu":
            self._plain()
            return kswv_two_phase_ref(*args)
        return self.launch(*args)

    SPLIT = -1       # kswv_plan's split argument: the two-phase kernel's S = 1

    def plan(self, P: int, Qmax: int, u8: bool, dev
             ) -> tuple[int, int, int, int]:
        """(register bucket, 0 for shared-memory stripes; groups per block;
        dynamic shared memory bytes per block; S, threads per lane) of a
        launch on CUDA device `dev`."""
        plan = (ctypes.c_int * 4)()
        err = self._query(dev, "kswv_plan", [I32, I32, I32, I32, VP],
                          int(bool(u8)), Qmax, P, self.SPLIT,
                          ctypes.addressof(plan))
        if err:
            raise ValueError(
                f"{self.NAME}: no launch for Qmax={Qmax} in the "
                f"{'u8' if u8 else 'i16'} class at split={self.SPLIT} "
                f"(CUDA error {err}): one problem's stripes need "
                f"{7 * Qmax} bytes of shared memory, and a split lane 2 to "
                "16 segments a thread")
        return tuple(plan)

    def _check(self, dev, want: dict, Qmax: int, Tmax: int, mat_a: int,
               mat_b: int) -> int:
        """Raise unless the tensors `want` (check_tensors' form; the 1-d
        ones but ref hold one entry per problem) and the shapes and scores
        suit the kernel on `dev`; returns the problem count."""
        if dev.type != "cuda":
            raise ValueError(f"{self.NAME} kernel needs CUDA tensors, got "
                             f"{dev}")
        P = want["qoff"][0].shape[0]
        check_tensors(self.NAME, dev, **want)
        for name, (t, _, nd) in want.items():
            if nd == 1 and name != "ref" and t.shape[0] != P:
                raise ValueError(f"{self.NAME}: {name} has {t.shape[0]} "
                                 f"entries, expected {P}")
        if Qmax <= 0 or Qmax % 16:
            raise ValueError(f"{self.NAME}: Qmax={Qmax} must be a positive "
                             "multiple of 16")
        if Tmax <= 0:
            raise ValueError(f"{self.NAME}: Tmax={Tmax} out of range")
        if not (-128 <= mat_a <= 127 and -127 <= mat_b <= 128):
            # the per-row score table holds the matrix's int8 scores
            raise ValueError(f"{self.NAME}: scores a={mat_a} b={mat_b} are "
                             "not those of an int8 score matrix (options."
                             "fill_scmat)")
        return P

    @staticmethod
    def _descs(ref, enc, qoff, qdir, qcomp, qlen, toff, tlen) -> dict:
        return dict(ref=(ref, torch.uint8, 1), enc=(enc, torch.int8, 2),
                    qoff=(qoff, torch.int32, 1), qdir=(qdir, torch.int32, 1),
                    qcomp=(qcomp, torch.bool, 1),
                    qlen=(qlen, torch.int32, 1), toff=(toff, torch.int64, 1),
                    tlen=(tlen, torch.int32, 1))

    def launch(self, ref, enc, qoff, qdir, qcomp, qlen, toff, tlen, Qmax,
               Tmax, minsc, mat_a, mat_b, o_del, e_del, o_ins, e_ins,
               ref_packed=False, u8=True):
        """Launch the CUDA kernel on the current stream (no sync)."""
        dev = enc.device
        P = self._check(dev, self._descs(ref, enc, qoff, qdir, qcomp, qlen,
                                         toff, tlen), Qmax, Tmax, mat_a,
                        mat_b)
        out = torch.empty((2, P, 6), dtype=torch.int32, device=dev)
        if P == 0:
            return out[0], out[1]
        self.plan(P, Qmax, u8, dev)         # raises on a refused shape
        Tpad = -(-Tmax // 8) * 8
        rowmax = torch.empty((P, Tpad), dtype=torch.int16, device=dev)
        self._launch(
            dev, enc.data_ptr(), enc.numel(), ref.data_ptr(), ref.numel(),
            int(bool(ref_packed)), qoff.data_ptr(), qdir.data_ptr(),
            qcomp.data_ptr(), qlen.data_ptr(), toff.data_ptr(),
            tlen.data_ptr(), P, Qmax, Tmax, Tpad, int(bool(u8)), minsc,
            mat_a, mat_b, o_del, e_del, o_ins, e_ins, rowmax.data_ptr(),
            out.data_ptr())
        return out[0], out[1]


class KswvPhase(Kswv):
    """Wrapper of the one-phase kernel kswv_phase (csrc/kswv.cu, the same
    library as kswv): int32[P, 6] (see kswv_phase_ref for the arguments;
    tdir int32, endsc int32 and do_lane bool per problem)."""

    NAME = "kswv_phase"
    LIBRARY = "kswv"
    SIGNATURE = ("kswv_phase_launch",
                 [VP, I64, VP, I64, I32] + [VP] * 9 + [I32] * 13
                 + [VP] * 3)

    def __init__(self, split: int = 0):
        super().__init__()
        self.split = split    # 0: the plan picks S; 1, 2, 4, 8: forced

    @property
    def SPLIT(self) -> int:
        return self.split

    def __call__(self, ref, enc, qoff, qdir, qcomp, qlen, toff, tdir, tlen,
                 endsc, do_lane, Qmax: int, Tmax: int, minsc: int,
                 mat_a: int, mat_b: int, o_del: int, e_del: int, o_ins: int,
                 e_ins: int, ref_packed: bool = False, u8: bool = True):
        args = (ref, enc, qoff, qdir, qcomp, qlen, toff, tdir, tlen, endsc,
                do_lane, Qmax, Tmax, minsc, mat_a, mat_b, o_del, e_del,
                o_ins, e_ins, ref_packed, u8)
        if enc.device.type == "cpu":
            self._plain()
            return kswv_phase_ref(*args)
        return self.launch(*args)

    def launch(self, ref, enc, qoff, qdir, qcomp, qlen, toff, tdir, tlen,
               endsc, do_lane, Qmax, Tmax, minsc, mat_a, mat_b, o_del,
               e_del, o_ins, e_ins, ref_packed=False, u8=True):
        """Launch the one-phase kernel on the current stream (no sync)."""
        dev = enc.device
        want = self._descs(ref, enc, qoff, qdir, qcomp, qlen, toff, tlen)
        want.update(tdir=(tdir, torch.int32, 1),
                    endsc=(endsc, torch.int32, 1),
                    do_lane=(do_lane, torch.bool, 1))
        P = self._check(dev, want, Qmax, Tmax, mat_a, mat_b)
        out = torch.empty((P, 6), dtype=torch.int32, device=dev)
        if P == 0:
            return out
        self.plan(P, Qmax, u8, dev)         # raises on a refused shape
        Tpad = -(-Tmax // 8) * 8
        rowmax = torch.empty((P, Tpad), dtype=torch.int16, device=dev)
        self._launch(
            dev, enc.data_ptr(), enc.numel(), ref.data_ptr(), ref.numel(),
            int(bool(ref_packed)), qoff.data_ptr(), qdir.data_ptr(),
            qcomp.data_ptr(), qlen.data_ptr(), toff.data_ptr(),
            tdir.data_ptr(), tlen.data_ptr(), endsc.data_ptr(),
            do_lane.data_ptr(), P, Qmax, Tmax, Tpad, int(bool(u8)), minsc,
            mat_a, mat_b, o_del, e_del, o_ins, e_ins, self.split,
            rowmax.data_ptr(), out.data_ptr())
        return out


kswv = Kswv()
kswv_phase = KswvPhase()

"""The bsw_shear CUDA kernel (csrc/bsw_shear.cu): bind and launch.

Built by ops/cuda_build.py.  `bsw_shear(...)` is the wrapper: for tensors
on the CPU it runs the plain version (ops/bsw.py:bsw_shear_desc_ref); for
CUDA tensors it launches the kernel or raises — it never falls back.
`bsw_shear.launches` counts kernel launches, `bsw_shear.plain_calls` the
CPU calls.

The kernel runs one warp per pair with the pair's sheared frame in
registers: 32 lanes x C slots, C the least bucket of SHEAR_BUCKETS whose
frame holds 2*Wh + 3 slots; a band wider than the widest bucket (Wh >
206) keeps the frame in shared memory instead.  `bsw_shear.plan` reports
a launch's shape: slots per lane C, warps per block and shared-memory
bytes per block (0 for a register bucket).
"""

from __future__ import annotations

import ctypes

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
                 [VP, I64, VP, I64, I32] + [VP] * 8 + [I32] * 12
                 + [VP, VP])

    def __call__(self, ref, enc, qoff, qdir, qlen, toff, tdir, tlen, h0, w,
                 Wh: int, Tmax: int, mat_a: int, mat_b: int, o_del: int,
                 e_del: int, o_ins: int, e_ins: int, zdrop: int,
                 end_bonus: int, max_sc: int,
                 ref_packed: bool = False) -> torch.Tensor:
        args = (ref, enc, qoff, qdir, qlen, toff, tdir, tlen, h0, w, Wh,
                Tmax, mat_a, mat_b, o_del, e_del, o_ins, e_ins, zdrop,
                end_bonus, max_sc, ref_packed)
        if enc.device.type == "cpu":
            self._plain()
            return bsw_shear_desc_ref(*args)
        return self.launch(*args)

    def plan(self, P: int, Wh: int, dev) -> tuple[int, int, int]:
        """(slots per lane C, warps per block, shared-memory bytes per
        block) of a launch on CUDA device `dev`."""
        plan = (ctypes.c_int * 3)()
        err = self._query(dev, "bsw_shear_plan", [I32, I32, VP], Wh, P,
                          ctypes.addressof(plan))
        if err:
            raise ValueError(f"bsw_shear: no launch for Wh={Wh} (CUDA "
                             f"error {err})")
        return tuple(plan)

    def launch(self, ref, enc, qoff, qdir, qlen, toff, tdir, tlen, h0, w,
               Wh, Tmax, mat_a, mat_b, o_del, e_del, o_ins, e_ins, zdrop,
               end_bonus, max_sc, ref_packed=False) -> torch.Tensor:
        """Launch the CUDA kernel on the current stream (no sync)."""
        dev = enc.device
        if dev.type != "cuda":
            raise ValueError(f"bsw_shear kernel needs CUDA tensors, got {dev}")
        P = qoff.shape[0]
        want = dict(ref=(ref, torch.uint8, 1), enc=(enc, torch.int8, 2),
                    qoff=(qoff, torch.int32, 1), qdir=(qdir, torch.int32, 1),
                    qlen=(qlen, torch.int32, 1), toff=(toff, torch.int64, 1),
                    tdir=(tdir, torch.int32, 1), tlen=(tlen, torch.int32, 1),
                    h0=(h0, torch.int32, 1), w=(w, torch.int32, 1))
        check_tensors("bsw_shear", dev, **want)
        for name, (t, _, nd) in want.items():
            if nd == 1 and name != "ref" and t.shape[0] != P:
                raise ValueError(f"bsw_shear: {name} has {t.shape[0]} "
                                 f"entries, expected {P}")
        if Wh < 0:
            raise ValueError(f"bsw_shear: band radius Wh={Wh} < 0")
        shift = max(mat_b, 1)
        if not (0 <= mat_a + shift <= 255 and shift - mat_b <= 255):
            # the per-row score table holds score + max(b, 1) in one byte
            raise ValueError(f"bsw_shear: scores a={mat_a} b={mat_b} do "
                             "not fit the biased byte table")
        out = torch.empty((P, 6), dtype=torch.int32, device=dev)
        if P == 0:
            return out
        self.plan(P, Wh, dev)     # raises for a band beyond every bucket
        self._launch(
            dev, enc.data_ptr(), enc.numel(), ref.data_ptr(), ref.numel(),
            int(bool(ref_packed)), qoff.data_ptr(), qdir.data_ptr(),
            qlen.data_ptr(), toff.data_ptr(), tdir.data_ptr(),
            tlen.data_ptr(), h0.data_ptr(), w.data_ptr(), P, Wh, Tmax,
            mat_a, mat_b, o_del, e_del, o_ins, e_ins, zdrop, end_bonus,
            max_sc, out.data_ptr())
        return out


bsw_shear = BswShear()

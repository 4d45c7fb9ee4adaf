"""The bsw_extend CUDA kernel (csrc/bsw_extend.cu): bind and launch.

Built by ops/cuda_build.py.  `bsw_extend(...)` is the wrapper: for tensors
on the CPU it runs the plain version (ops/bsw.py:bsw_desc_ref); for CUDA
tensors it launches the kernel or raises — it never falls back.
`bsw_extend.launches` counts kernel launches, `bsw_extend.plain_calls` the
CPU calls.

The kernel runs one lane group per pair with the pair's DP row in
registers, so a launch allocates only its output.  `bsw_extend.plan`
reports the launch's shape: lanes per pair G, columns per lane C (the
bucket holding the batch's longest query) and groups per block.
"""

from __future__ import annotations

import ctypes

import torch

from .bsw import bsw_desc_ref
from .cuda_build import CSRC, I32, I64, VP, CudaKernel, check_tensors

__all__ = ["CSRC", "BswExtend", "bsw_extend"]


class BswExtend(CudaKernel):
    """Wrapper of the bsw_extend kernel (see the module docstring)."""

    NAME = "bsw_extend"
    SOURCES = ("bsw_extend.cu", "bsw_group.cuh", "bsw_common.cuh")
    SIGNATURE = ("bsw_extend_launch",
                 [VP, I64, VP, I64, I32] + [VP] * 8 + [I32] * 11
                 + [VP, VP])
    QMAX = 383        # the widest bucket: 32 lanes x 12 columns

    def __call__(self, ref, enc, qoff, qdir, qlen, toff, tdir, tlen, h0, w,
                 Qmax: int, Tmax: int, mat_a: int, mat_b: int, o_del: int,
                 e_del: int, o_ins: int, e_ins: int, zdrop: int,
                 end_bonus: int, max_sc: int, ref_packed: bool = False
                 ) -> torch.Tensor:
        args = (ref, enc, qoff, qdir, qlen, toff, tdir, tlen, h0, w, Qmax,
                Tmax, mat_a, mat_b, o_del, e_del, o_ins, e_ins, zdrop,
                end_bonus, max_sc, ref_packed)
        if enc.device.type == "cpu":
            self._plain()
            return bsw_desc_ref(*args)
        return self.launch(*args)

    def plan(self, P: int, Qmax: int, dev) -> tuple[int, int, int]:
        """(lanes per pair G, columns per lane C, groups per block) of a
        launch on CUDA device `dev`."""
        plan = (ctypes.c_int * 3)()
        err = self._query(dev, "bsw_plan", [I32, I32, VP], Qmax, P,
                          ctypes.addressof(plan))
        if err:
            raise ValueError(f"bsw_extend: no launch for Qmax={Qmax} (CUDA "
                             f"error {err})")
        return tuple(plan)

    def launch(self, ref, enc, qoff, qdir, qlen, toff, tdir, tlen, h0, w,
               Qmax, Tmax, mat_a, mat_b, o_del, e_del, o_ins, e_ins, zdrop,
               end_bonus, max_sc, ref_packed=False) -> torch.Tensor:
        """Launch the CUDA kernel on the current stream (no sync)."""
        dev = enc.device
        if dev.type != "cuda":
            raise ValueError(f"bsw_extend kernel needs CUDA tensors, got {dev}")
        P = qoff.shape[0]
        want = dict(ref=(ref, torch.uint8, 1), enc=(enc, torch.int8, 2),
                    qoff=(qoff, torch.int32, 1), qdir=(qdir, torch.int32, 1),
                    qlen=(qlen, torch.int32, 1), toff=(toff, torch.int64, 1),
                    tdir=(tdir, torch.int32, 1), tlen=(tlen, torch.int32, 1),
                    h0=(h0, torch.int32, 1), w=(w, torch.int32, 1))
        check_tensors("bsw_extend", dev, **want)
        for name, (t, _, nd) in want.items():
            if nd == 1 and name != "ref" and t.shape[0] != P:
                raise ValueError(f"bsw_extend: {name} has {t.shape[0]} "
                                 f"entries, expected {P}")
        if not 0 <= Qmax <= self.QMAX:
            raise ValueError(f"bsw_extend: Qmax={Qmax} out of range (the "
                             f"lanes hold queries of up to {self.QMAX})")
        shift = max(mat_b, 1)
        if not (0 <= mat_a + shift <= 255 and shift - mat_b <= 255):
            # the per-row score table holds score + max(b, 1) in one byte
            raise ValueError(f"bsw_extend: scores a={mat_a} b={mat_b} do "
                             "not fit the biased byte table")
        out = torch.empty((P, 6), dtype=torch.int32, device=dev)
        if P == 0:
            return out
        self._launch(
            dev, enc.data_ptr(), enc.numel(), ref.data_ptr(), ref.numel(),
            int(bool(ref_packed)), qoff.data_ptr(), qdir.data_ptr(),
            qlen.data_ptr(), toff.data_ptr(), tdir.data_ptr(),
            tlen.data_ptr(), h0.data_ptr(), w.data_ptr(), P, Qmax,
            mat_a, mat_b, o_del, e_del, o_ins, e_ins, zdrop, end_bonus,
            max_sc, out.data_ptr())
        return out


bsw_extend = BswExtend()

"""The bsw_extend CUDA kernel (csrc/bsw_extend.cu): bind and launch.

Built by ops/cuda_build.py.  `bsw_extend(...)` is the wrapper: for tensors
on the CPU it runs the plain version (ops/bsw.py:bsw_desc_ref); for CUDA
tensors it launches the kernel or raises — it never falls back.
`bsw_extend.launches` counts kernel launches, `bsw_extend.plain_calls` the
CPU calls.
"""

from __future__ import annotations

import torch

from .bsw import bsw_desc_ref
from .cuda_build import CSRC, I32, I64, VP, CudaKernel, check_tensors

__all__ = ["CSRC", "BswExtend", "bsw_extend"]


class BswExtend(CudaKernel):
    """Wrapper of the bsw_extend kernel (see the module docstring)."""

    NAME = "bsw_extend"
    SOURCES = ("bsw_extend.cu", "bsw_extend_dp.cuh")
    SIGNATURE = ("bsw_extend_launch",
                 [VP, I64, VP, I64, I32] + [VP] * 8 + [I32] * 11
                 + [VP, VP, VP])

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
        if not 0 < Qmax < (1 << 15):
            raise ValueError(f"bsw_extend: Qmax={Qmax} out of range")
        out = torch.empty((P, 6), dtype=torch.int32, device=dev)
        if P == 0:
            return out
        scratch = torch.empty((2, Qmax + 1, P), dtype=torch.int32,
                              device=dev)
        self._launch(
            dev, enc.data_ptr(), enc.numel(), ref.data_ptr(), ref.numel(),
            int(bool(ref_packed)), qoff.data_ptr(), qdir.data_ptr(),
            qlen.data_ptr(), toff.data_ptr(), tdir.data_ptr(),
            tlen.data_ptr(), h0.data_ptr(), w.data_ptr(), P, Qmax,
            mat_a, mat_b, o_del, e_del, o_ins, e_ins, zdrop, end_bonus,
            max_sc, scratch.data_ptr(), out.data_ptr())
        return out


bsw_extend = BswExtend()

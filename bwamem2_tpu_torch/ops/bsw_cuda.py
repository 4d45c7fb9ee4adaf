"""The bsw_extend CUDA kernel (csrc/bsw_extend.cu): build, bind, launch.

The source is compiled at first use with nvcc for sm_90a into a shared
library with a plain C interface, loaded with ctypes (no PyTorch headers,
so the build takes seconds).  The library lands in the package's git-ignored
build/ directory under a name keyed by the sources' hash, under a file lock,
via a per-process temp file renamed into place.

`bsw_extend(...)` is the wrapper: for tensors on the CPU it runs the plain
version (ops/bsw.py:bsw_desc_ref); for CUDA tensors it launches the kernel
or raises — it never falls back.  `bsw_extend.launches` counts kernel
launches, `bsw_extend.plain_calls` the CPU calls.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

import torch

from ..native import build_lock
from .bsw import bsw_desc_ref

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "build")
SOURCES = ("bsw_extend.cu", "bsw_extend_dp.cuh")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    for c in (os.environ.get("NVCC"), shutil.which("nvcc"),
              "/usr/local/cuda/bin/nvcc"):
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found (set NVCC or put the CUDA toolkit's "
                       "bin/ on PATH)")


def build_library() -> tuple[str, str]:
    """Compile csrc/bsw_extend.cu unless a library of the same sources is
    built; returns (library path, nvcc/ptxas log of this build or "")."""
    h = hashlib.sha1()
    for name in SOURCES:
        with open(os.path.join(CSRC, name), "rb") as f:
            h.update(f.read())
    lib = os.path.join(BUILD_DIR, f"libbsw_extend_{h.hexdigest()[:12]}.so")
    if os.path.exists(lib):
        return lib, ""
    os.makedirs(BUILD_DIR, exist_ok=True)
    with build_lock(lib):
        if os.path.exists(lib):
            return lib, ""
        tmp = f"{lib[:-3]}.{os.getpid()}.tmp.so"
        try:
            r = subprocess.run(
                [_nvcc(), *NVCC_FLAGS, "-o", tmp,
                 os.path.join(CSRC, "bsw_extend.cu")],
                capture_output=True, text=True)
            if r.returncode:
                raise RuntimeError(f"nvcc failed ({r.returncode}):\n"
                                   f"{r.stdout}{r.stderr}")
            os.replace(tmp, lib)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
    return lib, r.stdout + r.stderr


class BswExtend:
    """Wrapper of the bsw_extend kernel (see the module docstring)."""

    def __init__(self):
        self.launches = 0
        self.plain_calls = 0
        self.build_log = ""
        self._lib = None
        self._lock = threading.Lock()

    def lib(self) -> ctypes.CDLL:
        with self._lock:
            if self._lib is None:
                path, self.build_log = build_library()
                lib = ctypes.CDLL(path)
                vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
                lib.bsw_extend_launch.restype = i32
                lib.bsw_extend_launch.argtypes = (
                    [vp, i64, vp, i64, i32] + [vp] * 8
                    + [i32] * 11 + [vp, vp, vp])
                self._lib = lib
        return self._lib

    def __call__(self, ref, enc, qoff, qdir, qlen, toff, tdir, tlen, h0, w,
                 Qmax: int, Tmax: int, mat_a: int, mat_b: int, o_del: int,
                 e_del: int, o_ins: int, e_ins: int, zdrop: int,
                 end_bonus: int, max_sc: int, ref_packed: bool = False
                 ) -> torch.Tensor:
        args = (ref, enc, qoff, qdir, qlen, toff, tdir, tlen, h0, w, Qmax,
                Tmax, mat_a, mat_b, o_del, e_del, o_ins, e_ins, zdrop,
                end_bonus, max_sc, ref_packed)
        if enc.device.type == "cpu":
            with self._lock:
                self.plain_calls += 1
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
        for name, (t, dt, nd) in want.items():
            if t.device != dev or t.dtype != dt or t.dim() != nd \
                    or not t.is_contiguous():
                raise ValueError(
                    f"bsw_extend: {name} must be a contiguous {nd}-d {dt} "
                    f"tensor on {dev}, got {tuple(t.shape)} {t.dtype} on "
                    f"{t.device}")
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
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = self.lib().bsw_extend_launch(
                enc.data_ptr(), enc.numel(), ref.data_ptr(), ref.numel(),
                int(bool(ref_packed)), qoff.data_ptr(), qdir.data_ptr(),
                qlen.data_ptr(), toff.data_ptr(), tdir.data_ptr(),
                tlen.data_ptr(), h0.data_ptr(), w.data_ptr(), P, Qmax,
                mat_a, mat_b, o_del, e_del, o_ins, e_ins, zdrop, end_bonus,
                max_sc, scratch.data_ptr(), out.data_ptr(), stream)
        if err:
            raise RuntimeError(f"bsw_extend launch failed: CUDA error {err}")
        with self._lock:     # pipeline workers launch from several threads
            self.launches += 1
        return out


bsw_extend = BswExtend()

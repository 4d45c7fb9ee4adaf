"""ctypes bindings of the seeding kernels: csrc/smem_collect.cu and
csrc/sa_resolve.cu (built by ops/cuda_build.py).

Each class is a wrapper: on CPU tensors it runs the plain PyTorch version
it was given (ops/seed.py), on CUDA tensors it launches the kernel or
raises — it never falls back.  `launches` and `plain_calls` count the two.
"""

from __future__ import annotations

import torch

from .cuda_build import I32, I64, VP, CudaKernel, check_tensors


def _fm_args(dfm) -> list:
    """The FmView arguments of a launcher: occp, occ_hi, has_hi, counts
    (host int64[5]), sentinel.  The scalars are read from the device once
    per index and kept on it."""
    host = getattr(dfm, "_host_scalars", None)
    if host is None:
        host = ((I64 * 5)(*dfm.counts.cpu().tolist()), int(dfm.sentinel))
        dfm._host_scalars = host
    return [dfm.occp.data_ptr(), dfm.occ_hi.data_ptr(), int(dfm.has_hi),
            host[0], host[1]]


def _check_index(kernel: str, dfm, dev) -> None:
    check_tensors(kernel, dev, occp=(dfm.occp, torch.int32, 2),
                  occ_hi=(dfm.occ_hi, torch.int32, 1))
    if dfm.occp.shape[1] != 8 or dfm.occp.data_ptr() % 16:
        raise ValueError(f"{kernel}: occp must be 16-byte aligned int32[nb, "
                         f"8], got {tuple(dfm.occp.shape)}")


class SmemCollect(CudaKernel):
    """smem_collect(dfm, enc, lens, min_seed_len, split_len, split_width,
    max_mem_intv, cap) -> (m, n int32[N, cap], k, s int64[N, cap],
    cnt int32[N] (-1: the read outran the cap), nbwd int64[N])."""

    NAME = "smem_collect"
    SOURCES = ("smem_collect.cu", "smem_collect_dp.cuh", "fm_occ.cuh")
    SIGNATURE = ("smem_collect_launch",
                 [VP, VP, I32, VP, I64, VP, VP, I32, I32, I32, I32, I64,
                  I64, I32] + [VP] * 10 + [VP])

    def __init__(self, plain):
        super().__init__()
        self.plain = plain

    def __call__(self, dfm, enc, lens, min_seed_len: int, split_len: int,
                 split_width: int, max_mem_intv: int, cap: int):
        args = (dfm, enc, lens, min_seed_len, split_len, split_width,
                max_mem_intv, cap)
        if enc.device.type == "cpu":
            self._plain()
            return self.plain(*args)
        return self.launch(*args)

    def launch(self, dfm, enc, lens, min_seed_len, split_len, split_width,
               max_mem_intv, cap):
        dev = enc.device
        if dev.type != "cuda":
            raise ValueError(f"smem_collect kernel needs CUDA tensors, got "
                             f"{dev}")
        _check_index("smem_collect", dfm, dev)
        check_tensors("smem_collect", dev, enc=(enc, torch.int8, 2),
                      lens=(lens, torch.int32, 1))
        N, L = enc.shape
        if lens.shape[0] != N or cap < 1:
            raise ValueError(f"smem_collect: lens has {lens.shape[0]} "
                             f"entries for {N} reads, cap={cap}")
        z = lambda *s, dt: torch.zeros(s, dtype=dt, device=dev)  # noqa
        m, n = z(N, cap, dt=torch.int32), z(N, cap, dt=torch.int32)
        k, s = z(N, cap, dt=torch.int64), z(N, cap, dt=torch.int64)
        cnt = torch.empty(N, dtype=torch.int32, device=dev)
        nbwd = torch.empty(N, dtype=torch.int64, device=dev)
        if N == 0:
            return m, n, k, s, cnt, nbwd
        sc_n = torch.empty((2, L + 1, N), dtype=torch.int32, device=dev)
        sc_kls = torch.empty((3, 2, L + 1, N), dtype=torch.int64,
                             device=dev)
        self._launch(
            dev, *_fm_args(dfm), enc.data_ptr(), lens.data_ptr(), N, L,
            int(min_seed_len), int(split_len), int(split_width),
            int(max_mem_intv), int(cap), sc_n.data_ptr(),
            sc_kls[0].data_ptr(), sc_kls[1].data_ptr(), sc_kls[2].data_ptr(),
            m.data_ptr(), n.data_ptr(), k.data_ptr(), s.data_ptr(),
            cnt.data_ptr(), nbwd.data_ptr())
        return m, n, k, s, cnt, nbwd


class SaResolve(CudaKernel):
    """sa_resolve(dfm, pos int64[P]) -> reference coordinates int64[P];
    every pos must be a BWT position of the index (the kernel does not
    check)."""

    NAME = "sa_resolve"
    SOURCES = ("sa_resolve.cu", "fm_occ.cuh")
    SIGNATURE = ("sa_resolve_launch",
                 [VP, VP, I32, VP, I64, VP, VP, VP, I64, VP, VP])

    def __init__(self, plain):
        super().__init__()
        self.plain = plain

    def __call__(self, dfm, pos):
        if pos.device.type == "cpu":
            self._plain()
            return self.plain(dfm, pos)
        return self.launch(dfm, pos)

    def launch(self, dfm, pos):
        dev = pos.device
        if dev.type != "cuda":
            raise ValueError(f"sa_resolve kernel needs CUDA tensors, got "
                             f"{dev}")
        _check_index("sa_resolve", dfm, dev)
        check_tensors("sa_resolve", dev, pos=(pos, torch.int64, 1),
                      sa_ms=(dfm.sa_ms, torch.int8, 1),
                      sa_ls=(dfm.sa_ls, torch.int32, 1))
        P = pos.shape[0]
        out = torch.empty(P, dtype=torch.int64, device=dev)
        if P == 0:
            return out
        self._launch(dev, *_fm_args(dfm), dfm.sa_ms.data_ptr(),
                     dfm.sa_ls.data_ptr(), pos.data_ptr(), P, out.data_ptr())
        return out

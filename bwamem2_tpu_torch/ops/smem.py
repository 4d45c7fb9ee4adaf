"""The round-1 SMEM walk from every (read, end) lane: plain version and the
csrc/round1_walk.cu kernel.

For every end column n of a read, one lane walks the FM index backward
from n until the interval empties (bwamem2_tpu/ops/smem.py:round1_kernel /
_round1_walk at lut_k = 0), yielding the leftmost start b(n) and the
interval (k, s) of [b(n), n]; the round-1 SMEMs are exactly the [b(n), n]
with b(n) < b(n + 1).  `ops/entry.py:seed_extend_step` takes each read's
longest.  The K-mer jump start of the JAX version (index/klut.py) is not
ported, nor its int32 variant: int64 is exact for every genome.

`round1_walk(dfm, enc, lens)` is the wrapper: CPU tensors run the plain
version `round1_walk_ref`, CUDA tensors launch the kernel or raise.
"""

from __future__ import annotations

import torch

from .cuda_build import I32, I64, VP, CudaKernel, check_tensors
from .device_index import DeviceFMIndex, lf_step, take_counts
from .seed_cuda import _check_index, _fm_args


def round1_walk_ref(dfm: DeviceFMIndex, enc: torch.Tensor,
                    lens: torch.Tensor, stats: dict | None = None):
    """Plain version: enc int[N, L] codes (4 = N or padding), lens
    int32[N] -> (b int32[N, L], k int64[N, L], s int64[N, L]).  A lane
    whose code is not a base or that lies past its read gets b = n + 1 and
    the interval of base 0.  Only live lanes are stepped.  If `stats` is a
    dict, the LF steps the walks took (`steps`, the step that empties an
    interval included) and the distinct occ rows they read (`rows`) are
    stored in it: the kernel's work on these inputs."""
    dev = enc.device
    N, L = enc.shape
    enc = enc.long()
    pos = torch.arange(L, device=dev).expand(N, L)
    valid = (enc >= 0) & (enc < 4) & (pos < lens.long()[:, None])
    a0 = torch.where(valid, enc, 0)
    k = take_counts(dfm.counts, a0)
    s = take_counts(dfm.counts, a0, 1) - k
    b = torch.where(valid, pos, pos + 1)
    lane = valid.reshape(-1).nonzero()[:, 0]      # live lanes, flat
    k, s, b = k.reshape(-1), s.reshape(-1), b.reshape(-1)
    flat = enc.reshape(-1)
    steps = 0
    touched = None
    if stats is not None:
        touched = torch.zeros(dfm.occp.shape[0], dtype=torch.bool,
                              device=dev)
    col = lane % L
    while lane.numel():
        col = col - 1
        keep = col >= 0
        lane, col = lane[keep], col[keep]
        c = flat[lane - (lane % L) + col]
        keep = c < 4
        lane, col, c = lane[keep], col[keep], c[keep]
        if not lane.numel():
            break
        kk, ss = k[lane], s[lane]
        k2, s2 = lf_step(dfm, kk, ss, c)
        steps += lane.numel()
        if touched is not None:
            touched[kk >> 6] = True
            touched[(kk + ss) >> 6] = True
        ext = s2 > 0
        lane, col = lane[ext], col[ext]
        k[lane], s[lane], b[lane] = k2[ext], s2[ext], col
    if stats is not None:
        stats["steps"] = steps
        stats["rows"] = int(touched.sum())
    return (b.reshape(N, L).to(torch.int32), k.reshape(N, L),
            s.reshape(N, L))


class Round1Walk(CudaKernel):
    """round1_walk(dfm, enc int8[N, L], lens int32[N]) -> (b int32[N, L],
    k int64[N, L], s int64[N, L]), as round1_walk_ref: one thread per
    (read, end) lane."""

    NAME = "round1_walk"
    SOURCES = ("round1_walk.cu", "fm_occ.cuh")
    SIGNATURE = ("round1_walk_launch",
                 [VP, VP, I32, VP, I64, VP, VP, I32, I32, VP, VP, VP, VP])

    def __call__(self, dfm, enc, lens):
        if enc.device.type == "cpu":
            self._plain()
            return round1_walk_ref(dfm, enc, lens)
        return self.launch(dfm, enc, lens)

    def launch(self, dfm, enc, lens):
        dev = enc.device
        if dev.type != "cuda":
            raise ValueError(f"round1_walk kernel needs CUDA tensors, got "
                             f"{dev}")
        _check_index("round1_walk", dfm, dev)
        check_tensors("round1_walk", dev, enc=(enc, torch.int8, 2),
                      lens=(lens, torch.int32, 1))
        N, L = enc.shape
        if lens.shape[0] != N:
            raise ValueError(f"round1_walk: {lens.shape[0]} lengths for {N} "
                             "reads")
        if N * L >= 1 << 31:
            raise ValueError(f"round1_walk: {N} x {L} lanes, the grid takes "
                             "fewer than 2^31")
        b = torch.empty((N, L), dtype=torch.int32, device=dev)
        k = torch.empty((N, L), dtype=torch.int64, device=dev)
        s = torch.empty((N, L), dtype=torch.int64, device=dev)
        if N * L:
            self._launch(dev, *_fm_args(dfm), enc.data_ptr(),
                         lens.data_ptr(), N, L, b.data_ptr(), k.data_ptr(),
                         s.data_ptr())
        return b, k, s


round1_walk = Round1Walk()

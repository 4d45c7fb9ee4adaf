"""The row_gather CUDA kernel (csrc/row_gather.cu): out[i] = tab[idx[i]].

The port of the TPU kernel tools/gather_scale_probe.py:pallas_gather, the
occ-row fetch of an LF step measured alone.  `row_gather(tab, idx)` is the
wrapper: CPU tensors run the plain version `row_gather_ref` (tab[idx]),
CUDA tensors launch the kernel or raise.  `launches` / `plain_calls`
count the two.  The probe that drives it is
bwamem2_tpu_torch/tools/gather_scale_probe.py.
"""

from __future__ import annotations

import torch

from .cuda_build import I32, I64, VP, CudaKernel, check_tensors


def row_gather_ref(tab: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain version: the rows of int32[nrows, W] `tab` at int32[P] idx."""
    return tab[idx.long()]


class RowGather(CudaKernel):
    """row_gather(tab int32[nrows, W], idx int32[P]) -> int32[P, W]; every
    idx must lie in [0, nrows) (the kernel does not check)."""

    NAME = "row_gather"
    SOURCES = ("row_gather.cu",)
    SIGNATURE = ("row_gather_launch", [VP, VP, I64, I32, VP, VP])

    def __call__(self, tab: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        if tab.device.type == "cpu":
            self._plain()
            return row_gather_ref(tab, idx)
        return self.launch(tab, idx)

    def launch(self, tab: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        dev = tab.device
        if dev.type != "cuda":
            raise ValueError(f"row_gather kernel needs CUDA tensors, got "
                             f"{dev}")
        check_tensors("row_gather", dev, tab=(tab, torch.int32, 2),
                      idx=(idx, torch.int32, 1))
        W = tab.shape[1]
        if W % 4 or tab.data_ptr() % 16:
            raise ValueError(f"row_gather: rows must be whole 16-byte "
                             f"vectors (W % 4 == 0, aligned), got W={W}")
        P = idx.shape[0]
        out = torch.empty((P, W), dtype=torch.int32, device=dev)
        if P == 0:
            return out
        self._launch(dev, tab.data_ptr(), idx.data_ptr(), P, W,
                     out.data_ptr())
        return out


row_gather = RowGather()

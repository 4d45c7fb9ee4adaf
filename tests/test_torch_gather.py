"""Port row gather (ops/row_gather.py) vs what the TPU kernel computes.

tools/gather_scale_probe.py:pallas_gather computes out[i] = tab[idx[i]]
over an int32[nblocks, 16] table (its docstring, :29).  That module runs
its probe when imported, so the test holds the port's plain version
against the same function in numpy, on the probe's table layout (W = 16)
and on the port's own occ rows (W = 8).  The port's probe
(bwamem2_tpu_torch/tools/gather_scale_probe.py) runs its three modes on the
CPU at a small size.  Tolerance 0: integer copies.
"""

import io
import os

import numpy as np
import pytest
import torch

from bwamem2_tpu_torch.index.fmindex import FMIndex
from bwamem2_tpu_torch.ops.device_index import DeviceFMIndex
from bwamem2_tpu_torch.ops.row_gather import row_gather, row_gather_ref
from bwamem2_tpu_torch.tools import gather_scale_probe as probe

from conftest import FIXTURES

torch.set_num_threads(1)


@pytest.mark.parametrize("nblocks,W", [(4096, 16), (37, 16), (1000, 8)],
                         ids=["probe_rows", "small_table", "occ_rows"])
def test_plain_matches_numpy_gather(nblocks, W):
    rng = np.random.default_rng(nblocks)
    tab = rng.integers(-2**31, 2**31, (nblocks, W)).astype(np.int32)
    idx = rng.integers(0, nblocks, 4096).astype(np.int32)
    idx[:3] = [0, nblocks - 1, 0]
    got = row_gather_ref(torch.from_numpy(tab), torch.from_numpy(idx))
    assert got.dtype == torch.int32 and got.shape == (4096, W)
    np.testing.assert_array_equal(got.numpy(), tab[idx])


def test_plain_on_index_occ_rows():
    fm = FMIndex.load(os.path.join(FIXTURES, "ref_small.fa"))
    dfm = DeviceFMIndex.from_host(fm, "cpu")
    blk = np.random.default_rng(2).integers(
        0, dfm.occp.shape[0], 2048).astype(np.int32)
    np.testing.assert_array_equal(
        row_gather(dfm.occp, torch.from_numpy(blk)).numpy(),
        dfm.occp.numpy()[blk])


def test_wrapper_dispatch():
    tab = torch.arange(64, dtype=torch.int32).reshape(8, 8)
    idx = torch.tensor([3, 1], dtype=torch.int32)
    row_gather.reset()
    np.testing.assert_array_equal(row_gather(tab, idx).numpy(),
                                  tab.numpy()[[3, 1]])
    assert (row_gather.plain_calls, row_gather.launches) == (1, 0)
    with pytest.raises(ValueError, match="CUDA"):
        row_gather(tab.to("meta"), idx.to("meta"))
    assert (row_gather.plain_calls, row_gather.launches) == (1, 0)


def test_probe_runs_on_cpu():
    """The probe's three modes at a tiny size on the CPU (plain versions):
    one row per size, and mode (c) went through the wrapper."""
    row_gather.reset()
    out = io.StringIO()
    rows = probe.probe([0.25, 1], device="cpu", reps=1, out=out)
    assert [r["mb"] for r in rows] == [0.25, 1]
    assert all(r[k] > 0 for r in rows
               for k in ("one_shot_s", "chain_s", "kernel_s"))
    assert row_gather.plain_calls == 2 * 2       # warm + 1 rep per size
    assert "kernel=" in out.getvalue()
    tab, idx = probe.make_table(0.25, "cpu")
    assert probe.kernel(tab, idx) == probe.one_shot(tab, idx)

"""Port DeviceFMIndex / take_ref vs the JAX package's, exact.

The same loaded index goes through bwamem2_tpu's DeviceFMIndex.from_host
and the port's; the doubled genome must come out byte-identical, unpacked
and 2-bit packed (forced on the small fixture by lowering REF_PACK_MIN on
both classes), and take_ref must agree on random positions including
out-of-range ones (which both clip).
"""

import os

import numpy as np
import pytest
import torch

from bwamem2_tpu.index.fmindex import FMIndex as JaxFMIndex
from bwamem2_tpu.ops import device_index as jdi
from bwamem2_tpu_torch.index.fmindex import FMIndex
from bwamem2_tpu_torch.ops import device_index as tdi
from bwamem2_tpu_torch.ops import resolve_device

from conftest import FIXTURES

PREFIX = os.path.join(FIXTURES, "ref_small.fa")


@pytest.mark.parametrize("packed", [False, True], ids=["u8", "packed"])
def test_from_host_and_take_ref_match_jax(packed, monkeypatch):
    jfm = JaxFMIndex.load(PREFIX)
    tfm = FMIndex.load(PREFIX)
    np.testing.assert_array_equal(jfm.ref_string, tfm.ref_string)
    if packed:
        # the fixture is far below the 2^31 production threshold; 4 keeps
        # its odd-length tail padding in play
        monkeypatch.setattr(jdi.DeviceFMIndex, "REF_PACK_MIN", 4)
        monkeypatch.setattr(tdi.DeviceFMIndex, "REF_PACK_MIN", 4)
    jd = jdi.DeviceFMIndex.from_host(jfm)
    td = tdi.DeviceFMIndex.from_host(tfm, "cpu")
    assert td.ref_packed == jd.ref_packed == packed
    assert td.ref.dtype == torch.uint8 and td.device.type == "cpu"
    np.testing.assert_array_equal(td.ref.numpy(), np.asarray(jd.ref))

    n = len(tfm.ref_string)
    rng = np.random.default_rng(5)
    pos = np.concatenate([rng.integers(0, n, 2000),
                          [-3, -1, 0, n - 1, n, n + 5]]).astype(np.int64)
    want = np.asarray(jdi.take_ref(jd.ref, pos, packed))
    got = tdi.take_ref(td.ref, torch.from_numpy(pos), packed)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    inside = (pos >= 0) & (pos < n)
    np.testing.assert_array_equal(got.numpy()[inside],
                                  tfm.ref_string[pos[inside]])


def test_cuda_default_raises_without_gpu():
    """The default device is cuda; without a usable card it raises instead
    of falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="--device cpu"):
        resolve_device()
    with pytest.raises(RuntimeError):
        tdi.DeviceFMIndex.from_host(FMIndex.load(PREFIX))
    assert resolve_device("cpu").type == "cpu"

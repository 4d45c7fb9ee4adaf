"""The tiny cell through the real CUDA kernels (card only: skips without
one, deciding inside the test).  On the card:
    pytest -m cuda portbench/tests/test_portbench_cuda.py"""

import time

import pytest

from conftest import TINY_CELL, last_json

from portbench import bench


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [False, True])
def test_tiny_cell_on_the_card(card_root, capsys, trace):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    rc = bench.run(TINY_CELL, 2**31 + 7, 1.0, trace, time.perf_counter(),
                   root=card_root)
    assert rc == 0
    out = last_json(capsys.readouterr().out)
    assert out["correct"] is True, out["check"]
    dev = out["device"]
    assert dev["platform"] == "gpu" and dev["count"] == 1
    assert dev["kind"] == torch.cuda.get_device_name(0)
    if trace:
        assert 0 < dev["busy_s"] <= dev["window_s"]
        assert "device_idle_frac" in out["metrics"]
        assert out["breakdown"]["device_ops"]
    else:
        assert set(out["metrics"]) == {"reads_per_s", "setup_s"}


def test_no_card_no_result(tiny_root, capsys, monkeypatch):
    """Without the cards a cell asks for: exit 3 and no result line."""
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = bench.run(TINY_CELL, 1, 1.0, False, time.perf_counter(),
                   root=tiny_root)
    assert rc == 3 and capsys.readouterr().out == ""

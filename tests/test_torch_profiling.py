"""The port's trace hook (bwamem2_tpu_torch/utils/profiling.py), the
counterpart of the JAX package's BWAMEM2_TPU_TRACE hook
(bwamem2_tpu/utils/profiling.py:start_trace / stop_trace), on the CPU.

* with BWAMEM2_TPU_TRACE=<dir> set, start_trace / stop_trace write a
  Chrome trace under <dir> holding the ops of every thread (the pipeline
  runs its chunks on worker threads), and a second start_trace while one
  runs does nothing;
* with the variable unset, neither call starts a profiler or writes a
  file;
* `mem` (the CLI entry) traces its pipeline when the variable is set, and
  its SAM stays the golden's.
"""

import json
import os
import threading

import torch

from conftest import DATA, FIXTURES
from bwamem2_tpu_torch import cli
from bwamem2_tpu_torch.utils.profiling import PROF

torch.set_num_threads(1)


def _events(path):
    with open(path) as f:
        return json.load(f)["traceEvents"]


def test_trace_written_when_set(monkeypatch, tmp_path):
    monkeypatch.setenv("BWAMEM2_TPU_TRACE", str(tmp_path))
    PROF.start_trace()
    first = PROF._trace
    PROF.start_trace()                   # one trace at a time
    assert PROF._trace is first
    t = threading.Thread(target=lambda: torch.arange(7).cumsum(0))
    t.start()
    t.join()
    torch.ones(3).mul(2)
    path = PROF.stop_trace()
    assert path and os.path.dirname(path) == str(tmp_path)
    assert PROF.trace_path == path
    assert set(PROF.trace_s) == {"start", "traced", "stop"}
    assert min(PROF.trace_s.values()) > 0
    names = {e.get("name") for e in _events(path)}
    assert {"aten::mul", "aten::cumsum"} <= names, sorted(names)[:40]
    assert PROF.stop_trace() is None     # nothing left running


def test_nothing_when_unset(monkeypatch, tmp_path):
    monkeypatch.delenv("BWAMEM2_TPU_TRACE", raising=False)

    def boom(*a, **k):
        raise AssertionError("a profiler was started")

    monkeypatch.setattr(torch.profiler, "profile", boom)
    PROF.start_trace()
    assert PROF._trace is None
    assert PROF.stop_trace() is None
    assert not os.listdir(tmp_path)


def test_mem_traces_its_pipeline(monkeypatch, tmp_path):
    n = 2
    fq = tmp_path / "se2.fq"
    with open(os.path.join(DATA, "reads_se.fq")) as f:
        fq.write_text("".join(f.readline() for _ in range(4 * n)))
    trace_dir = tmp_path / "trace"
    monkeypatch.setenv("BWAMEM2_TPU_TRACE", str(trace_dir))
    sam = tmp_path / "out.sam"
    assert cli.main(["mem", "--device", "cpu", "-v", "1", "-o", str(sam),
                     os.path.join(FIXTURES, "ref_small.fa"), str(fq)]) == 0
    (path,) = trace_dir.iterdir()
    names = {e.get("name") for e in _events(path)}
    assert any(str(nm).startswith("aten::") for nm in names)
    with open(os.path.join(FIXTURES, "golden_se.sam")) as f:
        want = [ln for ln in f if not ln.startswith("@")][:n]
    got = [ln for ln in sam.read_text().splitlines(keepends=True)
           if not ln.startswith("@")]
    assert got == want


def test_cpu_activity_without_a_card(monkeypatch, tmp_path):
    """CPU activity only when no card is in use (CUDA activity is added
    when the process has initialized one)."""
    seen = {}
    real = torch.profiler.profile

    def spy(*a, activities=(), **k):
        seen["acts"] = list(activities)
        return real(*a, activities=activities, **k)

    monkeypatch.setenv("BWAMEM2_TPU_TRACE", str(tmp_path))
    monkeypatch.setattr(torch.profiler, "profile", spy)
    PROF.start_trace()
    PROF.stop_trace()
    assert seen["acts"] == [torch.profiler.ProfilerActivity.CPU]

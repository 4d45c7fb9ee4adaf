"""The port's chunk pipeline (runtime.run_pipeline) when its workers fail.

When every worker raises, nothing takes chunks off the bounded input
queue any more: the reader thread must still end, and close its inputs,
instead of blocking in q_in.put for the life of the process."""

import io
import os
import threading
import time

import pytest

from bwamem2_tpu_torch.io.fastq import FastxReader
from bwamem2_tpu_torch.runtime import run_pipeline

from conftest import DATA


class _Failing:
    """An aligner whose every chunk raises."""

    def process(self, reads, base, pes0=None):
        raise RuntimeError("chunk failed")


@pytest.mark.parametrize("n_workers", [1, 2])
def test_reader_ends_after_every_worker_fails(n_workers):
    before = set(threading.enumerate())
    ks1 = FastxReader(os.path.join(DATA, "reads_se.fq"))
    # 300 reads in chunks of ~5: far more chunks than the queue holds
    with pytest.raises(RuntimeError, match="chunk failed"):
        run_pipeline(_Failing(), ks1, None, 500, io.StringIO(), verbose=0,
                     n_workers=n_workers, pipeline_depth=2)
    deadline = time.time() + 5
    left = [t for t in threading.enumerate() if t not in before]
    while left and time.time() < deadline:
        time.sleep(0.02)
        left = [t for t in left if t.is_alive()]
    assert not left, f"threads still running: {left}"
    assert ks1.f.closed

"""The port end to end on the CPU: golden SAM byte for byte.

TorchBackend(device="cpu") seeds through the fused collect_chunk route
(smem_collect_ref and sa_resolve_ref, the seeding kernels' plain versions)
and scores every extension rung group with bsw_desc_ref (the extension
kernel's plain version) through the flat all-native extension path; mate
rescue runs on the host scalar path.  Outputs must equal the committed
goldens.
"""

import os

import pytest
import torch

from bwamem2_tpu_torch import cli
from bwamem2_tpu_torch.align.pipeline import Aligner
from bwamem2_tpu_torch.index.fmindex import FMIndex
from bwamem2_tpu_torch.io.fastq import FastxReader, read_chunk
from bwamem2_tpu_torch.ops.backend import TorchBackend
from bwamem2_tpu_torch.ops.bsw_cuda import bsw_extend
from bwamem2_tpu_torch.ops.seed import sa_resolve, smem_collect
from bwamem2_tpu_torch.options import MEM_F_PE, MemOptions

from conftest import DATA, FIXTURES

# one intra-op thread: the suite runs several xdist workers side by side,
# each with XLA's thread pools, and torch's OpenMP regions oversubscribed
# that way run 100x slower than on one thread
torch.set_num_threads(1)

PREFIX = os.path.join(FIXTURES, "ref_small.fa")


def golden_lines(name):
    with open(os.path.join(FIXTURES, name)) as f:
        return [ln for ln in f if not ln.startswith("@")]


@pytest.fixture(scope="module")
def fm():
    return FMIndex.load(PREFIX)


@pytest.mark.parametrize("pe", [False, True], ids=["se", "pe"])
def test_golden_on_cpu_through_plain_kernel(fm, pe):
    opt = MemOptions().finalize()
    if pe:
        opt.flag |= MEM_F_PE
        reads = read_chunk(FastxReader(os.path.join(DATA, "reads_r1.fq")),
                           FastxReader(os.path.join(DATA, "reads_r2.fq")),
                           10**9)
    else:
        reads = read_chunk(FastxReader(os.path.join(DATA, "reads_se.fq")),
                           None, 10**9)
    backend = TorchBackend(fm, opt, device="cpu")
    n_plain, n_launch = bsw_extend.plain_calls, bsw_extend.launches
    seeding = (smem_collect, sa_resolve)
    n_seed = [(k.plain_calls, k.launches) for k in seeding]
    al = Aligner(fm, opt, backend=backend, verbose=0)
    al.process(reads, 0)
    # seeding took the fused collect_chunk route, on the plain versions
    for k, (p0, l0) in zip(seeding, n_seed):
        assert (k.plain_calls, k.launches) == (p0 + 1, l0)
    # the flat all-native extension path ran (DeviceBSW.run_arrays is its
    # only caller of the wrapper), scoring on the plain kernel
    assert al._flat_ext_ok([r.seq for r in reads], opt)
    assert backend.read_grid_width() > 0
    assert bsw_extend.plain_calls > n_plain
    assert bsw_extend.launches == n_launch
    ours = "".join(r.sam for r in reads).splitlines(keepends=True)
    golden = golden_lines("golden_pe.sam" if pe else "golden_se.sam")
    assert len(ours) == len(golden)
    assert ours == golden


def test_cli_mem_device_cpu_pe_golden(tmp_path):
    out = tmp_path / "pe.sam"
    rc = cli.main(["mem", "--device", "cpu", "-v", "0", "-o", str(out),
                   PREFIX, os.path.join(DATA, "reads_r1.fq"),
                   os.path.join(DATA, "reads_r2.fq")])
    assert rc == 0
    with open(out) as f:
        ours = [ln for ln in f if not ln.startswith("@PG")]
    with open(os.path.join(FIXTURES, "golden_pe.sam")) as f:
        golden = [ln for ln in f if not ln.startswith("@PG")]
    assert ours == golden


def test_cli_mem_default_device_needs_cuda(tmp_path):
    """Without a GPU the default --device cuda is an error, not a silent
    host run: nothing is written."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = tmp_path / "pe.sam"
    with pytest.raises(RuntimeError, match="--device cpu"):
        cli.main(["mem", "-o", str(out), PREFIX,
                  os.path.join(DATA, "reads_r1.fq")])
    assert not out.exists()

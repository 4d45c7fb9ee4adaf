"""The flag-matrix and misc goldens through the port on the CPU.

Each case aligns its fixture reads through TorchBackend(device="cpu"),
whose seeding and SA resolution run the fused path's plain versions
(smem_collect_ref, sa_resolve_ref), and holds the SAM against the
committed golden byte for byte, as the JAX package's tests do on the
host path:
* the 15 SE flag sets of tests/test_golden_flags.py:SE_CASES (-A2 a
  strict xfail for the reason given there);
* the six cases of tests/test_golden_misc.py: ALT contigs, ALT ignored
  (-j), comments (-C), XR (-V), read group (-R), -M;
* golden_se_hard.sam (indel-heavy and repeat reads at default flags).
golden_ont2d.sam runs on the card only (chip_smoke.py phase 7): its long
reads take minutes through the plain versions.
"""

import os

import pytest
import torch

from bwamem2_tpu_torch.align.pipeline import Aligner
from bwamem2_tpu_torch.cli import parse_mem_args
from bwamem2_tpu_torch.index.fmindex import FMIndex
from bwamem2_tpu_torch.io.fastq import FastxReader, read_chunk
from bwamem2_tpu_torch.ops.backend import TorchBackend
from bwamem2_tpu_torch.ops.seed import sa_resolve, smem_collect
from bwamem2_tpu_torch.options import (MEM_F_NO_MULTI, MEM_F_REF_HDR,
                                       MemOptions)

from conftest import DATA, FIXTURES
from test_golden_flags import SE_CASES

torch.set_num_threads(1)

PREFIX = os.path.join(FIXTURES, "ref_small.fa")
ALT = os.path.join(FIXTURES, "alt", "ref_small.fa")
SE = os.path.join(DATA, "reads_se.fq")


def golden(name):
    """The golden's records (golden_se_hard.sam alone has header lines)."""
    with open(os.path.join(FIXTURES, name)) as f:
        return [ln for ln in f if not ln.startswith("@")]


def run(prefix, fq, opt, rg_id=None, ignore_alt=False, copy_comment=False,
        pes0=None):
    """The fixture's SAM records through a CPU TorchBackend; asserts that
    the seeding ran its plain versions (and launched nothing)."""
    fm = FMIndex.load(prefix)
    if ignore_alt:
        for a in fm.bns.anns:
            a.is_alt = False
    reads = read_chunk(FastxReader(fq), None, 10**9)
    if not copy_comment:
        for r in reads:
            r.comment = None
    n0 = [(k.plain_calls, k.launches) for k in (smem_collect, sa_resolve)]
    Aligner(fm, opt, backend=TorchBackend(fm, opt, device="cpu"),
            rg_id=rg_id, verbose=0).process(reads, 0, pes0=pes0)
    for k, (p0, l0) in zip((smem_collect, sa_resolve), n0):
        assert k.plain_calls > p0 and k.launches == l0, k.NAME
    return "".join(r.sam for r in reads).splitlines(keepends=True)


@pytest.mark.parametrize("flags,name", SE_CASES)
def test_se_flag_golden_through_port(flags, name):
    parsed = parse_mem_args(flags.split() + [PREFIX, "x"])
    opt, pes0 = parsed[0], parsed[9]
    opt.finalize(parsed[1])
    assert run(PREFIX, SE, opt, pes0=pes0) == golden(name)


def _opt(flag=0):
    opt = MemOptions().finalize()
    opt.flag |= flag
    return opt


@pytest.mark.parametrize("prefix,fq,flag,kw,name", [
    (ALT, SE, 0, {}, "golden_se_alt.sam"),
    (ALT, SE, 0, dict(ignore_alt=True), "golden_se_alt_j.sam"),
    (PREFIX, os.path.join(DATA, "reads_se_comment.fq"), 0,
     dict(copy_comment=True), "golden_se_C.sam"),
    (PREFIX, SE, MEM_F_REF_HDR, {}, "golden_se_V.sam"),
    (PREFIX, SE, 0, dict(rg_id="rg1"), "golden_se_R.sam"),
    (PREFIX, SE, MEM_F_NO_MULTI, {}, "golden_se_M.sam"),
    (PREFIX, os.path.join(DATA, "reads_hard.fq"), 0, {},
     "golden_se_hard.sam"),
], ids=["alt", "alt-j", "C", "V", "R", "M", "hard"])
def test_misc_golden_through_port(prefix, fq, flag, kw, name):
    assert run(prefix, fq, _opt(flag), **kw) == golden(name)

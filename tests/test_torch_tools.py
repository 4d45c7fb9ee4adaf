"""The port's measurement tools (bwamem2_tpu_torch/tools/) on the CPU,
against the goldens the JAX package's own tests hold its pipeline to
(tolerance 0: SAM byte for byte, @PG aside).

* host_ceiling's DeviceTap (the port of tools/host_ceiling.py) records a
  PE and an SE run through a CPU TorchBackend (and an SE run of the legacy
  round 1, whose seeding crosses collect_smems and sa_lookup) and replays
  it: the replay's SAM equals the record pass's and the golden, no plain
  version runs, and it still does so with every real boundary patched to
  raise (no fall-through to the device); a read changed after the record
  pass makes the replay raise ReplayMiss; host_ceiling.measure's five
  passes give the JAX tool's keys on the SE fixture;
* prof_bench prints the PROF phase table on the fixture;
* scaling_bench --mode roundrobin gives identical SAM over one and two CPU
  "devices" (ops.resolve_devices replaced, as the parallel tests do);
* shard_overhead's pipeline section gives identical SAM over 3 CPU
  shards and over the per-stage path on one shard.
"""

import io
import json
import os

import pytest
import torch

from conftest import DATA, FIXTURES
from bwamem2_tpu_torch import ops
from bwamem2_tpu_torch.align.pipeline import Aligner
from bwamem2_tpu_torch.index.fmindex import FMIndex
from bwamem2_tpu_torch.io.fastq import FastxReader
from bwamem2_tpu_torch.ops.backend import TorchBackend
from bwamem2_tpu_torch.ops.bsw import DeviceBSW
from bwamem2_tpu_torch.ops.bsw_cuda import BswExtend
from bwamem2_tpu_torch.ops.bsw_shear_cuda import BswShear
from bwamem2_tpu_torch.ops.cuda_build import launch_counts
from bwamem2_tpu_torch.ops.kswv import DeviceKswv
from bwamem2_tpu_torch.ops.kswv_cuda import Kswv
from bwamem2_tpu_torch.ops.seed import FusedSeeder
from bwamem2_tpu_torch.ops.seed_cuda import SaResolve, SmemCollect
from bwamem2_tpu_torch.options import MEM_F_PE, MemOptions
from bwamem2_tpu_torch.runtime import run_pipeline
from bwamem2_tpu_torch.tools import (host_ceiling, prof_bench,
                                     scaling_bench, shard_overhead)

torch.set_num_threads(1)

PREFIX = os.path.join(FIXTURES, "ref_small.fa")
R1, R2 = (os.path.join(DATA, f"reads_r{i}.fq") for i in (1, 2))
SE = os.path.join(DATA, "reads_se.fq")


def golden(name):
    with open(os.path.join(FIXTURES, name)) as f:
        return [ln for ln in f if not ln.startswith("@")]


def head(src, n, dst):
    """The first n records of a FASTQ file, written to dst."""
    with open(src) as f:
        dst.write_text("".join(f.readline() for _ in range(4 * n)))
    return str(dst)


def one_pass(be, fq1, fq2):
    """One pass of the pipeline over `be` (one worker, one chunk): its SAM
    records."""
    out = io.StringIO()
    run_pipeline(Aligner(be.fm, be.opt, backend=be, verbose=0),
                 FastxReader(fq1), FastxReader(fq2) if fq2 else None,
                 10**9, out, verbose=0, n_workers=1)
    return out.getvalue().splitlines(keepends=True)


@pytest.mark.parametrize("fq1,fq2,kw,name", [
    (R1, R2, {}, "golden_pe.sam"),
    (SE, None, {}, "golden_se.sam"),
    (SE, None, dict(pivot_seeding=False), "golden_se.sam"),
], ids=["pe", "se", "se-legacy"])
def test_device_tap_replays_without_the_device(monkeypatch, tmp_path, fq1,
                                               fq2, kw, name):
    opt = MemOptions().finalize(None)
    if fq2:
        opt.flag |= MEM_F_PE
    be = TorchBackend(FMIndex.load(PREFIX), opt, device="cpu", **kw)
    tap = host_ceiling.DeviceTap(be)
    want = golden(name)
    assert one_pass(be, fq1, fq2) == want           # the record pass
    seeding = ("seed",) if not kw else ("collect_smems", "sa_lookup")
    for b in seeding + ("run_arrays", "align_batch")[:2 if fq2 else 1]:
        assert tap.recorded.get(b), (b, tap.recorded)
    tap.mode = "replay"

    # every real boundary, and each kernel wrapper, raises from now on
    def boom(*a, **k):
        raise AssertionError("replay reached a device boundary")

    for k in tap.orig:
        tap.orig[k] = boom
    for cls, m in ((TorchBackend, "_attach_grid"),
                   (TorchBackend, "collect_smems"),
                   (TorchBackend, "sa_lookup"), (FusedSeeder, "run"),
                   (DeviceKswv, "align_batch"), (DeviceBSW, "run_arrays"),
                   (DeviceBSW, "_run"), (SmemCollect, "__call__"),
                   (SaResolve, "__call__"), (BswExtend, "__call__"),
                   (BswShear, "__call__"), (Kswv, "__call__")):
        monkeypatch.setattr(cls, m, boom)
    plain = launch_counts(plain=True)
    assert one_pass(be, fq1, fq2) == want
    assert launch_counts(plain=True) == plain
    assert tap.misses == 0

    # a read changed since the record pass: the replay raises
    with open(fq1) as f:
        lines = f.readlines()
    seq = lines[1]
    lines[1] = ("C" if seq[0] != "C" else "A") + seq[1:]
    drifted = tmp_path / "drifted.fq"
    drifted.write_text("".join(lines))
    with pytest.raises(host_ceiling.ReplayMiss):
        one_pass(be, str(drifted), fq2)
    assert tap.misses == 1


def test_host_ceiling_report():
    """measure's five passes on the SE fixture: the JAX tool's keys, a
    replay that ran nothing on the device, the golden SAM."""
    rep = host_ceiling.measure(PREFIX, SE, None, 10**9, "cpu",
                               log=lambda m: None)
    assert rep["sam"].splitlines(keepends=True) == golden("golden_se.sam")
    assert rep["reads"] == 300 and rep["misses"] == 0
    assert rep["replay_launches"] == 0 and rep["replay_plain_calls"] == 0
    for k in ("wall_e2e_1worker_s", "wall_host_s", "host_frac_of_e2e",
              "host_ceiling_rps", "wall_at_10x_device_s",
              "implied_rps_at_10x_device"):
        assert rep[k] > 0, k


def test_prof_bench_prints_the_phase_table(tmp_path, capsys):
    fq = head(SE, 60, tmp_path / "se60.fq")
    assert prof_bench.main(["--device", "cpu", "--index", PREFIX, "--fq1",
                            fq, "--workers", "1", "--task-bases",
                            "4000"]) == 0
    err = capsys.readouterr().err
    assert "[timed] 60 reads" in err
    assert "[prof] phase timing summary" in err
    for phase in ("seeding.device", "extension.bsw", "finalize.sam",
                  "overflow.fused_read"):
        assert f"[prof]   {phase}" in err, err


def test_scaling_bench_roundrobin_identical(monkeypatch, tmp_path, capsys):
    monkeypatch.setattr(ops, "resolve_devices",
                        lambda dev=None: [torch.device("cpu")] * 2)
    fq = head(SE, 60, tmp_path / "se60.fq")
    assert scaling_bench.main(["--mode", "roundrobin", "--ns", "1,2",
                               "--device", "cpu", "--chunk", "3000",
                               "--index", PREFIX, "--fq1", fq]) == 0
    rep = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rep["mode"] == "roundrobin"
    for n in ("1", "2"):
        assert rep[n]["output_identical"]
        assert len(rep[n]["devices"]) == int(n)


def test_shard_overhead_pipeline_over_three_shards(tmp_path, capsys):
    fq = head(SE, 30, tmp_path / "se30.fq")
    assert shard_overhead.main(["--device", "cpu", "--shards", "3",
                                "--sections", "pipeline", "--index", PREFIX,
                                "--fq1", fq]) == 0
    rep = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rep["identical"]
    assert set(rep["mem_s"]) == {"replicated", "per-stage, 1 shard",
                                 "3 shards on cpu"}

#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (bwamem2_tpu_torch).

Run from the root of a checkout on a machine with an NVIDIA GPU (written
for the H100, sm_90a):

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no result line):
  1. the card's name and power limit (nvidia-smi);
  2. build: the CUDA kernel (nvcc, csrc/bsw_extend.cu) and the native host
     runtime (g++) from the checkout's sources, in parallel;
  3. data: a synthetic 11.7 Mbp genome (scale 0.25 of the chr21 class, the
     size of a yeast genome) with repeat families and N runs, its index and
     10,000 2x150 bp pairs, made once from fixed seeds under .tmp/;
  4. main path: `mem` PE through the port's CLI entry on cuda (default
     options, 2.25 Mbp task size), with every launch counter set to 0 just
     before and read just after;
  5. kernel vs plain: bsw_extend against bsw_desc_ref on the card at every
     production rung (Q in 127/255/383 x T in 96..608) with P = 4096
     real-length descriptors, exact equality, with times and the bound;
  6. goldens: tests/fixtures/golden_se.sam and golden_pe.sam reproduced on
     cuda;
  7. the main path's SAM equals the port's host-native run
     (Aligner(backend=None), one process per chunk, started after phase 4
     and run during phases 5-6) byte for byte except @PG.
The last two stdout lines are the card line and
{"ok": true, "device": {...}}; the line before them is the per-kernel JSON.
The run's numbers are also written to .tmp/chip_smoke/chip_smoke.json.

Exits non-zero without a result when torch.cuda.is_available() is false or
when bwamem2_tpu_torch/ is not beside this script.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import threading
import time

REPO = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(REPO, ".tmp", "chip_smoke")
DATA_SCALE, N_PAIRS = 0.25, 10_000
TASK_BASES = 2_250_000
P_KERNEL = 4096
Q_RUNGS = (127, 255, 383)
T_RUNGS = (96, 160, 224, 320, 448, 608)
# bound model (csrc/bsw_extend.cu header): int32 ops per band cell, the
# card's INT32 issue rate and memory rate (H100 SXM data sheet, 700 W)
OPS_PER_CELL = 24
INT32_OPS_PER_S = 132 * 64 * 1.98e9
HBM_BYTES_PER_S = 3.35e12
DESC_BYTES, OUT_BYTES = 36, 24


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    print(f"[chip_smoke] FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    if r.returncode:
        fail(f"nvidia-smi failed: {r.stderr.strip()}")
    return r.stdout.strip().splitlines()[0]


# ----------------------------------------------------------------- builds
def build_all() -> dict:
    """nvcc and g++ started together; returns seconds per build."""
    from bwamem2_tpu_torch.native import get_lib
    from bwamem2_tpu_torch.ops.bsw_cuda import bsw_extend
    secs, errs = {}, []

    def timed(name, fn):
        t0 = time.perf_counter()
        try:
            fn()
        except Exception as e:  # reported below; the run fails
            errs.append(f"{name}: {e}")
        secs[name] = time.perf_counter() - t0

    ts = [threading.Thread(target=timed, args=("nvcc bsw_extend.cu",
                                               bsw_extend.lib)),
          threading.Thread(target=timed, args=("g++ native runtime",
                                               get_lib))]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    if errs:
        fail("build failed:\n" + "\n".join(errs))
    for ln in bsw_extend.build_log.splitlines():
        if "registers" in ln or "spill" in ln or "error" in ln.lower():
            log(f"  ptxas: {ln.strip()}")
    return secs


# ------------------------------------------------------ kernel vs plain
def rung_inputs(torch, ref_np, Q: int, T: int, P: int, seed: int):
    """P real-length extension descriptors at rung (Q, T): qlen in
    (prevQ, Q], tlen in (prevT, T]; queries are 2%-mutated genome slices in
    an int8[P, 384] read grid, half extended right (+1/+1) and half left
    (-1/-1) against their source, 1 in 8 against an unrelated target, 1
    in 8 shifted by a 2-base offset; h0 in [19, 100), w = 100."""
    import numpy as np
    rng = np.random.default_rng(seed)
    qlo = {127: 0, 255: 127, 383: 255}[Q]
    tlo = {96: 0, 160: 96, 224: 160, 320: 224, 448: 320, 608: 448}[T]
    L = 384
    n = ref_np.shape[0]
    qlen = rng.integers(qlo + 1, Q + 1, P).astype(np.int32)
    tlen = rng.integers(tlo + 1, T + 1, P).astype(np.int32)
    s = rng.integers(2000, n - 2000, P).astype(np.int64)
    enc = ref_np[s[:, None] + np.arange(L)[None, :]].astype(np.int8)
    mut = rng.random((P, L)) < 0.02
    enc[mut] = rng.integers(0, 4, int(mut.sum()))
    left = (np.arange(P) % 2) == 1
    shift = np.where(rng.random(P) < 0.125, 2, 0)
    toff = np.where(left, s + qlen - 1 + shift, s + shift)
    unrelated = rng.random(P) < 0.125
    toff[unrelated] = rng.integers(2000, n - 2000, int(unrelated.sum()))
    qoff = np.arange(P, dtype=np.int64) * L + np.where(left, qlen - 1, 0)
    d = np.where(left, -1, 1).astype(np.int32)
    h0 = rng.integers(19, 100, P).astype(np.int32)
    w = np.full(P, 100, np.int32)
    cu = lambda a: torch.from_numpy(np.ascontiguousarray(a)).cuda()
    return (cu(enc), cu(qoff.astype(np.int32)), cu(d), cu(qlen),
            cu(toff.astype(np.int64)), cu(d), cu(tlen), cu(h0), cu(w))


def kernel_vs_plain(torch, fm, opt) -> dict:
    from bwamem2_tpu_torch.ops.bsw import bsw_desc_ref
    from bwamem2_tpu_torch.ops.bsw_cuda import bsw_extend
    from bwamem2_tpu_torch.ops.device_index import DeviceFMIndex
    dfm = DeviceFMIndex.from_host(fm, "cuda")
    sc = (opt.a, opt.b, opt.o_del, opt.e_del, opt.o_ins, opt.e_ins,
          opt.zdrop, opt.pen_clip5, max(opt.a, 1))
    tot = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, ops_ms=0.0, mem_ms=0.0,
               cells=0, err=0, mismatches=0)
    log(f"  {'Q':>4} {'T':>4} {'cells':>11} {'kernel_ms':>10} "
        f"{'plain_ms':>10} {'bound_ms':>9} {'bound_by':>10} mismatch")
    ev = lambda: torch.cuda.Event(enable_timing=True)
    for Q in Q_RUNGS:
        for T in T_RUNGS:
            x = rung_inputs(torch, fm.ref_string, Q, T, P_KERNEL,
                            seed=Q * 1000 + T)
            enc, qoff, qdir, qlen, toff, tdir, tlen, h0, w = x
            args = (dfm.ref, enc, qoff, qdir, qlen, toff, tdir, tlen, h0,
                    w, Q, T) + sc + (dfm.ref_packed,)
            cells: list = []
            want = bsw_desc_ref(*args[:-1], ref_packed=dfm.ref_packed,
                                cells=cells)
            got = bsw_extend.launch(*args)
            torch.cuda.synchronize()
            bad = int((got != want).any(1).sum())
            err = int((got - want).abs().max()) if got.numel() else 0
            # kernel time: CUDA events over 10 launches after warm-up
            for _ in range(2):
                bsw_extend.launch(*args)
            e0, e1 = ev(), ev()
            e0.record()
            for _ in range(10):
                bsw_extend.launch(*args)
            e1.record()
            torch.cuda.synchronize()
            k_ms = e0.elapsed_time(e1) / 10
            e0, e1 = ev(), ev()
            e0.record()
            bsw_desc_ref(*args[:-1], ref_packed=dfm.ref_packed)
            e1.record()
            torch.cuda.synchronize()
            p_ms = e0.elapsed_time(e1)
            nbytes = (P_KERNEL * (DESC_BYTES + OUT_BYTES)
                      + int(qlen.sum()) + int(tlen.sum()))
            ops_ms = cells[0] * OPS_PER_CELL / INT32_OPS_PER_S * 1e3
            mem_ms = nbytes / HBM_BYTES_PER_S * 1e3
            b_ms = max(ops_ms, mem_ms)
            by = "operations" if ops_ms >= mem_ms else "bytes"
            log(f"  {Q:>4} {T:>4} {cells[0]:>11} {k_ms:>10.4f} "
                f"{p_ms:>10.3f} {b_ms:>9.5f} {by:>10} {bad}")
            tot["ms"] += k_ms
            tot["plain_ms"] += p_ms
            tot["bound_ms"] += b_ms
            tot["ops_ms"] += ops_ms
            tot["mem_ms"] += mem_ms
            tot["cells"] += cells[0]
            tot["err"] = max(tot["err"], err)
            tot["mismatches"] += bad
    if tot["mismatches"]:
        fail(f"bsw_extend disagrees with bsw_desc_ref on "
             f"{tot['mismatches']} pairs (max abs err {tot['err']})")
    return tot


# ------------------------------------------------------------ main path
def read_sam_body(path: str) -> list[str]:
    with open(path) as f:
        return [ln for ln in f if not ln.startswith("@PG")]


def oracle_chunk(prefix: str, fq1: str, fq2: str, idx: int) -> str:
    """SAM text of chunk `idx` from the host-native Aligner(backend=None),
    chunked exactly as the CLI run (-K TASK_BASES, PE)."""
    from bwamem2_tpu_torch.align.pipeline import Aligner
    from bwamem2_tpu_torch.index.fmindex import FMIndex
    from bwamem2_tpu_torch.io.fastq import FastxReader, read_chunk
    from bwamem2_tpu_torch.options import MEM_F_PE, MemOptions
    ks1, ks2 = FastxReader(fq1), FastxReader(fq2)
    base = 0
    for _ in range(idx):
        base += len(read_chunk(ks1, ks2, TASK_BASES))
    reads = read_chunk(ks1, ks2, TASK_BASES)
    for r in reads:
        r.comment = None
    opt = MemOptions().finalize(None)
    opt.flag |= MEM_F_PE
    Aligner(FMIndex.load(prefix), opt, backend=None, verbose=0).process(
        reads, base)
    return "".join(r.sam for r in reads)


def n_chunks(fq1: str, fq2: str) -> int:
    from bwamem2_tpu_torch.io.fastq import FastxReader, read_chunk
    ks1, ks2 = FastxReader(fq1), FastxReader(fq2)
    n = 0
    while read_chunk(ks1, ks2, TASK_BASES):
        n += 1
    return n


def goldens() -> None:
    from bwamem2_tpu_torch.align.pipeline import Aligner
    from bwamem2_tpu_torch.index.fmindex import FMIndex
    from bwamem2_tpu_torch.io.fastq import FastxReader, read_chunk
    from bwamem2_tpu_torch.ops.backend import TorchBackend
    from bwamem2_tpu_torch.ops.bsw_cuda import bsw_extend
    from bwamem2_tpu_torch.options import MEM_F_PE, MemOptions
    fx = os.path.join(REPO, "tests", "fixtures")
    data = os.path.join(REPO, "tests", "data")
    fm = FMIndex.load(os.path.join(fx, "ref_small.fa"))
    for golden, fqs, pe in (("golden_se.sam", ("reads_se.fq",), False),
                            ("golden_pe.sam", ("reads_r1.fq", "reads_r2.fq"),
                             True)):
        opt = MemOptions().finalize(None)
        if pe:
            opt.flag |= MEM_F_PE
        ks = [FastxReader(os.path.join(data, f)) for f in fqs]
        reads = read_chunk(ks[0], ks[1] if pe else None, 10**9)
        n0 = bsw_extend.launches
        backend = TorchBackend(fm, opt)
        Aligner(fm, opt, backend=backend, verbose=0).process(reads, 0)
        if not backend._bsw.encj.is_cuda:
            fail(f"{golden}: the read grid is not on the card")
        with open(os.path.join(fx, golden)) as f:
            want = [ln for ln in f if not ln.startswith("@")]
        ours = "".join(r.sam for r in reads).splitlines(keepends=True)
        if ours != want:
            bad = sum(a != b for a, b in zip(ours, want))
            fail(f"{golden} differs on cuda ({bad} lines of {len(want)}, "
                 f"{len(ours)} produced)")
        if bsw_extend.launches == n0:
            fail(f"{golden}: the kernel was not launched")
        log(f"  {golden}: identical ({len(want)} records, "
            f"{bsw_extend.launches - n0} kernel launches)")


def main() -> None:
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: no CUDA device")
    if not os.path.isdir(os.path.join(REPO, "bwamem2_tpu_torch")):
        fail("bwamem2_tpu_torch/ not found beside chip_smoke.py: run from "
             "a checkout of the repository")
    sys.path.insert(0, REPO)
    t_start = time.perf_counter()

    card = card_line()
    name = torch.cuda.get_device_name(0)
    log(f"[1] card: {card} (torch {torch.__version__}, CUDA "
        f"{torch.version.cuda})")

    secs = build_all()
    log("[2] build: " + ", ".join(f"{k} {v:.1f}s" for k, v in secs.items()))

    from bwamem2_tpu_torch import benchdata
    from bwamem2_tpu_torch.index.fmindex import FMIndex
    from bwamem2_tpu_torch.options import MemOptions
    t0 = time.perf_counter()
    prefix, fq1, fq2 = benchdata.ensure(
        os.path.join(REPO, ".tmp", f"bench_scale{DATA_SCALE}"), DATA_SCALE,
        N_PAIRS)
    fm = FMIndex.load(prefix)
    log(f"[3] data: l_pac={fm.l_pac} ({DATA_SCALE}x chr21), {N_PAIRS} "
        f"pairs, {time.perf_counter() - t0:.1f}s")

    # ---- main path: counts to 0, drive the CLI entry, read the counts
    from bwamem2_tpu_torch import cli
    from bwamem2_tpu_torch.ops.bsw_cuda import bsw_extend
    from bwamem2_tpu_torch.utils.profiling import PROF
    os.makedirs(WORK, exist_ok=True)
    sam = os.path.join(WORK, "main_path.sam")
    PROF.t.clear()
    PROF.n.clear()
    bsw_extend.launches = 0
    bsw_extend.plain_calls = 0
    t0 = time.perf_counter()
    rc = cli.main(["mem", "-K", str(TASK_BASES), "-v", "1", "-o", sam,
                   prefix, fq1, fq2])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, plain = bsw_extend.launches, bsw_extend.plain_calls
    if rc != 0:
        fail(f"mem exited with {rc}")
    if launches == 0:
        fail("main path ran without launching bsw_extend")
    if plain:
        # a CPU read grid is the only way to the plain version: none means
        # every rung group's grid (encj) was a CUDA tensor
        fail(f"main path ran the plain version {plain} times on cuda")
    n_reads = 2 * N_PAIRS
    chunks = n_chunks(fq1, fq2)
    phases = {k: round(v, 3) for k, v in sorted(PROF.t.items())}
    log(f"[4] main path: {n_reads} reads in {wall:.2f}s = "
        f"{n_reads / wall:.1f} reads/s, {chunks} chunks, bsw_extend "
        f"launches {launches} [{card}]")
    log(f"  host phases (s): {json.dumps(phases)}")

    # the host-native oracle (one process per chunk) runs while the kernel
    # is held against its plain version and the goldens run
    # (leaving the `with` terminates the pool, also when a phase fails)
    import multiprocessing as mp
    t0 = time.perf_counter()
    with mp.get_context("spawn").Pool(min(chunks, os.cpu_count() or 1)) \
            as pool:
        futs = [pool.apply_async(oracle_chunk, (prefix, fq1, fq2, i))
                for i in range(chunks)]
        log(f"[5] kernel vs plain on {name}, P={P_KERNEL} per rung:")
        tot = kernel_vs_plain(torch, fm, MemOptions().finalize(None))
        log(f"  all rungs identical; kernel {tot['ms']:.3f} ms, plain "
            f"{tot['plain_ms']:.1f} ms, bound {tot['bound_ms']:.4f} ms "
            f"({tot['cells']} cells) [{card}]")
        log("[6] goldens on cuda:")
        goldens()
        oracle = "".join(f.get() for f in futs)
    ours = [ln for ln in read_sam_body(sam) if not ln.startswith("@")]
    want = oracle.splitlines(keepends=True)
    if ours != want:
        bad = sum(a != b for a, b in zip(ours, want))
        fail(f"main-path SAM differs from the host-native run: {bad} of "
             f"{len(want)} records ({len(ours)} produced)")
    log(f"[7] main-path SAM == host-native Aligner(backend=None) SAM "
        f"({len(want)} records; oracle {time.perf_counter() - t0:.1f}s)")

    kern = dict(name="bsw_extend", route="cuda",
                source="bwamem2_tpu_torch/csrc/bsw_extend.cu",
                replaces="bwamem2_tpu/ops/bsw_pallas.py:69",
                launches=launches, max_abs_err=tot["err"],
                ms=round(tot["ms"], 4), plain_ms=round(tot["plain_ms"], 3),
                bound_ms=round(tot["bound_ms"], 5),
                bound_by=("operations" if tot["ops_ms"] >= tot["mem_ms"]
                          else "bytes"),
                library_ms=None,
                shape=f"sum over {len(Q_RUNGS) * len(T_RUNGS)} rungs "
                      f"(Q x T), P={P_KERNEL} each")
    result = dict(kernels=[kern], card=card, reads=n_reads,
                  wall_s=round(wall, 3), reads_per_s=round(n_reads / wall, 1),
                  build_s={k: round(v, 1) for k, v in secs.items()},
                  phases_s=phases,
                  total_s=round(time.perf_counter() - t_start, 1))
    with open(os.path.join(WORK, "chip_smoke.json"), "w") as f:
        json.dump(result, f, indent=1)
    log(f"[done] {result['total_s']}s")
    print(json.dumps({"kernels": [kern]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()

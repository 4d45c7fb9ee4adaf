#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (bwamem2_tpu_torch).

Run from the root of a checkout on a machine with an NVIDIA GPU (written
for the H100, sm_90a):

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no result line):
  1. the card's name and power limit (nvidia-smi);
  2. build: the thirteen CUDA kernels (one nvcc per csrc/*.cu: bsw_extend,
     bsw_shear, smem_collect, sa_resolve, kswv (with kswv_phase),
     row_gather, round1_walk, round1_compact, round1_chain,
     round2_forward, round2_backward, round3_replay), the
     sharded index's peer_access.cu and the native host runtime (g++) from
     the checkout's sources, all started together;
     the registers, spills and stack frame of each bsw_extend
     instantiation (lanes x columns per lane), each bsw_shear
     instantiation (int32 slots and 16-bit registers per lane, and the
     shared-memory frame; none may spill or have a stack frame), each
     kswv and kswv_phase instantiation (u8/i16 x
     register bucket or shared-memory stripes), each round1_compact
     instantiation (with and without the K-mer table; neither may spill
     or have a stack frame), each smem_collect
     instantiation, each sa_resolve instantiation (walks per lane) and
     round1_walk, the last two of which must have no stack frame (each
     over both index views, FmView and FmShardView; round1_walk's may not
     spill either), each per-stage
     seeding kernel over both views (round2_forward's and
     round2_backward's may not spill or have a stack frame);
  3. data: a synthetic 11.7 Mbp genome (scale 0.25 of the chr21 class, the
     size of a yeast genome) with repeat families and N runs, its index and
     10,000 2x150 bp pairs, made once from fixed seeds under .tmp/;
     3b. the seeding stage's first call on run (a)'s first chunk in a fresh
     process, split into the kernels' library load, the CUDA context, the
     index upload and the first FusedSeeder.run's pieces, beside the same
     pieces warm;
  4. main path: `mem` PE through the port's CLI entry on cuda, driven
     three times, each with every launch counter set to 0 just before and
     read just after: (a) default options with a 2.25 Mbp task size (`-K`,
     2 chunks) on the 10,000 pairs; (b) the CLI's default task size (10
     Mbp: a 66,668-read chunk) on 35,000 pairs of the same genome; (c)
     -A52 (-B scaled to 208, which bwa-mem2's int8 score matrix holds as a
     mismatch of +48) on the first 2,000 pairs, -K as (a).  In each,
     smem_collect, sa_resolve and bsw_extend launch at least once per
     chunk and kswv at least once per chunk with rescue problems, no plain
     version runs, every read is seeded on the device route, at most 1 %
     of the reads overflow to the host seeding oracle, and every rescue SW
     takes its result from the chunk's kswv batch (`overflow.rescue_miss`
     is 0); the counters overflow.fused_read, overflow.long_read (reads
     too long for the read grid, seeded on the host; none may happen here)
     and rescue.i16_wide (i16 rescues that can saturate, in the kernel)
     are printed;
     (d) `mem -x pacbio` (SE) on 200 reads of 2-8 kb sampled from the same
     genome (benchdata.sample_reads_long: ~10 % error, half reverse-
     complemented), default task size: the object-path extension, whose
     long pairs run on bsw_shear and in-cap pairs on bsw_extend; both
     launch, no plain version runs, no read is too long for the read grid
     and no extension pair runs on the host kernel
     (overflow.bsw_host_tail 0); its PROF phases are printed;
     (e) round-robin: run (a)'s data through run_pipeline with one
     TorchBackend per visible card (two on cuda:0 where one card is
     visible; the line says which), one worker each: its SAM equals run
     (a)'s and every backend launched smem_collect, bsw_extend and kswv on
     its own chunks (TorchBackend.launches);
     (f) shards: `mem --shard 0:2` and `--shard 1:2` (--out-dir) as two
     processes at once on the card over run (a)'s data at -K 600,000 (5
     chunks), then `merge`, whose SAM equals this process's unsharded run;
     (g) sharded index: run (a)'s data through `mem` with
     BWAMEM2_TPU_SHARD_INDEX set over the visible cards (two shards on
     cuda:0 where one card is visible): the per-stage seeding kernels,
     sa_resolve, bsw_extend and kswv launch, smem_collect does not, no
     plain version runs, the SAM equals run (a)'s, and the reads taking a
     host route (overflow.r1_pivot_cap, overflow.long_read) stay within
     1 %; the pivots of the wide candidate tier are printed;
     (h) the legacy round 1: run (a)'s data through run_pipeline with one
     TorchBackend(pivot_seeding=False) and its K-mer table (K = 8 at this
     genome's size): round1_compact, the round-2 and round-3 per-stage
     kernels, sa_resolve, bsw_extend and kswv launch, smem_collect and
     round1_chain do not, no plain version runs, the SAM equals run (a)'s
     and the reads on the host oracle (overflow.r1_compact_cap,
     overflow.long_read) stay within 1 %; its wall and seeding rounds are
     printed; then the port's kernel_micro entry on this genome, one
     timed call a line, whose kswv_phase and bsw_shear_tiles must launch;
     (i) the host ceiling: run (a)'s data through
     bwamem2_tpu_torch/tools/host_ceiling.py's DeviceTap (warm, clean,
     record and two replay passes, one worker): every launch counter 0
     across the replays, no replay lookup missed, the replay's SAM equals
     run (a)'s; its JSON (reads, wall_e2e_1worker_s, wall_host_s,
     host_frac_of_e2e, host_ceiling_rps, wall_at_10x_device_s,
     implied_rps_at_10x_device) is printed with the card;
     (j) run (a) again in a fresh process under BWAMEM2_TPU_TRACE (the
     trace hook, utils/profiling.py): smem_collect, sa_resolve,
     bsw_extend and kswv each appear in the Chrome trace as many times as
     its launch counter says, the SAM equals run (a)'s, and the card's
     busy share (the union of the trace's kernel intervals over the traced
     wall) is printed;
  5. kernel vs plain, exact equality, with times and bounds:
     a. bsw_extend against bsw_desc_ref at every production rung (Q in
        127/255/383 x T in 96..608) with P = 4096 real-length descriptors,
        then on the main path's own launches of run (b)'s first chunk
        (captured as the pipeline makes them, longest pairs first; their
        summed time and bound are the kernel's line), each launch with its
        (lanes, columns) bucket, groups per block and the instantiation's
        ptxas numbers, and the earlier one-thread design's times beside
        the kernel's; then bsw_tiles against bsw_desc_ref on
        tools/pallas_parity_hw.py's matrix (its eight scoring
        configurations: asymmetric gaps, -A2 scaling, zdrop off; random
        lengths and h0, ~10 % mutations);
     e. bsw_shear against bsw_shear_desc_ref on run (d)'s own launches
        (captured as DeviceBSW._run makes them: one call per side and
        band try, a launch per body it uses), each timed with CUDA events
        beside its bound (10 operations per band cell the plain version
        counts, and bytes), with the share of its pairs in each body
        (16-bit, int32), its launch shape and the instantiations' ptxas
        numbers, and the call's longest pair launched alone in the body it
        took: its rows and microseconds a row;
     b. the smem_collect and sa_resolve wrappers against smem_collect_ref
        and sa_resolve_ref on 2,048 reads of the smoke FASTQ and on the
        first chunk of each main-path run (15,000 and 66,668 reads), with
        their SA positions; smem_collect at each lane width (16 and 32
        lanes per read, all identical, each timed, with its ptxas numbers
        and launch shape), sa_resolve at each walk count per lane and
        block size (all identical to the plain version, each timed, beside
        the earlier one-thread design's time), its bound the larger of
        bytes and operations,
        its overflow share (at most 1 % on the chunks); at both chunks the
        backend's collect_chunk arrays also equal the native host oracle's;
     d. the same at DRAM scale: one default-size chunk (66,668 reads) on a
        genome of scale 2.0 (93.4 Mbp, an occ table beyond the 50 MB L2),
        the timed launch's output on its first 2,048 reads held against
        smem_collect_ref on those reads;
     c. kswv against kswv_two_phase_ref on the rescue problems of the
        first chunk of each main-path run (captured as the pipeline hands
        them to TorchBackend.rescue_batch), on a synthetic i16-class batch
        (qlen 250-512, windows up to 2,048), on a batch of longer
        problems (qlen 513-1,500 in the i16 class, windows up to 4,000 in
        the u8 class), on an i16 batch at a = 64 whose scores saturate
        at 32767 (qlen 513-700) and on the i16 batch's problems at -A52,
        each class in DeviceKswv's launch order with the
        launch's stripe placement, groups per block and ptxas numbers, and
        the earlier one-thread design's time beside the kernel's;
        DeviceKswv.align_batch against the native ksw_align on the same
        problems, whose host seconds are timed;
     f. the seed-extend step (ops/entry.py:seed_extend_step: round1_walk,
        sa_resolve, bsw_tiles) on the card on the compile-check batch (32
        x 128 on tests/fixtures/ref_tiny.fa) and on run (a)'s first chunk
        at full width (15,000 reads, L = 152), its launch counters set to
        0 just before and read just after; all five outputs equal the CPU
        path's (plain versions), and sharded_seed_extend over make_mesh()
        equals the one-card step; on the chunk, round1_walk, the step's
        bsw_extend launch and its sa_resolve launch each timed against
        its plain version on the card, beside its bound (round1_walk's
        from the LF steps by class (s = 1, both ends in one block, two
        blocks) and the distinct occ rows its plain version counts, with
        the two-count bound beside it); round1_walk again over the
        index with an all-zero count-hi plane marked present (the
        kernel's has_hi body, the same answers);
     g. round1_chain, round2_forward, round2_backward (both entries) and
        round3_replay against their plain versions on the card on the
        launches of run (g)'s first chunk, exact, timed with CUDA events
        beside the bound from the steps and distinct occ rows the plain
        versions count, a line per launch with its longest walk in steps
        (round 2) or its longest chain in dependent loads (round1_chain,
        round3_replay: the plain version's per-read count); each also over
        the replicated index (exact, timed); sa_resolve over the two
        shards against the replicated index on that chunk's positions,
        round1_walk over two shards against its plain version on run
        (a)'s first chunk (also with the zero hi plane), and
        the seed-extend step over a 2-shard index against phase f's
        replicated step, each exact and the first two timed; with several
        cards, sa_resolve over one shard per card (peer loads);
     h. round1_compact against round1_compact_ref on run (h)'s first-chunk
        launch at K = 8 and at K = 0, exact (also with the zero hi
        plane), timed beside the bound from the LF steps by class,
        distinct occ rows and table entries its plain version counts
        (and the two-count bound), with each instantiation's ptxas
        numbers and
        round1_walk's 5f time beside them; run (h)'s first-chunk
        round2_forward, round2_backward and round3_replay launches as in
        g (over the replicated index it ran on and over 2 shards);
        kswv_phase against kswv_phase_ref on a u8 and an i16 batch with
        mixed target directions, live flags and stop scores, and on a
        large batch of each class, each in the planner's form and the
        other (one thread a lane, or S threads a lane: the split form),
        one launch a call; bsw_shear_tiles against bsw_shear_desc_ref on
        64 long-read tiles of 1-3 kb and on 1,024, a quarter of them past
        16 bits, each in both forms (one warp a pair: a launch per body,
        on two streams; the split band, K = 2 warps a pair: one launch);
  6. the gather probe (bwamem2_tpu_torch/tools/gather_scale_probe.py) on
     cuda, its path's launch counter set to 0 before and read after; then
     row_gather against tab[idx] and torch.index_select at the probe's
     sizes and on the smoke index's own occ rows, with the probe's 32,768
     rows and with 2^22 rows, where the card's time outweighs the call's
     host work (the timed shape);
  7. goldens: tests/fixtures/golden_se.sam and golden_pe.sam reproduced on
     cuda, golden_pe.sam with its rescue batch through kswv, the SE flag
     matrix of tests/test_golden_flags.py (-A2 against the host-native
     run: its golden is a known deviation of bwa-mem2's vector kernel), and
     golden_pacbio.sam and golden_ont2d.sam (-x pacbio / -x ont2d, 25
     reads of 2-8 kb) through bsw_shear and bsw_extend, no pair on the
     host kernel; the same reads at -x pacbio -w 500, whose band radius
     (past the widest register bucket, 206) runs bsw_shear's shared-memory
     frame, their SAM held against the host-native run in phase 8;
  8. the SAM of runs (a), (c) and (d) equals the port's host-native run
     (Aligner(backend=None), one process per chunk of (a) and (c) and per
     quarter of (d)'s reads, run during phases 5-7; the first chunk of
     (a), the longest, starts after phase 3) byte for byte except @PG.
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
DEFAULT_PAIRS = 35_000   # run (b): more than one chunk at the CLI default
DEFAULT_TASK_BASES = 10_000_000   # options.chunk_size x 1 thread
P_KERNEL = 4096
Q_RUNGS = (127, 255, 383)
T_RUNGS = (96, 160, 224, 320, 448, 608)
# bound model (csrc/bsw_extend.cu header): the least int32 operations per
# band cell, the card's INT32 issue rate and memory rate (H100 SXM data
# sheet, 700 W); OPS_PER_CELL_24 is the earlier model's unfused mix,
# printed beside the bound so that the one-thread design's figures
# stay comparable
OPS_PER_CELL = 10
OPS_PER_CELL_24 = 24
INT32_OPS_PER_S = 132 * 64 * 1.98e9
HBM_BYTES_PER_S = 3.35e12
DESC_BYTES, OUT_BYTES = 36, 24
# bsw_extend times (ms) of the earlier one-thread-per-pair design (H/E in
# global scratch), measured by this script's phase 5a on an NVIDIA H100
# 80GB HBM3 at 700.00 W, printed beside the lane-group kernel's times
ONE_THREAD_BSW_MS = {"main path": 297.656, "synthetic rungs": 112.755}
# kswv bound model (csrc/kswv.cu header): the least int32 operations per
# striped cell of the main pass, by class, and per cell of the one lazy-F
# segment every row runs at least; the bytes of a problem's descriptors in
# and two rows of 6 out
KSWV_OPS_PER_CELL = {True: 10, False: 9}      # u8, i16
KSWV_LAZY_OPS = 4
KSWV_DESC_BYTES, KSWV_OUT_BYTES = 25, 48
# kswv times (ms) of the earlier one-thread-per-problem design (stripes in
# global scratch), measured by this script's phase 5c on an NVIDIA H100
# 80GB HBM3 at 700.00 W, printed beside the lane-group kernel's times
ONE_THREAD_KSWV_MS = {("chunk (a)", "u8"): 60.8931,
                      ("chunk (b)", "u8"): 267.5940,
                      ("i16 batch", "i16"): 392.8213,
                      ("long batch", "u8"): 89.8636,
                      ("long batch", "i16"): 3201.2744}
N_I16 = 1024             # problems in the synthetic i16-class batch
N_LONG = 256             # problems per class in the long-problem batch
N_WIDE = 128             # i16 problems at a = 64, whose scores saturate
N_SEED = 2048            # reads in the seeding kernel-vs-plain sample
A52_PAIRS = 2000         # pairs of the -A52 main-path run (c)
LONG_READS = 200         # 2-8 kb reads of the -x pacbio run (d)
LONG_ORACLE_PARTS = 4    # host-native pool tasks for run (d)'s oracle
WIDE_W = 500             # -w of the long-read fixture pass: band radius
                         # 500 (and 1000 on retry), past the widest register
                         # bucket (206), so bsw_shear runs its memory frame
# the DRAM-scale seeding pass: a genome of scale 2.0 (93.4 Mbp, an occ
# table of ~93 MB, beyond the 50 MB L2), one default-size chunk
DRAM_SCALE = 2.0
# smem_collect bound model (csrc/smem_collect.cu header): the least int32
# operations per backward_ext and the popcounts among them
SMEM_OPS_PER_EXT, SMEM_POPC_PER_EXT = 131, 24
# sm_90's popcount rate (16 per clock per SM) and instruction issue (4
# warp schedulers: 128 lanes a clock per SM), CUDA C++ Programming Guide's
# arithmetic-instruction throughput table and Hopper tuning guide
POPC_OPS_PER_S = 132 * 16 * 1.98e9
ISSUE_OPS_PER_S = 132 * 128 * 1.98e9
# smem_collect times (ms) of the earlier one-thread-per-read design (the
# candidate lists in global scratch), measured by this script's phase 5b
# on an NVIDIA H100 80GB HBM3 at 700.00 W, printed beside the lane-group
# kernel's times
ONE_THREAD_SMEM_MS = {"sample": 7.955, "chunk (a)": 11.580,
                      "chunk (b)": 23.835}
# sa_resolve: the block sizes timed at each walk count per lane (phases
# 5b and 5d), and the times (ms) of the earlier one-thread-per-position
# design, measured by this script's phases 5b and 5d on an NVIDIA H100
# 80GB HBM3 at 700.00 W, printed beside the refill kernel's
SA_THREADS = (128, 256, 512)
ONE_THREAD_SA_MS = {"sample": 0.049, "chunk (a)": 0.116,
                    "chunk (b)": 0.390, "DRAM chunk": 0.500}
P_GATHER = 1 << 22       # rows of the timed row_gather calls
PROBE_SIZES_MB = (4, 16, 64, 256, 1024, 2048, 4096)
MAX_OVERFLOW = 0.01      # share of main-path reads allowed to the oracle
# the --shard phase's task size: 5 chunks of run (a)'s 20,000 reads
SHARD_TASK_BASES = 600_000
# round1_walk and round1_compact bound model (csrc/round1_walk.cu
# header): the least int32 operations and popcounts of an LF step by
# class: s > 1 with its ends in two blocks, s > 1 in one block, s = 1 with
# the interval extended, s = 1 with the interval emptied;
# R1_OPS_PER_STEP, R1_POPC_PER_STEP: the earlier model, two counts a step
R1_CLASS_OPS = dict(two_row=(63, 8), one_block=(52, 8), single=(39, 4),
                    single_empty=(13, 0))
R1_OPS_PER_STEP, R1_POPC_PER_STEP = R1_CLASS_OPS["two_row"]
# the legacy round-1 configuration (phases 4h, 5h): the K-mer table's
# depth at the smoke genome's size (index/klut.py:default_k) and the
# one-phase kswv and tile-form bsw_shear batches
LEGACY_K = 8
PHASE_U8, PHASE_I16 = 2048, 512        # one-phase kswv problems per class
# the large batches at which 5h holds both forms of kswv_phase (u8, i16)
# and bsw_shear_tiles to their plain versions
PHASE_LARGE_U8, PHASE_LARGE_I16, SHEAR_LARGE = 16384, 2048, 1024
# run (b)'s first-chunk kswv launches (phase 5c), saved for
# bwamem2_tpu_torch/tools/small_batch_probe.py --kswv-b
KSWV_B: list = []
SHEAR_TILES = (64, (1000, 3000), 100)  # tile pairs, query lengths, Wh


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
def kernels():
    """The wrappers of the thirteen kernels, by name (kswv and kswv_phase
    are two kernels of one library)."""
    from bwamem2_tpu_torch.ops.bsw_cuda import bsw_extend
    from bwamem2_tpu_torch.ops.bsw_shear_cuda import bsw_shear
    from bwamem2_tpu_torch.ops.kswv_cuda import kswv, kswv_phase
    from bwamem2_tpu_torch.ops.row_gather import row_gather
    from bwamem2_tpu_torch.ops.seed import sa_resolve, smem_collect
    from bwamem2_tpu_torch.ops.smem import (round1_chain, round1_compact,
                                            round1_walk, round2_backward,
                                            round2_forward, round3_replay)
    return dict(bsw_extend=bsw_extend, bsw_shear=bsw_shear,
                smem_collect=smem_collect, sa_resolve=sa_resolve, kswv=kswv,
                kswv_phase=kswv_phase, row_gather=row_gather,
                round1_walk=round1_walk, round1_compact=round1_compact,
                round1_chain=round1_chain, round2_forward=round2_forward,
                round2_backward=round2_backward, round3_replay=round3_replay)


# the SE flag matrix of tests/test_golden_flags.py:SE_CASES (phase 7):
# flags and golden; None: held against the host-native run (-A2, whose
# golden is a known deviation of bwa-mem2's vectorized 8-bit kernel)
SE_FLAGS = (("-a", "golden_se_a.sam"), ("-Y", "golden_se_Y.sam"),
            ("-5", "golden_se_5.sam"), ("-T20", "golden_se_T20.sam"),
            ("-h10", "golden_se_h10.sam"), ("-L3,7", "golden_se_L3_7.sam"),
            ("-O5,4 -E2,1", "golden_se_O5_4E2_1.sam"),
            ("-B2", "golden_se_B2.sam"), ("-k15", "golden_se_k15.sam"),
            ("-r1.2", "golden_se_r1_2.sam"), ("-c100", "golden_se_c100.sam"),
            ("-D0.3", "golden_se_D0_3.sam"), ("-A2", None),
            ("-y10", "golden_se_y10.sam"), ("-s5", "golden_se_s5.sam"))
# the index views a kernel is instantiated over (fm_occ.cuh: FmViewOf)
VIEWS = ("FmView", "FmShardView")
# the per-stage seeding kernels of the sharded index (phase 4g)
STAGES = ("round1_chain", "round2_forward", "round2_backward",
          "round3_replay")


def ptxas_table(text: str) -> dict:
    """{entry function: registers, spill bytes (stores + loads), stack
    frame bytes} from nvcc -Xptxas -v output."""
    import re
    out, cur = {}, None
    for ln in text.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?(\w+)'?", ln)
        if m:
            cur = out.setdefault(m.group(1), {})
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", ln)
        if m and cur is not None:
            cur.update(stack=int(m[1]), spill=int(m[2]) + int(m[3]))
        m = re.search(r"Used (\d+) registers", ln)
        if m and cur is not None:
            cur["registers"] = int(m[1])
    return out


def instances(text: str, kernel: str) -> dict:
    """{template arguments: ptxas numbers} of a kernel's instantiations:
    (G, C) of bsw_extend_kernel<G, C>, (C,) of bsw_shear_kernel<C>,
    (R,) of bsw_shear_s16_kernel<R>, (u8, SMAX) of kswv_kernel<U8, SMAX>
    (SMAX 0 = shared-memory stripes), (G, LCAP) of
    smem_collect_kernel<G, LCAP>, (W, sharded) of sa_resolve_kernel<W,
    SHARDED>, (sharded,) of the per-stage and round1_walk kernels."""
    import re
    out = {}
    for name, v in ptxas_table(text).items():
        m = re.search(kernel + r"_kernelI((?:L[ib]\d+E)+)E", name)
        if m:
            out[tuple(int(x) == 1 if t == "b" else int(x) for t, x in
                      re.findall(r"L([ib])(\d+)E", m[1]))] = v
    return out


def build_all() -> dict:
    """One nvcc per kernel source and g++, all started together; returns
    seconds per build."""
    from bwamem2_tpu_torch.native import get_lib
    secs, errs = {}, []

    def timed(name, fn):
        t0 = time.perf_counter()
        try:
            fn()
        except Exception as e:  # reported below; the run fails
            errs.append(f"{name}: {e}")
        secs[name] = time.perf_counter() - t0

    from bwamem2_tpu_torch.parallel.shard_index import PEER
    jobs = list({f"nvcc {k.SOURCES[0]}": k.lib
                 for k in kernels().values()}.items())   # one per library
    jobs.append(("nvcc peer_access.cu", PEER.lib))
    jobs.append(("g++ native runtime", get_lib))
    ts = [threading.Thread(target=timed, args=j) for j in jobs]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    if errs:
        fail("build failed:\n" + "\n".join(errs))
    for name, k in kernels().items():
        inst = sorted(instances(k.build_log, name).items())
        if name in ("kswv", "kswv_phase"):    # one line per instantiation
            # the two kernels share a library: whichever built it has
            # the log
            text = k.build_log or kernels()["kswv"].build_log \
                or kernels()["kswv_phase"].build_log
            inst = sorted(instances(text, name).items())
            for (u8, smax), v in inst:
                log(f"  ptxas {name}<{'u8' if u8 else 'i16'}, SMAX={smax}>: "
                    f"{v.get('registers')} registers, {v.get('spill')} B "
                    f"spilled, {v.get('stack')} B stack frame")
            if name == "kswv_phase":
                # the split form: S threads a lane, SMAX segments each
                split = sorted(instances(text, "kswv_split").items())
                for (u8, smax, S), v in split:
                    log(f"  ptxas kswv_phase split<{'u8' if u8 else 'i16'}, "
                        f"SMAX={smax}, S={S}>: {v.get('registers')} "
                        f"registers, {v.get('spill')} B spilled, "
                        f"{v.get('stack')} B stack frame")
                if text and len(split) != 6:
                    fail(f"kswv_phase: {len(split)} split instantiations "
                         "(6 expected)")
                if any(v.get("spill") or v.get("stack")
                       for _, v in inst + split):
                    fail(f"kswv_phase: instantiations {inst + split} (none "
                         "may spill or have a stack frame)")
            continue
        if name == "round1_compact":
            if not k.build_log:
                continue        # built before this run: no ptxas output
            for (lut,), v in inst:
                log(f"  ptxas round1_compact<LUT={int(lut)}>: "
                    f"{v.get('registers')} registers, {v.get('spill')} B "
                    f"spilled, {v.get('stack')} B stack frame")
            if len(inst) != 2 or any(v.get("stack") or v.get("spill")
                                     for _, v in inst):
                fail(f"round1_compact: instantiations {inst} (neither may "
                     "spill or have a stack frame)")
            continue
        if name == "smem_collect":
            for (G, lcap), v in inst:
                log(f"  ptxas smem_collect<G={G}, LCAP={lcap}>: "
                    f"{v.get('registers')} registers, {v.get('spill')} B "
                    f"spilled, {v.get('stack')} B stack frame")
            continue
        if name == "bsw_extend":
            for (G, C), v in inst:
                log(f"  ptxas bsw_extend<G={G}, C={C}>: "
                    f"{v.get('registers')} registers, {v.get('spill')} B "
                    f"spilled, {v.get('stack')} B stack frame")
            continue
        if name == "bsw_shear":
            if not k.build_log:
                continue        # built before this run: no ptxas output
            wide = [v for n, v in ptxas_table(k.build_log).items()
                    if "bsw_shear_wide_kernel" in n]
            s16 = sorted(instances(k.build_log, "bsw_shear_s16").items())
            rows = [(f"bsw_shear<C={C}> (int32, frame {32 * C})", v)
                    for (C,), v in inst]
            rows += [(f"bsw_shear_s16<R={r}> (16-bit, frame {64 * r})", v)
                     for (r,), v in s16]
            rows += [("bsw_shear_wide (int32, frame in shared memory, C at "
                      "run time)", v) for v in wide]
            blk = sorted(instances(k.build_log, "bsw_shear_blk").items())
            rows += [(f"bsw_shear_blk<K={K_}, C={C}> (split band, {K_} "
                      f"warps a pair, frame {32 * K_ * C})", v)
                     for (K_, C), v in blk]
            for label, v in rows:
                log(f"  ptxas {label}: {v.get('registers')} registers, "
                    f"{v.get('spill')} B spilled, {v.get('stack')} B stack "
                    "frame")
            if len(inst) != 2 or len(s16) != 2 or len(wide) != 1 \
                    or len(blk) != 2 or any(v.get("spill") or v.get("stack")
                                            for _, v in rows):
                fail(f"bsw_shear: instantiations {rows} (two register "
                     "buckets in each body, the shared-memory frame and "
                     "two split-band buckets, none spilling or with a "
                     "stack frame)")
            continue
        if name == "sa_resolve":
            if not k.build_log:
                continue        # built before this run: no ptxas output
            for (W, sh), v in inst:
                log(f"  ptxas sa_resolve<W={W}, {VIEWS[sh]}>: "
                    f"{v.get('registers')} registers, {v.get('spill')} B "
                    f"spilled, {v.get('stack')} B stack frame")
            frames = {(W, sh): v.get("stack") for (W, sh), v in inst}
            if sorted(frames) != sorted((W, sh) for W in k.WALKS
                                        for sh in (0, 1)) \
                    or any(frames.values()):
                fail(f"sa_resolve: stack frames by walks per lane and view "
                     f"{frames} (every instantiation of {k.WALKS} must have "
                     "none)")
            continue
        if name == "round1_walk" or name in STAGES:
            if not k.build_log:
                continue        # built before this run: no ptxas output
            for (sh,), v in inst:
                log(f"  ptxas {name}<{VIEWS[sh]}>: {v.get('registers')} "
                    f"registers, {v.get('spill')} B spilled, "
                    f"{v.get('stack')} B stack frame")
            if name == "round1_walk" and (len(inst) != 2 or any(
                    v.get("stack") or v.get("spill") for _, v in inst)):
                fail(f"round1_walk: instantiations {inst} (neither view's "
                     "may spill or have a stack frame)")
            if name.startswith("round2") and (len(inst) != 2 or any(
                    v.get("stack") or v.get("spill") for _, v in inst)):
                fail(f"{name}: instantiations {inst} (one over each view, "
                     "none spilling or with a stack frame)")
            continue
        for ln in k.build_log.splitlines():
            if "registers" in ln or "spill" in ln or "error" in ln.lower():
                log(f"  ptxas {name}: {ln.strip()}")
    return secs


# ------------------------------------------------------ measurement layer
# the kernels of run (a)'s path and the name CUPTI gives each in a trace:
# its __global__ function (kswv_kernel is the two-phase kernel; the
# one-phase kernels are kswv_phase_kernel and kswv_split_kernel)
TRACE_KERNELS = dict(smem_collect="smem_collect_kernel",
                     sa_resolve="sa_resolve_kernel",
                     bsw_extend="bsw_extend_kernel", kswv="kswv_kernel")


def host_ceiling_phase(card: str, prefix: str, fq1: str, fq2: str,
                       sam_a: str) -> dict:
    """[4i] the host ceiling on run (a)'s data (-K TASK_BASES) through
    bwamem2_tpu_torch/tools/host_ceiling.py's DeviceTap: warm, clean,
    record and two replay passes on one TorchBackend, one worker.  Fails
    unless the replays launched no kernel (every launch counter 0 across
    them), missed no recorded output and wrote run (a)'s SAM."""
    from bwamem2_tpu_torch.tools import host_ceiling
    try:
        rep = host_ceiling.measure(prefix, fq1, fq2, TASK_BASES, "cuda",
                                   log=lambda m: log(f"    {m}"))
    except Exception as e:      # a miss, device work or a SAM difference
        fail(f"4i: {type(e).__name__}: {e}")
    rep.pop("tap")
    if rep["replay_launches"] or rep["replay_plain_calls"] or rep["misses"]:
        fail(f"4i: the replay ran device work: {rep}")
    got, want = sam_records(rep.pop("sam"), False), sam_records(sam_a)
    if got != want:
        fail(f"4i: the replay's SAM differs from run (a)'s "
             f"({sum(x != y for x, y in zip(got, want))} of {len(want)} "
             f"records)")
    log(f"  [4i] host ceiling, run (a)'s data: {json.dumps(rep)}; replay "
        f"launches 0, misses 0, SAM == run (a)'s [{card}]")
    return rep


def trace_run(fq1: str, fq2: str, prefix: str, trace_dir: str,
              sam: str) -> None:
    """Run in a fresh process (`chip_smoke.py --trace-run ...`): run (a)
    through the CLI entry with BWAMEM2_TPU_TRACE=trace_dir, every launch
    counter set to 0 just before and read just after.  Prints one JSON
    line: the exit code, the launches, the trace's path and its host
    seconds (PROF.trace_s: the profiler's start, the traced calls, its
    stop with the export), and the call's wall."""
    import torch
    os.environ["BWAMEM2_TPU_TRACE"] = trace_dir
    from bwamem2_tpu_torch import cli
    from bwamem2_tpu_torch.utils.profiling import PROF
    K = kernels()
    for k in K.values():
        k.reset()
    t0 = time.perf_counter()
    rc = cli.main(["mem", "-K", str(TASK_BASES), "-v", "1", "-o", sam,
                   prefix, fq1, fq2])
    torch.cuda.synchronize()
    print(json.dumps(dict(rc=rc, launches={n: k.launches
                                           for n, k in K.items()},
                          trace=PROF.trace_path, trace_s=PROF.trace_s,
                          wall_s=time.perf_counter() - t0)), flush=True)


def union_us(spans: list) -> float:
    """The length of the union of [start, end) intervals."""
    tot, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            tot += b - max(a, end)
            end = b
    return tot


def trace_phase(card: str, prefix: str, fq1: str, fq2: str, sam_a: str,
                wall_a: float) -> dict:
    """[4j] run (a) traced under BWAMEM2_TPU_TRACE in a fresh process
    (trace_run).  Fails unless each main-path kernel (TRACE_KERNELS)
    appears in the Chrome trace as many times as its launch counter says
    and the SAM equals run (a)'s.  Prints the card's busy share: the
    union of the trace's kernel intervals over the traced host wall."""
    import shutil
    trace_dir = os.path.join(WORK, "trace")
    shutil.rmtree(trace_dir, ignore_errors=True)
    sam = os.path.join(WORK, "main_traced.sam")
    r = subprocess.run([sys.executable, os.path.abspath(__file__),
                        "--trace-run", fq1, fq2, prefix, trace_dir, sam],
                       capture_output=True, text=True, timeout=900)
    if r.returncode:
        fail(f"4j: the traced run failed:\n{r.stderr[-3000:]}")
    run = json.loads(r.stdout.strip().splitlines()[-1])
    if run["rc"] or not run["trace"]:
        fail(f"4j: mem exited with {run['rc']}, trace {run['trace']}")
    if sam_records(sam) != sam_records(sam_a):
        fail("4j: the traced run's SAM differs from run (a)'s")
    with open(run["trace"]) as f:
        events = json.load(f)["traceEvents"]
    kern = [e for e in events if e.get("cat") == "kernel" and "dur" in e]
    copies = [e for e in events if e.get("cat") in ("gpu_memcpy",
                                                    "gpu_memset")
              and "dur" in e]
    seen = {n: sum(pat in e["name"] for e in kern)
            for n, pat in TRACE_KERNELS.items()}
    want = {n: run["launches"][n] for n in TRACE_KERNELS}
    if seen != want or not all(want.values()):
        fail(f"4j: kernels in the trace {seen}, launch counters {want}")
    wall_us = run["trace_s"]["traced"] * 1e6
    span = lambda evs: [(e["ts"], e["ts"] + e["dur"]) for e in evs]  # noqa
    busy = union_us(span(kern))
    main4 = union_us(span([e for e in kern if any(
        p in e["name"] for p in TRACE_KERNELS.values())]))
    busy_copy = union_us(span(kern + copies))
    out = dict(trace=os.path.relpath(run["trace"], REPO),
               events=len(events), kernels_in_trace=len(kern),
               launches=want, trace_s=run["trace_s"],
               call_wall_s=round(run["wall_s"], 4),
               untraced_wall_a_s=wall_a,
               busy_share=round(busy / wall_us, 5),
               busy_share_main_kernels=round(main4 / wall_us, 5),
               busy_share_with_copies=round(busy_copy / wall_us, 5),
               busy_share_of_untraced_wall=round(busy / (wall_a * 1e6), 5),
               kernel_busy_ms=round(busy / 1e3, 3),
               main_kernels_ms=round(main4 / 1e3, 3),
               other_kernels=len(kern) - sum(seen.values()))
    log(f"  [4j] trace of run (a) (fresh process): {len(events)} events, "
        f"{len(kern)} kernels; in the trace {seen} == the launch "
        f"counters; SAM == run (a)'s; card busy {busy / 1e3:.3f} ms of a "
        f"traced wall of {wall_us / 1e6:.3f}s = busy share "
        f"{busy / wall_us:.5f} (the four main-path kernels "
        f"{main4 / wall_us:.5f}, with copies {busy_copy / wall_us:.5f}; "
        f"over run (a)'s untraced wall {busy / (wall_a * 1e6):.5f}); call "
        f"{run['wall_s']:.2f}s traced (profiler start "
        f"{run['trace_s']['start']:.2f}s, stop and export "
        f"{run['trace_s']['stop']:.2f}s) against run (a)'s {wall_a:.2f}s "
        f"untraced [{card}]")
    return out


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
    tot = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, bound24_ms=0.0,
               ops_ms=0.0, mem_ms=0.0, cells=0, err=0, mismatches=0,
               one_thread_ms=ONE_THREAD_BSW_MS["synthetic rungs"])
    log(f"  {'Q':>4} {'T':>4} {'cells':>11} {'kernel_ms':>10} "
        f"{'plain_ms':>10} {'bound_ms':>9} {'bound_by':>10} mismatch "
        f"bucket")
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
            b24_ms = max(cells[0] * OPS_PER_CELL_24 / INT32_OPS_PER_S * 1e3,
                         mem_ms)
            by = "operations" if ops_ms >= mem_ms else "bytes"
            G, C, gpb = bsw_extend.plan(P_KERNEL, Q, "cuda")
            log(f"  {Q:>4} {T:>4} {cells[0]:>11} {k_ms:>10.4f} "
                f"{p_ms:>10.3f} {b_ms:>9.5f} {by:>10} {bad:>8} "
                f"{G}x{C}, {gpb} groups/block")
            tot["ms"] += k_ms
            tot["plain_ms"] += p_ms
            tot["bound_ms"] += b_ms
            tot["bound24_ms"] += b24_ms
            tot["ops_ms"] += ops_ms
            tot["mem_ms"] += mem_ms
            tot["cells"] += cells[0]
            tot["err"] = max(tot["err"], err)
            tot["mismatches"] += bad
    if tot["mismatches"]:
        fail(f"bsw_extend disagrees with bsw_desc_ref on "
             f"{tot['mismatches']} pairs (max abs err {tot['err']})")
    return tot


# tools/pallas_parity_hw.py's matrix (its FULL list): (P, Qmax, Tmax, a,
# b, o_del, e_del, o_ins, e_ins, zdrop, end_bonus, h0cap); h0cap bounds
# the random h0 (below min(h0cap, 120)) and is otherwise the JAX kernel's
PALLAS_MATRIX = (
    (128, 127, 96, 1, 4, 6, 1, 6, 1, 100, 5, 256),
    (256, 127, 192, 1, 4, 6, 1, 6, 1, 100, 5, 256),
    (512, 255, 320, 1, 4, 6, 1, 6, 1, 100, 5, 256),
    (128, 255, 608, 1, 4, 6, 1, 6, 1, 100, 5, 256),
    (128, 127, 96, 1, 9, 16, 1, 16, 1, 200, 5, 256),
    (128, 127, 192, 2, 8, 12, 2, 12, 2, 100, 10, 512),
    (128, 127, 96, 1, 4, 6, 1, 13, 4, 100, 5, 256),
    (128, 127, 96, 1, 4, 6, 1, 6, 1, 0, 5, 256),
)


def pallas_tiles(rng, P: int, Qmax: int, Tmax: int, h0max: int):
    """tools/pallas_parity_hw.py:gen (tests/test_pallas.py's generator):
    random queries, targets copied from them with ~10 % of positions
    mutated and random tails, random lengths, h0 in [1, h0max)."""
    import numpy as np
    q = rng.integers(0, 4, (P, Qmax)).astype(np.int8)
    t = np.full((P, Tmax), 4, np.int8)
    qlen = rng.integers(1, Qmax + 1, P).astype(np.int32)
    tlen = rng.integers(1, Tmax + 1, P).astype(np.int32)
    for i in range(P):
        n = min(int(tlen[i]), int(qlen[i]))
        t[i, :n] = q[i, :n]
        nmut = max(1, n // 10)
        pos = rng.integers(0, n, nmut)
        t[i, pos] = rng.integers(0, 4, nmut)
        t[i, n:tlen[i]] = rng.integers(0, 4, int(tlen[i]) - n)
        q[i, qlen[i]:] = 4
    h0 = rng.integers(1, h0max, P).astype(np.int32)
    w = np.full(P, 100, np.int32)
    return q, t, qlen, tlen, h0, w


def pallas_matrix(torch) -> dict:
    """[5a] bsw_tiles (bsw_extend over tiles as descriptors) against
    bsw_desc_ref on the card, on tools/pallas_parity_hw.py's matrix: its
    scoring configurations (asymmetric gaps, -A2 scaling, zdrop off) and
    random lengths and h0 at ~10 % mutation; exact or the run fails."""
    import numpy as np
    from bwamem2_tpu_torch.ops.bsw import (_tile_descriptors, bsw_desc_ref,
                                           bsw_tiles)
    from bwamem2_tpu_torch.ops.bsw_cuda import bsw_extend
    rng = np.random.default_rng(7)
    out = dict(configs=0, pairs=0, launches=0)
    n0 = bsw_extend.launches
    for cfg in PALLAS_MATRIX:
        P, Q, T, a, b, od, ed, oi, ei, zd, eb, cap = cfg
        x = [torch.from_numpy(v).cuda()
             for v in pallas_tiles(rng, P, Q, T, min(cap, 120))]
        sc = (a, b, od, ed, oi, ei, zd, eb, max(a, 1))
        got = bsw_tiles(*x, *sc)
        ref, enc, *desc = _tile_descriptors(*x[:4])
        want = bsw_desc_ref(ref, enc, *desc, x[4], x[5], Q, T, *sc)
        bad = int((got != want).any(1).sum())
        if bad:
            fail(f"5a: bsw_tiles disagrees with bsw_desc_ref on {bad} of "
                 f"{P} pairs at {cfg}")
        out["configs"] += 1
        out["pairs"] += P
    out["launches"] = bsw_extend.launches - n0
    return out


def bsw_main_path(torch, calls) -> dict:
    """bsw_extend on the main path's own launches (the arguments the
    pipeline gave it on one chunk, one launch per rung group, longest pairs
    first), each against bsw_desc_ref (exact) and timed with CUDA events,
    with its bucket, groups per block and the instantiation's ptxas
    numbers; sums over the launches."""
    from bwamem2_tpu_torch.ops.bsw import bsw_desc_ref
    from bwamem2_tpu_torch.ops.bsw_cuda import bsw_extend
    tot = dict(launches=len(calls), pairs=0, ms=0.0, plain_ms=0.0,
               bound_ms=0.0, bound24_ms=0.0, ops_ms=0.0, mem_ms=0.0, cells=0,
               err=0, one_thread_ms=ONE_THREAD_BSW_MS["main path"],
               per_launch=[])
    ptx = instances(bsw_extend.build_log, "bsw_extend")
    ev = lambda: torch.cuda.Event(enable_timing=True)  # noqa: E731
    log(f"  {'Qmax':>4} {'T':>4} {'pairs':>7} {'cells':>11} "
        f"{'kernel_ms':>10} {'plain_ms':>10} {'bound_ms':>9} "
        f"{'24-op_ms':>9} launch")
    for args in calls:
        got = bsw_extend.launch(*args)
        cells: list = []
        e0, e1 = ev(), ev()
        e0.record()
        want = bsw_desc_ref(*args[:-1], ref_packed=args[-1], cells=cells)
        e1.record()
        torch.cuda.synchronize()
        p_ms = e0.elapsed_time(e1)
        if not torch.equal(got, want):
            bad = int((got != want).any(1).sum())
            fail(f"bsw_extend disagrees with bsw_desc_ref on {bad} main-path "
                 f"pairs (Q={args[10]}, T={args[11]})")
        k_ms = cuda_ms(torch, lambda: bsw_extend.launch(*args), 5)
        P = args[2].shape[0]
        nbytes = (P * (DESC_BYTES + OUT_BYTES) + int(args[4].sum())
                  + int(args[7].sum()))
        ops_ms = cells[0] * OPS_PER_CELL / INT32_OPS_PER_S * 1e3
        mem_ms = nbytes / HBM_BYTES_PER_S * 1e3
        b24_ms = max(cells[0] * OPS_PER_CELL_24 / INT32_OPS_PER_S * 1e3,
                     mem_ms)
        G, C, gpb = bsw_extend.plan(P, args[10], args[1].device)
        inst = ptx.get((G, C), {})
        tot["per_launch"].append(dict(
            Qmax=args[10], T=args[11], P=P, cells=cells[0], ms=k_ms,
            plain_ms=p_ms, bound_ms=max(ops_ms, mem_ms), bound24_ms=b24_ms,
            G=G, C=C,
            groups_per_block=gpb, registers=inst.get("registers"),
            spill_bytes=inst.get("spill"), stack_bytes=inst.get("stack")))
        log(f"  {args[10]:>4} {args[11]:>4} {P:>7} {cells[0]:>11} "
            f"{k_ms:>10.4f} {p_ms:>10.3f} {max(ops_ms, mem_ms):>9.5f} "
            f"{b24_ms:>9.5f} {G}x{C}, {gpb} groups/block, {inst.get('registers')} "
            f"registers, {inst.get('spill')} B spilled, "
            f"{inst.get('stack')} B stack frame")
        for key, v in (("pairs", P), ("ms", k_ms), ("plain_ms", p_ms),
                       ("bound_ms", max(ops_ms, mem_ms)),
                       ("bound24_ms", b24_ms), ("ops_ms", ops_ms),
                       ("mem_ms", mem_ms), ("cells", cells[0])):
            tot[key] += v
    return tot


def shear_main_path(torch, calls) -> dict:
    """bsw_shear on run (d)'s own calls (the arguments DeviceBSW._run gave
    it: the pairs that fit 16 bits first, n16 of them, each part by
    descending row count; a launch per body with pairs), each against
    bsw_shear_desc_ref (exact) and timed with CUDA events beside its
    bound, with the share of its pairs in each body, its launch shapes
    and the instantiations' ptxas numbers; the call's longest pair
    launched alone in the body it took, its rows and microseconds a row;
    sums over the calls.  The bound: OPS_PER_CELL int32 operations per
    band cell the plain version counts, against the descriptors, the
    query codes, the target codes of the rows a pair can run and the
    output."""
    from bwamem2_tpu_torch.ops.bsw import bsw_shear_desc_ref, long_rows
    from bwamem2_tpu_torch.ops.bsw_shear_cuda import bsw_shear
    tot = dict(calls=len(calls), launches=0, pairs=0, ms=0.0, plain_ms=0.0,
               bound_ms=0.0, ops_ms=0.0, mem_ms=0.0, cells=0, err=0,
               routes=dict(s16=0, int32=0), per_call=[])
    ptx = {(True,) + k: v for k, v in
           instances(bsw_shear.build_log, "bsw_shear_s16").items()}
    ptx.update({(False,) + k: v for k, v in
                instances(bsw_shear.build_log, "bsw_shear").items()})
    ptx.update({("blk",) + k: v for k, v in
                instances(bsw_shear.build_log, "bsw_shear_blk").items()})
    ev = lambda: torch.cuda.Event(enable_timing=True)  # noqa: E731
    log(f"  {'call':>4} {'Wh':>4} {'pairs':>6} {'16-bit':>6} {'int32':>5} "
        f"{'cells':>11} {'kernel_ms':>10} {'plain_ms':>10} {'bound_ms':>9} "
        "longest pair (rows, us/row, body), launches")
    for n, (args, kw) in enumerate(calls, 1):
        got = bsw_shear.launch(*args, **kw)
        cells: list = []
        e0, e1 = ev(), ev()
        e0.record()
        want = bsw_shear_desc_ref(*args[:-1], ref_packed=args[-1],
                                  cells=cells)
        e1.record()
        torch.cuda.synchronize()
        p_ms = e0.elapsed_time(e1)
        err = int((got - want).abs().max()) if got.numel() else 0
        tot["err"] = max(tot["err"], err)
        if not torch.equal(got, want):
            bad = int((got != want).any(1).sum())
            fail(f"bsw_shear disagrees with bsw_shear_desc_ref on {bad} of "
                 f"run (d)'s pairs (call {n}, Wh={args[10]}; max abs err "
                 f"{err})")
        k_ms = cuda_ms(torch, lambda: bsw_shear.launch(*args, **kw), 3)
        P, Wh = args[2].shape[0], args[10]
        n16 = kw.get("n16", 0)
        qlen, tlen = args[4].long(), args[7].long()
        rows = long_rows(qlen.cpu().numpy(), tlen.cpu().numpy(), Wh)
        routes = dict(s16=n16, int32=P - n16)
        # the longest pair alone, in its body (one warp: the form the
        # call's launch took), and in the split-band form the planner
        # gives a lone pair
        j = int(rows.argmax())
        one = (*args[:2], *(t[j:j + 1] for t in args[2:10]), *args[10:])
        body = "16-bit" if j < n16 else "int32"
        bsw_shear.split = 1
        one_ms = cuda_ms(torch, lambda: bsw_shear.launch(
            *one, n16=int(j < n16)), 3)
        bsw_shear.split = 0
        one_split_ms = cuda_ms(torch, lambda: bsw_shear.launch(
            *one, n16=int(j < n16)), 3)
        us_row = one_ms * 1e3 / max(int(rows[j]), 1)
        nbytes = (P * (DESC_BYTES + OUT_BYTES) + int(qlen.sum())
                  + int(torch.minimum(tlen, qlen + Wh + 2).sum()))
        ops_ms = cells[0] * OPS_PER_CELL / INT32_OPS_PER_S * 1e3
        mem_ms = nbytes / HBM_BYTES_PER_S * 1e3
        shapes = []
        split = bsw_shear.plan(P, Wh, args[1].device)[5] > 1
        for s16, m in (((False, P),) if split else
                       ((True, n16), (False, P - n16))):
            if not m:
                continue
            C, R, blocks, threads, smem, K_ = bsw_shear.plan(
                m, Wh, args[1].device, s16)
            inst = ptx.get((s16, R if s16 else C), {}) if R else {}
            if K_ > 1:
                inst = ptx.get(("blk", K_, C), {})
            shapes.append(dict(
                body="16-bit" if s16 else "int32" if K_ == 1 else
                f"split band, K={K_}", pairs=m, C=C, R=R, K=K_,
                blocks=blocks, threads=threads, shared_bytes=smem,
                registers=inst.get("registers"),
                spill_bytes=inst.get("spill"),
                stack_bytes=inst.get("stack")))
        tot["per_call"].append(dict(
            call=n, Wh=Wh, P=P, routes=routes, cells=cells[0], ms=k_ms,
            plain_ms=p_ms, bound_ms=max(ops_ms, mem_ms),
            longest_rows=int(rows[j]), longest_ms=one_ms,
            longest_us_per_row=us_row, longest_body=body,
            longest_split_ms=one_split_ms, launches=shapes))
        shape = "; ".join(
            f"{s['body']} C={s['C']} R={s['R']}, {s['blocks']} blocks x "
            f"{s['threads']}, {s['registers']} registers"
            if s["R"] or s["K"] > 1 else
            f"int32 C={s['C']} shared-memory frame {s['shared_bytes']} B, "
            f"{s['blocks']} blocks" for s in shapes)
        log(f"  {n:>4} {Wh:>4} {P:>6} {routes['s16']:>6} "
            f"{routes['int32']:>5} {cells[0]:>11} {k_ms:>10.4f} "
            f"{p_ms:>10.1f} {max(ops_ms, mem_ms):>9.5f} "
            f"({int(rows[j])}, {us_row:.4f}, {body}; split band "
            f"{one_split_ms * 1e3 / max(int(rows[j]), 1):.4f}), {shape}")
        tot["launches"] += len(shapes)
        for key, v in (("pairs", P), ("ms", k_ms), ("plain_ms", p_ms),
                       ("bound_ms", max(ops_ms, mem_ms)),
                       ("ops_ms", ops_ms), ("mem_ms", mem_ms),
                       ("cells", cells[0])):
            tot[key] += v
        for key, v in routes.items():
            tot["routes"][key] += v
    return tot


def cuda_ms(torch, fn, reps: int) -> float:
    """Mean CUDA-event milliseconds of fn() over `reps` calls, after one
    warm-up call."""
    fn()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def chunk_reads(fq1: str, fq2: str, task_bases: int):
    """The first chunk of a FASTQ pair at `task_bases`, as the CLI reads
    it."""
    from bwamem2_tpu_torch.io.fastq import FastxReader, read_chunk
    return read_chunk(FastxReader(fq1), FastxReader(fq2), task_bases)


def int_ops_s(n_ops: float, n_popc: float) -> float:
    """The least seconds for n_ops int32 operations, n_popc of them
    popcounts: the slowest of the popcount rate, the int32 rate for the
    rest and the issue rate for all.  Nothing documents whether a
    popcount shares the int32 pipe on sm_90, so the two are not added:
    the bound stays a floor either way."""
    return max(n_popc / POPC_OPS_PER_S, (n_ops - n_popc) / INT32_OPS_PER_S,
               n_ops / ISSUE_OPS_PER_S)


def smem_bounds(nbwd: int, N: int, L: int, nsm: int) -> tuple:
    """smem_collect's (bytes ms, operations ms) for these inputs: 2 occ rows
    of 32 B per backward_ext, the grid and lengths in, the written slots
    and per-read counts out; SMEM_OPS_PER_EXT operations per backward_ext,
    SMEM_POPC_PER_EXT of them popcounts (int_ops_s)."""
    nbytes = nbwd * 64 + N * (L + 4) + nsm * 24 + N * 12
    ops_s = int_ops_s(nbwd * SMEM_OPS_PER_EXT, nbwd * SMEM_POPC_PER_EXT)
    return nbytes / HBM_BYTES_PER_S * 1e3, ops_s * 1e3


def r1_bounds(stats: dict) -> dict:
    """The round-1 walk's operations bound (ms) from its plain version's
    step counts by class (R1_CLASS_OPS), the two-count bound beside
    it, and the shares of steps with both ends in one block, at s = 1 and
    at s = 1 emptying the interval."""
    n = dict(single=stats["single"] - stats["single_empty"],
             single_empty=stats["single_empty"],
             one_block=stats["wide_one_block"])
    n["two_row"] = stats["steps"] - stats["single"] - n["one_block"]
    ops = sum(n[c] * R1_CLASS_OPS[c][0] for c in n)
    popc = sum(n[c] * R1_CLASS_OPS[c][1] for c in n)
    return dict(ops_ms=int_ops_s(ops, popc) * 1e3,
                ops63_ms=int_ops_s(stats["steps"] * R1_OPS_PER_STEP,
                                   stats["steps"] * R1_POPC_PER_STEP) * 1e3,
                one_block_share=stats["one_block"] / stats["steps"],
                single_share=stats["single"] / stats["steps"],
                single_empty_share=stats["single_empty"] / stats["steps"])


def zero_hi(dfm):
    """The replicated index `dfm` with an all-zero count-hi plane marked
    present: the round-1 kernels then run their has_hi bodies (an index
    with counts past 2^32 has one) and must give the same answers."""
    import dataclasses
    import torch
    return dataclasses.replace(dfm, has_hi=True, occ_hi=torch.zeros(
        dfm.occp.shape[0], dtype=torch.int32, device=dfm.occp.device))


def seeding_vs_plain(torch, fm, passes, opt) -> dict:
    """The smem_collect and sa_resolve wrappers against their plain
    versions (exact) on each pass's read grid and its SA positions, with
    times and bounds; smem_collect at every lane width (all exact, each
    timed).  passes: (tag, fq1, fq2, task_bases, n_reads or None for the
    whole first chunk, n_ref: the plain version's reads, None for all).
    On whole chunks with every read held against the plain version, the
    backend's collect_chunk arrays are also held against the host
    oracle's."""
    import numpy as np
    from bwamem2_tpu_torch.align.seeding import encode_reads
    from bwamem2_tpu_torch.ops import seed
    from bwamem2_tpu_torch.ops.backend import (TorchBackend, _pad_reads,
                                               host_seeding)
    backend = TorchBackend(fm, opt)
    dfm = backend.dfm
    split_len = int(opt.min_seed_len * opt.split_factor + 0.499)
    ev = lambda: torch.cuda.Event(enable_timing=True)  # noqa: E731
    sm, sa = seed.smem_collect, seed.sa_resolve
    ptx = instances(sm.build_log, "smem_collect")
    sa_ptx = instances(sa.build_log, "sa_resolve")
    out = {}
    for tag, fq1, fq2, task, n_reads, n_ref in passes:
        encs = encode_reads([r.seq for r in
                             chunk_reads(fq1, fq2, task)[:n_reads]])
        enc, lens = _pad_reads(encs)
        e, ln = torch.from_numpy(enc).cuda(), torch.from_numpy(lens).cuda()
        N, L = e.shape
        off = seed.slot_offsets(ln)
        lcap = seed.list_cap(L)
        rest = (opt.min_seed_len, split_len, int(opt.split_width),
                int(opt.max_mem_intv), lcap)
        args = (dfm, e, ln) + rest + (off,)
        per_lanes, outs = {}, {}
        chosen = sm.lanes_for(N)
        try:
            for G in sm.LANES:
                # each width in turn: lanes_for replaced on the instance
                sm.lanes_for = lambda n, G=G: G
                outs[G] = sm(*args)
                torch.cuda.synchronize()
                blocks, threads, smem = sm.plan(G, lcap, "cuda")
                inst = ptx.get((G, lcap), {})
                per_lanes[G] = dict(
                    ms=cuda_ms(torch, lambda: sm(*args), 3), blocks=blocks,
                    threads=threads, shared_bytes=smem,
                    registers=inst.get("registers"),
                    spill_bytes=inst.get("spill"),
                    stack_bytes=inst.get("stack"))
        finally:
            del sm.lanes_for
        got = outs[chosen]
        # every lane width gives the same slots, counts and step counts
        cnt = got[4].long().clamp(min=0)
        valid = (torch.arange(int(off[-1]), device=e.device)
                 - torch.repeat_interleave(off[:-1], off.diff())) \
            < torch.repeat_interleave(cnt, off.diff())
        for G, o in outs.items():
            same = torch.equal(o[4], got[4]) and torch.equal(o[5], got[5])
            for x, y in zip(o[:4], got[:4]):
                same = same and torch.equal(x[valid], y[valid])
            if not same:
                fail(f"{tag}: smem_collect with {G} lanes differs from "
                     f"{chosen} lanes")
        m_c, n_c, s_c, pos = seed.compact_and_expand(*got[:5], off,
                                                     int(opt.max_occ))
        # sa_resolve at every shape (walks per lane x threads per block,
        # shape_for replaced on the instance), each timed; every shape's
        # output is held against the plain version below
        P = pos.numel()
        sa_shape = sa.shape_for(P)
        per_shape, sa_outs = {}, {}
        try:
            for W in sa.WALKS:
                for T in SA_THREADS:
                    sa.shape_for = lambda n, W=W, T=T: (W, T)
                    sa_outs[W, T] = sa(dfm, pos)
                    inst = sa_ptx.get((W,), {})
                    per_shape[W, T] = dict(
                        ms=cuda_ms(torch, lambda: sa(dfm, pos), 5),
                        blocks=sa.plan(W, T, P, pos.device),
                        registers=inst.get("registers"),
                        stack_bytes=inst.get("stack"))
        finally:
            del sa.shape_for
        torch.cuda.synchronize()
        coords = sa_outs[sa_shape]
        sm_ms = per_lanes[chosen]["ms"]
        sa_ms = per_shape[sa_shape]["ms"]
        nbwd, nsm = int(got[5].sum()), int(s_c.numel())
        overflowed = int((got[4] < 0).sum())
        r = dict(reads=N, L=L, list_cap=lcap, slots=int(off[-1]),
                 smems=nsm, positions=P, bwd_ext=nbwd, overflowed=overflowed,
                 overflow_share=overflowed / N, lanes=chosen,
                 per_lanes=per_lanes, smem_ms=sm_ms, sa_ms=sa_ms,
                 one_thread_ms=ONE_THREAD_SMEM_MS.get(tag),
                 sa_shape=list(sa_shape),
                 sa_shapes={f"{W}x{T}": v for (W, T), v in per_shape.items()},
                 sa_one_thread_ms=ONE_THREAD_SA_MS.get(tag))
        mem_ms, ops_ms = smem_bounds(nbwd, N, L, nsm)
        r.update(smem_bound_ms=max(mem_ms, ops_ms), smem_mem_ms=mem_ms,
                 smem_ops_ms=ops_ms,
                 smem_bound_by="operations" if ops_ms >= mem_ms else "bytes")
        # the plain version on all reads, or on the first n_ref of them,
        # against the timed launch's own output: their slots are a prefix
        # of the flat buffers (slot_offsets is a prefix sum)
        sub = slice(None) if n_ref is None else slice(0, n_ref)
        sargs = (dfm, e[sub].contiguous(), ln[sub].contiguous()) + rest \
            + (off[:N + 1 if n_ref is None else n_ref + 1],)
        S = int(sargs[-1][-1])
        sgot = [x[:S] for x in got[:4]] + [x[sub] for x in got[4:]]
        e0, e1 = ev(), ev()
        e0.record()
        want = seed.smem_collect_ref(*sargs)
        e1.record()
        torch.cuda.synchronize()
        r["smem_plain_ms"] = e0.elapsed_time(e1)
        r["smem_plain_reads"] = want[4].numel()
        soff = sargs[-1]
        wcnt = want[4].long()
        err = max(int((sgot[4] - want[4]).abs().max()),
                  int((sgot[5] - want[5]).abs().max()))
        wvalid = (torch.arange(int(soff[-1]), device=e.device)
                  - torch.repeat_interleave(soff[:-1], soff.diff())) \
            < torch.repeat_interleave(wcnt.clamp(min=0), soff.diff())
        for g, w in zip(sgot[:4], want[:4]):
            d = (g.long() - w.long()).abs()
            err = max(err, int(torch.where(wvalid, d, 0).max()))
        r["smem_err"] = err
        reads = []
        e0.record()
        want_c = seed.sa_resolve_ref(dfm, pos, reads)
        e1.record()
        torch.cuda.synchronize()
        r["sa_plain_ms"] = e0.elapsed_time(e1)
        r["sa_err"] = max(int((o - want_c).abs().max()) if P else 0
                          for o in sa_outs.values())
        r["sa_row_reads"] = reads[0]
        # sa_resolve bytes: one 32 B row per LF step, 1 + 4 B of SA per
        # position, the position in and the coordinate out
        r["sa_bound_ms"] = ((reads[0] * 32 + P * (5 + 16))
                            / HBM_BYTES_PER_S * 1e3)
        if err or r["sa_err"]:
            fail(f"{tag}: seeding kernels disagree with their plain "
                 f"versions: smem_collect max abs err {err}, sa_resolve "
                 f"{r['sa_err']}")
        note = ""
        if n_reads is None and n_ref is None:
            # the whole stage as the main path runs it, warm (host clock;
            # run() ends in its fetch), and its arrays against the oracle
            r["seeder_s"] = []
            for _ in range(2):
                t0 = time.perf_counter()
                backend.seeder.run(e, ln, opt)
                r["seeder_s"].append(time.perf_counter() - t0)
            flat = backend.collect_chunk(encs, opt)
            for nm, x, y in zip(("smem_off", "m", "n", "s", "occ_off",
                                 "coords"), flat,
                             host_seeding(fm, encs, opt)):
                if not np.array_equal(x, y):
                    fail(f"{tag}: collect_chunk {nm} differs from the host "
                         f"oracle's")
            note = ("; collect_chunk == host oracle; FusedSeeder.run warm: "
                    + ", ".join(f"{x:.4f}s" for x in r["seeder_s"]))
        out[tag] = r
        lanes_txt = ", ".join(
            f"G={G} {v['ms']:.3f} ms ({v['registers']} registers, "
            f"{v['spill_bytes']} B spilled, {v['stack_bytes']} B stack, "
            f"{v['blocks']} blocks x {v['threads']} threads, "
            f"{v['shared_bytes']} B shared/block)"
            for G, v in per_lanes.items())
        log(f"  {tag}: {N} reads x L={L}, list {lcap}, {r['slots']} slots: "
            f"smem_collect {sm_ms:.3f} ms at G={chosen} (one-thread design "
            f"{r['one_thread_ms']} ms; bound {r['smem_bound_ms']:.4f} ms by "
            f"{r['smem_bound_by']}: bytes {mem_ms:.4f}, operations "
            f"{ops_ms:.4f}; {nbwd} backward_ext, overflow.fused_read "
            f"{overflowed} = {100.0 * overflowed / N:.3f} %), "
            f"sa_resolve {sa_ms:.4f} ms on {P} positions (bound "
            f"{r['sa_bound_ms']:.5f} ms); plain {r['smem_plain_ms']:.1f} ms "
            f"on {r['smem_plain_reads']} reads / {r['sa_plain_ms']:.1f} ms, "
            f"identical" + note)
        log(f"    lane widths, all identical: {lanes_txt}")
        log(f"    sa_resolve shapes (walks per lane x threads per block), "
            f"all identical to the plain version; the wrapper's choice "
            f"{sa_shape[0]}x{sa_shape[1]}, one-thread design "
            f"{r['sa_one_thread_ms']} ms: " + ", ".join(
                f"{W}x{T} {v['ms']:.4f} ms ({v['blocks']} blocks, "
                f"{v['registers']} registers, {v['stack_bytes']} B stack)"
                for (W, T), v in per_shape.items()))
    return out


def synthetic_rescue(torch, genome, tag: str, seed: int, parts) -> tuple:
    """A batch of benchdata.rescue_windows problems on the smoke genome.
    parts: [(n, qlen range, tlen range, u8 class)], seeded seed, seed+1...
    Returns (tag, read grid on the card, descriptors)."""
    from bwamem2_tpu_torch.benchdata import rescue_batch
    enc, desc = rescue_batch(genome, [
        dict(seed=seed + k, n=n, qr=qr, tr=tr, nmut=qr[1] // 40, n_every=5,
             plant=11, u8=u8) for k, (n, qr, tr, u8) in enumerate(parts)])
    return tag, torch.from_numpy(enc).cuda(), desc


def rescue_vs_plain(torch, fm, opt, batches) -> dict:
    """Phase 5c.  batches: [(tag, read grid on the card, descriptors)].
    For each: DeviceKswv.align_batch against the native ksw_align
    7-tuples (exact; the native oracle timed on the host), then per
    precision class, in DeviceKswv's launch order and with its arguments,
    the kswv wrapper against kswv_two_phase_ref on the card (exact), with
    the kernel's CUDA-event ms beside the one-thread design's, the plain
    version's ms, the bound of the cells these problems ran, and the
    launch's shape (register bucket or shared-memory stripes, groups per
    block, shared memory, the instantiation's ptxas registers and spills)."""
    import numpy as np
    from bwamem2_tpu_torch.native import ksw_align_desc
    from bwamem2_tpu_torch.ops.device_index import DeviceFMIndex
    from bwamem2_tpu_torch.ops.kswv import DeviceKswv, kswv_two_phase_ref
    from bwamem2_tpu_torch.ops.kswv_cuda import kswv
    dfm = DeviceFMIndex.from_genome(fm.ref_string, "cuda")
    dk = DeviceKswv(dfm, opt)
    ptx = instances(kswv.build_log, "kswv")
    ev = lambda: torch.cuda.Event(enable_timing=True)  # noqa: E731
    out = {}
    for tag, encj, desc in batches:
        n = len(desc["qoff"])
        enc = encj.cpu().numpy()
        t0 = time.perf_counter()
        want7 = ksw_align_desc(enc, fm.ref_string, desc, opt)
        host_s = time.perf_counter() - t0
        got7 = dk.align_batch(encj, desc)
        if not np.array_equal(got7, want7):
            bad = int((got7 != want7).any(1).sum())
            fail(f"5c {tag}: DeviceKswv differs from the native ksw_align "
                 f"on {bad} of {n} problems")
        r = dict(problems=n, u8=int(desc["u8"].sum()), native_host_s=host_s,
                 saturated_i16=int(((want7[:, 0] == 32767)
                                    & ~desc["u8"]).sum()), classes={})
        for u8, idx in dk.launch_order(desc):
            args = dk.kswv_args(encj, desc, idx, u8)
            Qmax, Tmax = args[8], args[9]
            got = kswv.launch(*args)
            work: list = []
            e0, e1 = ev(), ev()
            e0.record()
            want = kswv_two_phase_ref(*args, work=work)
            e1.record()
            torch.cuda.synchronize()
            p_ms = e0.elapsed_time(e1)
            bad = int(((got[0] != want[0]).any(1)
                       | (got[1] != want[1]).any(1)).sum())
            err = max(int((g - w).abs().max()) for g, w in zip(got, want))
            if bad:
                fail(f"5c {tag}: kswv disagrees with kswv_two_phase_ref on "
                     f"{bad} of {len(idx)} problems (max abs err {err})")
            k_ms = cuda_ms(torch, lambda: kswv.launch(*args), 5)
            cells = sum(c for c, _ in work)
            rows = sum(x for _, x in work)
            ops_ms = ((cells * KSWV_OPS_PER_CELL[u8]
                       + rows * (16 if u8 else 8) * KSWV_LAZY_OPS)
                      / INT32_OPS_PER_S * 1e3)
            nbytes = (len(idx) * (KSWV_DESC_BYTES + KSWV_OUT_BYTES)
                      + int(desc["qlen"][idx].sum())
                      + int(desc["tlen"][idx].sum()))
            mem_ms = nbytes / HBM_BYTES_PER_S * 1e3
            cls = "u8" if u8 else "i16"
            smax, gpb, smem, _ = kswv.plan(len(idx), Qmax, u8, "cuda")
            if tag == "chunk (b)":      # for small_batch_probe.py --kswv-b
                KSWV_B.append((f"{tag} {'u8' if u8 else 'i16'}", [
                    x.cpu() if isinstance(x, torch.Tensor) else x
                    for x in args]))
            inst = ptx.get((u8, smax), {})
            old = ONE_THREAD_KSWV_MS.get((tag, cls))
            r["classes"][cls] = dict(
                P=len(idx), Qmax=Qmax, Tmax=Tmax, cells=cells, rows=rows,
                ms=k_ms, one_thread_ms=old, plain_ms=p_ms,
                bound_ms=max(ops_ms, mem_ms),
                bound_by="operations" if ops_ms >= mem_ms else "bytes",
                err=err, register_bucket=smax, groups_per_block=gpb,
                shared_bytes=smem, registers=inst.get("registers"),
                spill_bytes=inst.get("spill"), stack_bytes=inst.get("stack"))
            place = (f"registers SMAX={smax}" if smax
                     else f"shared memory {smem} B/block")
            log(f"  {tag} {cls}: P={len(idx)} Qmax={Qmax} Tmax={Tmax}, "
                f"{cells} cells in {rows} rows: kernel {k_ms:.4f} ms "
                f"(one-thread design {old} ms), plain {p_ms:.1f} ms, bound "
                f"{max(ops_ms, mem_ms):.5f} ms, identical; stripes in "
                f"{place}, {gpb} groups/block, {inst.get('registers')} "
                f"registers, {inst.get('spill')} B spilled, "
                f"{inst.get('stack')} B stack frame")
        out[tag] = r
        log(f"  {tag}: {n} problems ({r['u8']} u8, {r['saturated_i16']} "
            f"i16 scores at 32767): DeviceKswv == native "
            f"ksw_align; native ksw_align {host_s:.4f} s on the host; kswv "
            f"{sum(c['ms'] for c in r['classes'].values()) / 1e3:.4f} s "
            f"on the card")
    return out


def gather_phase(torch, fm) -> dict:
    """The gather probe's path (the port's probe entry on cuda, counts set
    to 0 just before and read just after), then the row_gather wrapper
    against tab[idx] and torch.index_select at the probe's sizes and on
    the smoke index's occ rows, with the probe's P rows and with P_GATHER
    rows; the kernel, tab[idx] and index_select are timed at P_GATHER, where
    the card's time outweighs the call's host work (the probe's own rows
    give the P-row times)."""
    from bwamem2_tpu_torch.ops.device_index import DeviceFMIndex
    from bwamem2_tpu_torch.ops.row_gather import row_gather, row_gather_ref
    from bwamem2_tpu_torch.tools import gather_scale_probe as gp
    row_gather.reset()
    rows = gp.probe(PROBE_SIZES_MB, "cuda", reps=3, out=sys.stdout)
    torch.cuda.synchronize()
    launches, plain = row_gather.launches, row_gather.plain_calls
    if launches == 0 or plain:
        fail(f"the probe path launched row_gather {launches} times "
             f"({plain} plain calls)")
    dfm = DeviceFMIndex.from_host(fm, "cuda")
    dev = dfm.device

    def occ_rows():
        import numpy as np
        blk = np.random.default_rng(3).integers(0, dfm.occp.shape[0],
                                                P_GATHER)
        return dfm.occp, torch.from_numpy(blk.astype(np.int32)).cuda()

    cases = [(f"{mb} MB", lambda mb=mb: gp.make_table(mb, dev, p=P_GATHER))
             for mb in PROBE_SIZES_MB] + [("smoke occp", occ_rows)]
    tot = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0, err=0)
    per = []
    log(f"  {'table':>12} {'P':>8} {'W':>3} {'kernel_ms':>10} "
        f"{'plain_ms':>9} {'index_select_ms':>15} {'bound_ms':>9}")
    for name, mk in cases:
        tab, idx = mk()
        for ix in (idx[:gp.P], idx):
            got = row_gather(tab, ix)
            want = row_gather_ref(tab, ix)
            lib = torch.index_select(tab, 0, ix)
            torch.cuda.synchronize()
            if not (torch.equal(got, want) and torch.equal(got, lib)):
                fail(f"row_gather disagrees with tab[idx] on {name}, "
                     f"P={ix.numel()}")
            del got, want, lib
        k_ms = cuda_ms(torch, lambda: row_gather(tab, idx), 5)
        p_ms = cuda_ms(torch, lambda: row_gather_ref(tab, idx), 5)
        l_ms = cuda_ms(torch, lambda: torch.index_select(tab, 0, idx), 5)
        # bytes: each distinct row read once, the indices read, the rows
        # written
        P, W = idx.numel(), tab.shape[1]
        rows_read = int(torch.unique(idx).numel())
        b_ms = ((rows_read + P) * W * 4 + 4 * P) / HBM_BYTES_PER_S * 1e3
        per.append(dict(table=name, P=P, W=W, rows_read=rows_read, ms=k_ms,
                        plain_ms=p_ms, library_ms=l_ms, bound_ms=b_ms))
        log(f"  {name:>12} {P:>8} {W:>3} {k_ms:>10.4f} {p_ms:>9.4f} "
            f"{l_ms:>15.4f} {b_ms:>9.5f}")
        if name != "smoke occp":
            for key, v in (("ms", k_ms), ("plain_ms", p_ms),
                           ("library_ms", l_ms), ("bound_ms", b_ms)):
                tot[key] += v
        del tab, idx
    return dict(launches=launches, probe=rows, cases=per, **tot)


def first_call_split(fq1: str, fq2: str, prefix: str) -> None:
    """Run in a fresh process (`chip_smoke.py --first-call ...`): the
    seeding stage's first call on run (a)'s first chunk, split into the
    kernels' library build/load, the CUDA context, the index upload, and
    the first FusedSeeder.run's pieces (smem_collect, compaction,
    sa_resolve with the fetch), each ended by a synchronize; then the same
    pieces warm.  Prints one JSON line of seconds."""
    import torch
    from bwamem2_tpu_torch.align.seeding import encode_reads
    from bwamem2_tpu_torch.index.fmindex import FMIndex
    from bwamem2_tpu_torch.ops import seed
    from bwamem2_tpu_torch.ops.backend import TorchBackend, _pad_reads
    from bwamem2_tpu_torch.options import MemOptions
    out = {}

    def timed(name, fn, sync=True):
        t0 = time.perf_counter()
        r = fn()
        if sync:
            torch.cuda.synchronize()
        out[name] = time.perf_counter() - t0
        return r

    fm = FMIndex.load(prefix)
    opt = MemOptions().finalize(None)
    encs = encode_reads([r.seq for r in chunk_reads(fq1, fq2, TASK_BASES)])
    enc, lens = _pad_reads(encs)
    timed("build_load", lambda: (seed.smem_collect.lib(),
                                 seed.sa_resolve.lib()), sync=False)
    timed("context", lambda: torch.zeros(1, device="cuda"))
    be = timed("index_upload", lambda: TorchBackend(fm, opt))
    e, ln = timed("grid_upload", lambda: (torch.from_numpy(enc).cuda(),
                                          torch.from_numpy(lens).cuda()))
    split_len = int(opt.min_seed_len * opt.split_factor + 0.499)
    for tag in ("first", "warm"):
        off = seed.slot_offsets(ln)
        got = timed(f"{tag}_smem_collect", lambda: seed.smem_collect(
            be.dfm, e, ln, opt.min_seed_len, split_len,
            int(opt.split_width), int(opt.max_mem_intv),
            seed.list_cap(e.shape[1]), off))
        flat = timed(f"{tag}_compact", lambda: seed.compact_and_expand(
            *got[:5], off, int(opt.max_occ)))
        timed(f"{tag}_sa_resolve_fetch", lambda: torch.cat([
            flat[0].long(), seed.sa_resolve(be.dfm, flat[3])]).cpu())
    print(json.dumps(out), flush=True)


# ------------------------------------------------------------ main path
def read_sam_body(path: str) -> list[str]:
    with open(path) as f:
        return [ln for ln in f if not ln.startswith("@PG")]


def oracle_chunk(prefix: str, fq1: str, fq2: str, idx: int,
                 a: int | None = None):
    """(SAM text, seconds) of chunk `idx` from the host-native
    Aligner(backend=None), chunked exactly as the CLI run (-K TASK_BASES,
    PE), with the CLI's -A a (update_a's rescaling) when a is given."""
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
    opt = MemOptions()
    if a is not None:
        opt.set("a", a)
    opt.finalize(None)
    opt.flag |= MEM_F_PE
    t0 = time.perf_counter()
    Aligner(FMIndex.load(prefix), opt, backend=None, verbose=0).process(
        reads, base)
    return "".join(r.sam for r in reads), time.perf_counter() - t0


def head_fastq(src: str, dst: str, n: int) -> str:
    """The first n records of a FASTQ file, written to dst."""
    with open(src) as f, open(dst, "w") as g:
        for _ in range(4 * n):
            g.write(f.readline())
    return dst


def n_chunks(fq1: str, fq2: str, task_bases: int) -> int:
    from bwamem2_tpu_torch.io.fastq import FastxReader, read_chunk
    ks1, ks2 = FastxReader(fq1), FastxReader(fq2)
    n = 0
    while read_chunk(ks1, ks2, task_bases):
        n += 1
    return n


def drive_main(torch, card: str, tag: str, cli_args: list, fq1: str,
               fq2: str, n_reads: int, task_bases: int) -> dict:
    """One run of `mem` PE through the CLI entry on cuda, with every
    launch counter and PROF record set to 0 just before and read just
    after; fails unless smem_collect, sa_resolve and bsw_extend launched
    at least once per chunk and kswv at least once per chunk with rescue
    problems, no plain version ran, every read took the device seeding
    route, at most MAX_OVERFLOW of them overflowed and no rescue SW missed
    its chunk's kswv batch.  The first chunk's rescue problems and read grid
    are returned under "_capture" for phase 5c, and the arguments of its
    bsw_extend launches under "_bsw" for phase 5a."""
    from bwamem2_tpu_torch import cli
    from bwamem2_tpu_torch.ops.backend import TorchBackend
    from bwamem2_tpu_torch.ops.bsw_cuda import BswExtend
    from bwamem2_tpu_torch.utils.profiling import PROF
    K = kernels()
    rescues = []     # (read grid, descriptors, result is None) per batch
    bsw_calls = []   # bsw_extend launch arguments, every chunk
    orig = TorchBackend.rescue_batch
    orig_bsw = BswExtend.launch

    def spy(self, desc):
        res = orig(self, desc)
        rescues.append((self._bsw.encj, desc, res is None))
        return res

    def bsw_spy(self, *args):
        bsw_calls.append(args)
        return orig_bsw(self, *args)

    for d in (PROF.t, PROF.n, PROF.c, PROF.ctot):
        d.clear()
    for k in K.values():
        k.reset()
    TorchBackend.rescue_batch = spy
    BswExtend.launch = bsw_spy
    t0 = time.perf_counter()
    try:
        rc = cli.main(["mem", *cli_args])
        torch.cuda.synchronize()
    finally:
        TorchBackend.rescue_batch = orig
        BswExtend.launch = orig_bsw
    wall = time.perf_counter() - t0
    launches = {n: k.launches for n, k in K.items()}
    plain = {n: k.plain_calls for n, k in K.items()}
    if rc != 0:
        fail(f"{tag}: mem exited with {rc}")
    chunks = n_chunks(fq1, fq2, task_bases)
    for kn in ("smem_collect", "sa_resolve", "bsw_extend"):
        if launches[kn] < chunks:
            fail(f"{tag}: main path launched {kn} {launches[kn]} times "
                 f"over {chunks} chunks")
    if not rescues or any(r[2] for r in rescues):
        fail(f"{tag}: {len(rescues)} rescue batches, "
             f"{sum(r[2] for r in rescues)} without a read grid: rescue "
             f"did not run on the card")
    if launches["kswv"] < len(rescues):
        fail(f"{tag}: main path launched kswv {launches['kswv']} times over "
             f"{len(rescues)} chunks with rescue problems")
    miss = PROF.c.get("overflow.rescue_miss", 0)
    if miss:
        fail(f"{tag}: {miss} rescue SWs found no kswv batch result and ran "
             f"on the host")
    problems = [len(r[1]["qoff"]) for r in rescues]
    n_u8 = [int(r[1]["u8"].sum()) for r in rescues]
    if any(plain.values()):
        # a CPU tensor is the only way to a plain version: none means every
        # read grid and index table was a CUDA tensor
        fail(f"{tag}: main path ran plain versions on cuda: {plain}")
    seeded = PROF.ctot.get("overflow.fused_read", 0)
    overflow = PROF.c.get("overflow.fused_read", 0)
    if seeded != n_reads:
        fail(f"{tag}: {n_reads - seeded} reads skipped the device seeding "
             f"route")
    if overflow > MAX_OVERFLOW * n_reads:
        fail(f"{tag}: {overflow} of {n_reads} reads outran the device slot "
             f"cap (limit {MAX_OVERFLOW:.0%}): seeding went back to the "
             f"host")
    phases = {k: round(v, 3) for k, v in sorted(PROF.t.items())}
    log(f"  {tag}: {n_reads} reads in {wall:.2f}s = "
        f"{n_reads / wall:.1f} reads/s, {chunks} chunks, launches "
        f"{launches} [{card}]")
    long_reads = PROF.c.get("overflow.long_read", 0)
    wide = PROF.c.get("rescue.i16_wide", 0)
    if long_reads:
        fail(f"{tag}: {long_reads} reads too long for the read grid")
    log(f"    overflow.fused_read {overflow} of {seeded} reads "
        f"({100.0 * overflow / n_reads:.3f} %), overflow.long_read "
        f"{long_reads} of {PROF.ctot.get('overflow.long_read', 0)} reads, "
        f"rescue.i16_wide {wide} of "
        f"{PROF.ctot.get('rescue.i16_wide', 0)} rescue problems (in the "
        f"kernel)")
    log(f"    seeding.device {phases.get('seeding.device', 0.0):.3f}s "
        f"(FusedSeeder.run, {chunks} chunks) [{card}]")
    log(f"    rescue: problems per chunk {problems} (u8 {n_u8}, i16 "
        f"{[p - u for p, u in zip(problems, n_u8)]}), "
        f"overflow.rescue_miss 0; matesw {phases.get('matesw', 0.0):.3f}s, "
        f"pairing {phases.get('pairing', 0.0):.3f}s [{card}]")
    log(f"    host phases (s): {json.dumps(phases)}")
    return dict(reads=n_reads, chunks=chunks, wall_s=round(wall, 3),
                reads_per_s=round(n_reads / wall, 1), launches=launches,
                overflow_fused_read=overflow, overflow_long_read=long_reads,
                rescue_i16_wide=wide, rescue_problems=problems,
                rescue_u8=n_u8, phases_s=phases,
                _capture=rescues[0][:2],
                _bsw=[a for a in bsw_calls if a[1] is rescues[0][0]])


def oracle_long(prefix: str, fq: str, lo: int, hi: int, preset: str,
                w: int | None = None):
    """(SAM text, seconds) of reads [lo, hi) of a long-read FASTQ from the
    host-native Aligner(backend=None) under -x preset (and -w w when
    given), processed as one chunk at their place in the file (an SE
    record depends only on its read and the read's index)."""
    from bwamem2_tpu_torch.align.pipeline import Aligner
    from bwamem2_tpu_torch.index.fmindex import FMIndex
    from bwamem2_tpu_torch.io.fastq import FastxReader, read_chunk
    from bwamem2_tpu_torch.options import MemOptions
    reads = read_chunk(FastxReader(fq), None, 10**12)[lo:hi]
    for r in reads:
        r.comment = None
    opt = MemOptions()
    if w is not None:
        opt.set("w", w)
    opt.finalize(preset)
    t0 = time.perf_counter()
    Aligner(FMIndex.load(prefix), opt, backend=None, verbose=0).process(
        reads, lo)
    return "".join(r.sam for r in reads), time.perf_counter() - t0


def drive_long(torch, card: str, tag: str, cli_args: list, fq: str,
               n_reads: int) -> dict:
    """One run of `mem -x pacbio` (SE, long reads) through the CLI entry on
    cuda, with every launch counter and PROF record set to 0 just before
    and read just after; fails unless smem_collect, sa_resolve, bsw_extend
    and bsw_shear launched, no plain version ran, no read was too long for
    the read grid and no extension pair ran on the host kernel
    (overflow.bsw_host_tail).  The arguments of its bsw_shear launches
    are returned under "_shear" for phase 5e."""
    from bwamem2_tpu_torch import cli
    from bwamem2_tpu_torch.ops.bsw_shear_cuda import BswShear
    from bwamem2_tpu_torch.utils.profiling import PROF
    K = kernels()
    shear_calls = []
    orig = BswShear.launch

    def spy(self, *args, **kw):
        shear_calls.append((args, kw))
        return orig(self, *args, **kw)

    for d in (PROF.t, PROF.n, PROF.c, PROF.ctot):
        d.clear()
    for k in K.values():
        k.reset()
    BswShear.launch = spy
    t0 = time.perf_counter()
    try:
        rc = cli.main(["mem", *cli_args])
        torch.cuda.synchronize()
    finally:
        BswShear.launch = orig
    wall = time.perf_counter() - t0
    launches = {n: k.launches for n, k in K.items()}
    plain = {n: k.plain_calls for n, k in K.items()}
    if rc != 0:
        fail(f"{tag}: mem exited with {rc}")
    for kn in ("smem_collect", "sa_resolve", "bsw_extend", "bsw_shear"):
        if not launches[kn]:
            fail(f"{tag}: {kn} was not launched: {launches}")
    if any(plain.values()):
        fail(f"{tag}: plain versions ran on cuda: {plain}")
    tail, pairs = (PROF.c.get("overflow.bsw_host_tail", 0),
                   PROF.ctot.get("overflow.bsw_host_tail", 0))
    if tail or not pairs:
        fail(f"{tag}: {tail} of {pairs} object-path extension pairs ran on "
             f"the host kernel")
    long_reads = PROF.c.get("overflow.long_read", 0)
    if long_reads:
        fail(f"{tag}: {long_reads} reads too long for the read grid")
    fused = PROF.c.get("overflow.fused_read", 0)
    phases = {k: round(v, 3) for k, v in sorted(PROF.t.items())}
    log(f"  {tag}: {n_reads} reads in {wall:.2f}s = "
        f"{n_reads / wall:.2f} reads/s, launches {launches} [{card}]")
    log(f"    object-path extension pairs {pairs}, overflow.bsw_host_tail "
        f"0; overflow.fused_read {fused} of {n_reads} reads (seeded on the "
        f"host oracle); extension.bsw {phases.get('extension.bsw', 0.0):.3f}"
        f"s, seeding.device {phases.get('seeding.device', 0.0):.3f}s "
        f"[{card}]")
    log(f"    PROF phases (s): {json.dumps(phases)}")
    return dict(reads=n_reads, wall_s=round(wall, 3),
                reads_per_s=round(n_reads / wall, 3), launches=launches,
                extension_pairs=pairs, overflow_fused_read=fused,
                phases_s=phases, _shear=shear_calls)


# ------------------------------------------------- data-parallel layer
def sam_records(text_or_path: str, is_path: bool = True) -> list[str]:
    """The SAM records (no header line) of a file or a text."""
    if is_path:
        with open(text_or_path) as f:
            text_or_path = f.read()
    return [ln for ln in text_or_path.splitlines(keepends=True)
            if not ln.startswith("@")]


def round_robin(torch, card: str, prefix: str, fq1: str, fq2: str,
                sam_a: str) -> dict:
    """Run (a)'s data (-K TASK_BASES) through run_pipeline with one aligner
    per visible card, or two TorchBackends on cuda:0 where one card is
    visible, one worker per aligner, every launch counter set to 0 just
    before and read just after.  Fails unless the SAM equals run (a)'s
    and every backend launched smem_collect, bsw_extend and kswv on its own
    chunks (TorchBackend.launches), with no plain version run."""
    import io
    from bwamem2_tpu_torch.align.pipeline import Aligner
    from bwamem2_tpu_torch.index.fmindex import FMIndex
    from bwamem2_tpu_torch.io.fastq import FastxReader
    from bwamem2_tpu_torch.ops import resolve_devices
    from bwamem2_tpu_torch.ops.backend import TorchBackend
    from bwamem2_tpu_torch.options import MEM_F_PE, MemOptions
    from bwamem2_tpu_torch.runtime import run_pipeline
    devs = resolve_devices("cuda")
    how = f"one backend per card, {len(devs)} cards"
    if len(devs) == 1:
        devs = devs * 2
        how = "two backends on cuda:0 (one visible card)"
    fm = FMIndex.load(prefix)
    opt = MemOptions().finalize(None)
    opt.flag |= MEM_F_PE
    aligners = [Aligner(fm, opt, backend=TorchBackend(fm, opt, d), verbose=1)
                for d in devs]
    K = kernels()
    for k in K.values():
        k.reset()
    out = io.StringIO()
    t0 = time.perf_counter()
    n = run_pipeline(aligners, FastxReader(fq1), FastxReader(fq2),
                     TASK_BASES, out, verbose=0, n_workers=len(aligners))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {nm: k.launches for nm, k in K.items()}
    plain = {nm: k.plain_calls for nm, k in K.items()}
    per = [dict(a.backend.launches) for a in aligners]
    if any(plain.values()):
        fail(f"round-robin: plain versions ran on cuda: {plain}")
    for i, t in enumerate(per):
        for kn in ("smem_collect", "bsw_extend", "kswv"):
            if not t.get(kn):
                fail(f"round-robin: backend {i} ({devs[i]}) launched no "
                     f"{kn}: {t}")
    got, want = sam_records(out.getvalue(), False), sam_records(sam_a)
    if got != want:
        bad = sum(x != y for x, y in zip(got, want))
        fail(f"round-robin: SAM differs from run (a)'s: {bad} of "
             f"{len(want)} records ({len(got)} produced)")
    log(f"  [4e] round-robin, {how}: {n} reads in {wall:.2f}s, SAM == run "
        f"(a)'s ({len(want)} records); launches per backend {per} "
        f"[{card}]")
    return dict(how=how, devices=[str(d) for d in devs], reads=n,
                wall_s=round(wall, 3), launches=launches, per_backend=per)


def shard_phase(card: str, prefix: str, fq1: str, fq2: str) -> dict:
    """`mem --shard 0:2` and `--shard 1:2` (--out-dir) as two processes at
    once on the card over run (a)'s data at -K SHARD_TASK_BASES (at least 4
    chunks), then `merge`; fails unless the merged SAM equals this
    process's unsharded run at the same -K."""
    import glob
    import shutil
    from bwamem2_tpu_torch import cli
    out_dir = os.path.join(WORK, "shards")
    shutil.rmtree(out_dir, ignore_errors=True)
    chunks = n_chunks(fq1, fq2, SHARD_TASK_BASES)
    if chunks < 4:
        fail(f"shards: -K {SHARD_TASK_BASES} gives {chunks} chunks (< 4)")
    base = ["mem", "-K", str(SHARD_TASK_BASES), "-v", "1"]
    ref = os.path.join(WORK, "unsharded.sam")
    t0 = time.perf_counter()
    if cli.main([*base, "-o", ref, prefix, fq1, fq2]):
        fail("shards: the unsharded run failed")
    t_ref = time.perf_counter() - t0
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "bwamem2_tpu_torch.cli", *base, "--shard",
         f"{h}:2", "--out-dir", out_dir, "-o",
         os.path.join(WORK, f"shard{h}_header.sam"), prefix, fq1, fq2],
        cwd=REPO, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
        text=True) for h in range(2)]
    try:
        errs = [p.communicate(timeout=600)[1] for p in procs]
    finally:
        for p in procs:
            p.kill()
    t_shards = time.perf_counter() - t0
    for h, (p, err) in enumerate(zip(procs, errs)):
        if p.returncode:
            fail(f"shards: --shard {h}:2 exited with {p.returncode}:\n"
                 f"{err[-3000:]}")
    parts = sorted(glob.glob(os.path.join(out_dir, "part.chunk*.sam")))
    if len(parts) != chunks:
        fail(f"shards: {len(parts)} chunk files for {chunks} chunks")
    merged = os.path.join(WORK, "merged.sam")
    if cli.main(["merge", merged, *reversed(parts)]):
        fail("shards: merge failed")
    got, want = sam_records(merged), sam_records(ref)
    if got != want:
        bad = sum(x != y for x, y in zip(got, want))
        fail(f"shards: merged SAM differs from the unsharded run: {bad} of "
             f"{len(want)} records ({len(got)} merged)")
    log(f"  [4f] --shard 0:2 / 1:2 (two processes on the card at once) + "
        f"merge over {chunks} chunks (-K {SHARD_TASK_BASES}): merged SAM == "
        f"unsharded SAM ({len(want)} records); unsharded {t_ref:.1f}s, both "
        f"shards {t_shards:.1f}s [{card}]")
    return dict(chunks=chunks, records=len(want), unsharded_s=round(t_ref, 2),
                shards_s=round(t_shards, 2))


class FirstChunk:
    """A context that records the calls of the wrapper methods `methods`
    ((kernel name, method) of kernels()) made from the first
    TorchBackend.collect_smems call through the end of the sa_lookup after
    it (the first chunk's seeding): calls["kernel.method"] = [args]."""

    def __init__(self, methods: list):
        self.methods = methods
        self.calls: dict = {f"{n}.{m}": [] for n, m in methods}
        self.on = self.seen = False

    def __enter__(self):
        from bwamem2_tpu_torch.ops.backend import TorchBackend
        K = kernels()
        self.orig = {f"{n}.{m}": (type(K[n]), m, getattr(type(K[n]), m))
                     for n, m in self.methods}
        self.orig["collect"] = (TorchBackend, "collect_smems",
                                TorchBackend.collect_smems)
        self.orig["sa"] = (TorchBackend, "sa_lookup", TorchBackend.sa_lookup)
        me = self

        def spy_for(key, fn):
            def spy(self, *args):
                if me.on:
                    me.calls[key].append(args)
                return fn(self, *args)
            return spy

        def collect(self, encs, opt):
            me.on, me.seen = not me.seen, True
            return me.orig["collect"][2](self, encs, opt)

        def sa(self, positions):
            try:
                return me.orig["sa"][2](self, positions)
            finally:
                me.on = False

        for key, (cls, m, fn) in self.orig.items():
            setattr(cls, m, spy_for(key, fn) if key in self.calls else
                    collect if key == "collect" else sa)
        return self

    def __exit__(self, *exc):
        for cls, m, fn in self.orig.values():
            setattr(cls, m, fn)


def sharded_mem(torch, card: str, prefix: str, fq1: str, fq2: str,
                sam_a: str) -> dict:
    """[4g] run (a)'s reads through `mem` (the CLI entry) over a sharded
    index: BWAMEM2_TPU_SHARD_INDEX set and the visible cards, or cuda:0
    twice where one card is visible (two shards on one card: the same code
    as across cards, minus NVLink), every launch counter and PROF record
    set to 0 just before and read just after.  Fails unless the SAM equals
    run (a)'s, the four per-stage kernels, sa_resolve, bsw_extend and kswv
    launched and no plain version ran, and the host routes
    (overflow.r1_pivot_cap, overflow.long_read, each of the reads) stay
    within MAX_OVERFLOW; the pivots that took the wide candidate tier on
    the card (seeding.cand_wide*) are printed.  The launches of the first
    chunk's seeding are returned under "_launches" ({"kernel.method":
    [(wrapper args)]}) for phase 5g."""
    from bwamem2_tpu_torch import cli, ops
    from bwamem2_tpu_torch.utils.profiling import PROF
    devs = ops.resolve_devices("cuda")
    how = f"one shard per card, {len(devs)} cards"
    if len(devs) == 1:
        devs = devs * 2
        how = "two shards on cuda:0 (one visible card)"
    K = kernels()
    # the launches of the first chunk's seeding, by wrapper method
    first = FirstChunk([(n, "launch") for n in STAGES + ("sa_resolve",)]
                       + [("round2_backward", "resume")])
    sam = os.path.join(WORK, "main_sharded.sam")
    for d in (PROF.t, PROF.n, PROF.c, PROF.ctot):
        d.clear()
    for k in K.values():
        k.reset()
    resolve = ops.resolve_devices
    ops.resolve_devices = lambda dev=None: list(devs)
    os.environ["BWAMEM2_TPU_SHARD_INDEX"] = "1"
    t0 = time.perf_counter()
    try:
        with first:
            rc = cli.main(["mem", "-K", str(TASK_BASES), "-v", "1", "-o",
                           sam, prefix, fq1, fq2])
            torch.cuda.synchronize()
    finally:
        del os.environ["BWAMEM2_TPU_SHARD_INDEX"]
        ops.resolve_devices = resolve
    wall = time.perf_counter() - t0
    launches = {n: k.launches for n, k in K.items()}
    plain = {n: k.plain_calls for n, k in K.items()}
    if rc:
        fail(f"sharded mem exited with {rc}")
    if any(plain.values()):
        fail(f"sharded mem ran plain versions on cuda: {plain}")
    for n in STAGES + ("sa_resolve", "bsw_extend", "kswv"):
        if not launches[n]:
            fail(f"sharded mem: {n} was not launched: {launches}")
    if launches["smem_collect"]:
        fail("sharded mem: the fused smem_collect ran over a sharded index")
    routes = {c: [PROF.c.get(c, 0), PROF.ctot.get(c, 0)] for c in (
        "overflow.r1_pivot_cap", "overflow.long_read", "seeding.cand_wider1",
        "seeding.cand_wide")}
    for c in ("overflow.r1_pivot_cap", "overflow.long_read"):   # the host's
        n, tot = routes[c]
        if not tot or n > MAX_OVERFLOW * tot:
            fail(f"sharded mem: {c} {n} of {tot} (limit {MAX_OVERFLOW:.0%})")
    got, want = sam_records(sam), sam_records(sam_a)
    if got != want:
        bad = sum(x != y for x, y in zip(got, want))
        fail(f"sharded mem: SAM differs from run (a)'s: {bad} of "
             f"{len(want)} records ({len(got)} produced)")
    phases = {k: round(v, 3) for k, v in sorted(PROF.t.items())}
    n_reads = PROF.ctot.get("overflow.r1_pivot_cap", 0)
    log(f"  [4g] sharded index, {how}: {n_reads} reads in {wall:.2f}s = "
        f"{n_reads / wall:.1f} reads/s, SAM == run (a)'s ({len(want)} "
        f"records); routes [n, of] {routes}; launches {launches} "
        f"[{card}]")
    log(f"    host phases (s): {json.dumps(phases)}")
    return dict(how=how, devices=[str(d) for d in devs], reads=n_reads,
                wall_s=round(wall, 3), reads_per_s=round(n_reads / wall, 1),
                launches=launches, host_routes=routes, phases_s=phases,
                _launches=first.calls)


def stage_bounds(name: str, args, stats: dict) -> tuple:
    """(bytes ms, operations ms) of one per-stage launch: the distinct occ
    rows its plain version read (32 B each), the lanes' inputs and outputs,
    and per step the operations of csrc/<name>.cu's header (a backward_ext,
    or an LF step for round2_backward) over the card's rates."""
    if name == "round2_backward.resume":
        M = args[2].numel()
        ops, popc = R1_OPS_PER_STEP, R1_POPC_PER_STEP
        lane_b = M * (36 + 22) + stats["steps"]
    elif name == "round2_backward":
        M = args[6].numel()
        ops, popc = R1_OPS_PER_STEP, R1_POPC_PER_STEP
        lane_b = M * (8 + 24 + 22) + stats["steps"]
    elif name == "round2_forward":
        P, C = args[2].numel(), args[5]
        ops, popc = SMEM_OPS_PER_EXT, SMEM_POPC_PER_EXT
        lane_b = P * (16 + 4 + 28 * C) + stats["steps"]
    else:
        N, L = args[1].shape
        cap = args[3] if name == "round1_chain" else args[5]
        ops, popc = SMEM_OPS_PER_EXT, SMEM_POPC_PER_EXT
        lane_b = N * (L + 8) + N * cap * (4 if name == "round1_chain"
                                          else 24)
    nbytes = stats["rows"] * 32 + lane_b
    return (nbytes / HBM_BYTES_PER_S * 1e3,
            int_ops_s(stats["steps"] * ops, stats["steps"] * popc) * 1e3)


def view_name(dfm) -> str:
    return "replicated" if dfm.shards is None else "sharded"


def stage_calls_vs_plain(torch, card: str, name: str, captured: dict,
                         other, where: str) -> dict:
    """Each captured launch of the per-stage kernel `name` (captured:
    {"kernel.method": [(wrapper args)]}; the resume entry's launches count
    toward round2_backward) against its plain version on the card, exact,
    timed with CUDA events (mean of 3 after a warm-up) beside its bound
    and the steps of its longest walk (round 2) or the dependent loads of
    its longest chain (round1_chain, round3_replay: one load a step), and
    again over the index view `other` (the other view of the same index:
    replicated for a sharded launch and back), exact and timed.  Prints a
    line per launch and the sum; returns the sums, with the launches under
    "per_launch"."""
    from bwamem2_tpu_torch.ops import smem
    K = kernels()
    k = K[name]
    pairs = {"round1_chain.launch": smem.round1_chain_ref,
             "round2_forward.launch": smem.round2_forward_ref,
             "round2_backward.launch": smem.round2_backward_ref,
             "round2_backward.resume": smem.round2_backward_resume_ref,
             "round3_replay.launch": smem.round3_replay_ref}
    chain = name in ("round1_chain", "round3_replay")
    calls = [(key, args) for key in pairs if key.startswith(name + ".")
             for args in captured.get(key, ())]
    if not calls:
        fail(f"{name}: no launch of {where} was captured")
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    r = dict(launches=len(calls), ms=0.0, plain_ms=0.0, mem_ms=0.0,
             ops_ms=0.0, steps=0, rows=0, err=0, other_ms=0.0,
             per_launch=[])
    if chain:
        r["chain_loads"] = 0
    for key, args in calls:
        entry = getattr(k, key.split(".")[1])
        ms = cuda_ms(torch, lambda: entry(*args), 3)
        stats: dict = {}
        ev[0].record()
        want = pairs[key](*args, stats=stats)
        ev[1].record()
        torch.cuda.synchronize()
        p_ms = ev[0].elapsed_time(ev[1])
        for view in (args[0], other):
            got = entry(view, *args[1:])
            r["err"] = max([r["err"]] + [int((g.long() - w.long()).abs()
                                             .max()) if g.numel() else 0
                                         for g, w in zip(got, want)])
            if r["err"]:
                fail(f"{name} ({key}, {view_name(view)} view) differs from "
                     f"its plain version on {where} (max abs err "
                     f"{r['err']})")
        mem_ms, ops_ms = stage_bounds(key.replace(".launch", ""), args,
                                      stats)
        lanes = args[6] if key == "round2_backward.launch" else args[2]
        one = dict(entry=key.split(".")[1], lanes=int(lanes.numel()),
                   ms=ms, plain_ms=p_ms, bound_ms=max(mem_ms, ops_ms),
                   steps=stats["steps"], rows=stats["rows"],
                   longest=stats.get("longest"))
        one["other_ms"] = cuda_ms(torch, lambda: entry(other, *args[1:]), 3)
        r["other_ms"] += one["other_ms"]
        for f_ in ("ms", "plain_ms", "steps", "rows"):
            r[f_] += one[f_]
        r["mem_ms"] += mem_ms
        r["ops_ms"] += ops_ms
        r["per_launch"].append(one)
        extra = f"; other view {one['other_ms']:.4f} ms"
        walk = (f", longest walk {one['longest']} steps" if one["longest"]
                else "")
        if chain:
            r["chain_loads"] = max(r["chain_loads"], one["longest"])
            walk = f", longest chain {one['longest']} dependent loads"
        log(f"    {name}.{one['entry']} ({one['lanes']} lanes, "
            f"{view_name(args[0])}): {ms:.4f} ms{walk}, {one['steps']} "
            f"steps, bound {one['bound_ms']:.5f} ms, plain {p_ms:.1f} ms"
            f"{extra}")
    r["bound_ms"] = max(r["mem_ms"], r["ops_ms"])
    r["bound_by"] = "operations" if r["ops_ms"] >= r["mem_ms"] else "bytes"
    log(f"  {name}: {r['launches']} launches of {where} ({r['steps']} "
        f"steps, {r['rows']} distinct occ rows): kernel {r['ms']:.4f} ms"
        f" (other view {r['other_ms']:.4f} ms)"
        + (f", longest chain {r['chain_loads']} loads" if chain else "")
        + f", plain {r['plain_ms']:.1f} ms, bound {r['bound_ms']:.5f} ms by "
        f"{r['bound_by']} (bytes {r['mem_ms']:.5f}, operations "
        f"{r['ops_ms']:.5f}), identical [{card}]")
    return r


def stage_vs_plain(torch, card: str, captured: dict, prefix: str, fq1: str,
                   fq2: str, step_out) -> dict:
    """[5g] each per-stage kernel against its plain version (on the card)
    on the launches of the sharded run's first chunk, exact, timed with
    CUDA events beside its bound (stage_calls_vs_plain: each also over the
    replicated index, round 1's and round 3's with their longest chains'
    dependent loads); sa_resolve over the shards against the replicated
    index on that chunk's positions, round1_walk over the
    shards against the replicated one on run (a)'s first chunk, the
    seed-extend step over a 2-shard index against the replicated step
    (phase 5f's outputs), and, with several cards, a peer read."""
    import numpy as np
    from bwamem2_tpu_torch.align.seeding import encode_reads
    from bwamem2_tpu_torch.index.fmindex import FMIndex
    from bwamem2_tpu_torch.ops import seed, smem
    from bwamem2_tpu_torch.ops.backend import _pad_reads
    from bwamem2_tpu_torch.ops.device_index import DeviceFMIndex
    from bwamem2_tpu_torch.parallel.shard_index import (
        shard_index, sharded_seed_extend_sharded_index)
    fm = FMIndex.load(prefix)
    rep = DeviceFMIndex.from_host(fm, "cuda")
    dev = rep.device
    out = {name: stage_calls_vs_plain(torch, card, name, captured, rep,
                                      "the sharded run's first chunk")
           for name in STAGES}
    # sa_resolve and round1_walk through the shards vs the replicated index
    sa = dict(ms=0.0, rep_ms=0.0, positions=0, err=0)
    for view, pos in captured["sa_resolve.launch"]:
        sa["ms"] += cuda_ms(torch, lambda: seed.sa_resolve(view, pos), 5)
        sa["rep_ms"] += cuda_ms(torch, lambda: seed.sa_resolve(rep, pos), 5)
        sa["positions"] += pos.numel()
        sa["err"] = max(sa["err"], int((seed.sa_resolve(view, pos)
                                        - seed.sa_resolve(rep, pos)).abs()
                                       .max()))
    enc, lens = _pad_reads(encode_reads([r.seq for r in chunk_reads(
        fq1, fq2, TASK_BASES)]))
    views = shard_index(rep, [dev, dev])
    e, ln = torch.from_numpy(enc).to(dev), torch.from_numpy(lens).to(dev)
    w_ms = cuda_ms(torch, lambda: smem.round1_walk(views[0], e, ln), 3)
    w_rep = cuda_ms(torch, lambda: smem.round1_walk(rep, e, ln), 3)
    want = smem.round1_walk_ref(rep, e, ln)
    hi_view = shard_index(zero_hi(rep), [dev, dev])[0]
    w_err = max(int((g.long() - w.long()).abs().max())
                for v in (views[0], hi_view)
                for g, w in zip(smem.round1_walk(v, e, ln), want))
    if sa["err"] or w_err:
        fail(f"5g: over 2 shards sa_resolve err {sa['err']} against the "
             f"replicated index, round1_walk err {w_err} against "
             "round1_walk_ref")
    log(f"  sa_resolve over 2 shards on {sa['positions']} positions: "
        f"{sa['ms']:.4f} ms (replicated {sa['rep_ms']:.4f} ms), == the "
        f"replicated index; round1_walk over 2 shards on chunk (a): "
        f"{w_ms:.4f} ms (replicated {w_rep:.4f} ms), == round1_walk_ref "
        f"(also through the has_hi body) [{card}]")
    t0 = time.perf_counter()
    got = sharded_seed_extend_sharded_index([dev, dev], rep, enc, lens)
    st_s = time.perf_counter() - t0
    names = ("smem_b", "smem_k", "smem_s", "coords", "ext")
    for nm, g, w in zip(names, got, step_out):
        if not np.array_equal(g, w.numpy()):
            fail(f"5g: the step over a 2-shard index differs from the "
                 f"replicated step in {nm}")
    log(f"  the seed-extend step over a 2-shard index on chunk (a) == the "
        f"replicated step ({st_s:.2f}s) [{card}]")
    peer = "one card: no peer load"
    if torch.cuda.device_count() > 1:
        cards = [torch.device("cuda", i)
                 for i in range(torch.cuda.device_count())]
        pv = shard_index(rep, cards)[0]
        pos = captured["sa_resolve.launch"][0][1]
        if not torch.equal(seed.sa_resolve(pv, pos),
                           seed.sa_resolve(rep, pos)):
            fail(f"5g: sa_resolve over one shard per card ({len(cards)}) "
                 "differs from the replicated index")
        peer = (f"sa_resolve on cuda:0 over one shard per card "
                f"({len(cards)} cards) == replicated")
    log(f"  peer read: {peer}")
    out.update(sa_resolve_sharded=sa, round1_walk_sharded=dict(
        ms=w_ms, rep_ms=w_rep), step_sharded_s=round(st_s, 3), peer=peer)
    return out


def graft_batch(fm, n: int = 32, L: int = 128, seed: int = 0):
    """The compile-check batch of __graft_entry__.py:_example_batch: n
    reads of L bases cut from the genome, 3 substitutions each."""
    import numpy as np
    rng = np.random.default_rng(seed)
    enc = np.full((n, L), 4, np.int32)
    lens = np.full((n,), L, np.int32)
    for i in range(n):
        p = int(rng.integers(0, fm.l_pac - L))
        enc[i] = fm.ref_string[p:p + L]
        mut = rng.integers(0, L, 3)
        enc[i, mut] = (enc[i, mut] + 1) % 4
    return enc, lens


def step_phase(torch, card: str, prefix: str, fq1: str, fq2: str) -> dict:
    """ops/entry.py:seed_extend_step on the card on the compile-check batch
    (32 x 128, tests/fixtures/ref_tiny.fa) and on run (a)'s first chunk at
    full width, with every launch counter set to 0 just before and read
    just after (round1_walk, sa_resolve and bsw_extend must launch); all
    five outputs against the step's CPU path (plain versions), exact;
    sharded_seed_extend over make_mesh() against the one-card step; then
    on the chunk round1_walk, the step's bsw_tiles launch and its
    sa_resolve launch each timed against its plain version on the card and
    beside its bound."""
    import numpy as np
    from bwamem2_tpu_torch.align.seeding import encode_reads
    from bwamem2_tpu_torch.index.fmindex import FMIndex
    from bwamem2_tpu_torch.ops import seed
    from bwamem2_tpu_torch.ops.backend import _pad_reads
    from bwamem2_tpu_torch.ops.bsw_cuda import BswExtend
    from bwamem2_tpu_torch.ops.device_index import DeviceFMIndex
    from bwamem2_tpu_torch.ops.entry import seed_extend_step
    from bwamem2_tpu_torch.ops.seed_cuda import SaResolve
    from bwamem2_tpu_torch.ops.smem import round1_walk, round1_walk_ref
    from bwamem2_tpu_torch.parallel.mesh import make_mesh, sharded_seed_extend
    tiny = FMIndex.load(os.path.join(REPO, "tests", "fixtures", "ref_tiny.fa"))
    fm = FMIndex.load(prefix)
    chunk = _pad_reads(encode_reads([r.seq for r in
                                     chunk_reads(fq1, fq2, TASK_BASES)]))
    batches = [("compile-check batch", tiny, *graft_batch(tiny)),
               ("chunk (a)", fm, *chunk)]
    dfms = [DeviceFMIndex.from_host(f, "cuda") for _, f, _, _ in batches]
    K = kernels()
    calls = {"bsw": [], "sa": []}
    orig_bsw, orig_sa = BswExtend.launch, SaResolve.launch

    def bsw_spy(self, *args):
        calls["bsw"].append(args)
        return orig_bsw(self, *args)

    def sa_spy(self, *args):
        calls["sa"].append(args)
        return orig_sa(self, *args)

    for k in K.values():
        k.reset()
    BswExtend.launch, SaResolve.launch = bsw_spy, sa_spy
    got, secs = [], []
    try:
        for d, (_, _, enc, lens) in zip(dfms, batches):
            t0 = time.perf_counter()
            got.append([x.cpu() for x in seed_extend_step(d, enc, lens)])
            secs.append(time.perf_counter() - t0)
    finally:
        BswExtend.launch, SaResolve.launch = orig_bsw, orig_sa
    launches = {nm: k.launches for nm, k in K.items()}
    plain = {nm: k.plain_calls for nm, k in K.items()}
    for kn in ("round1_walk", "sa_resolve", "bsw_extend"):
        if launches[kn] < len(batches):
            fail(f"seed-extend step: {kn} launched {launches[kn]} times "
                 f"over {len(batches)} steps")
    if any(plain.values()):
        fail(f"seed-extend step: plain versions ran on cuda: {plain}")
    names = ("smem_b", "smem_k", "smem_s", "coords", "ext")
    res = dict(launches=launches, step_s=[round(x, 4) for x in secs])
    for (tag, f, enc, lens), g, sec in zip(batches, got, secs):
        t0 = time.perf_counter()
        want = seed_extend_step(DeviceFMIndex.from_host(f, "cpu"), enc, lens)
        cpu_s = time.perf_counter() - t0
        for nm, x, y in zip(names, g, want):
            if not torch.equal(x, y):
                fail(f"seed-extend step, {tag}: {nm} on the card differs "
                     f"from the CPU path in "
                     f"{int((x != y).reshape(x.shape[0], -1).any(1).sum())}"
                     f" reads")
        log(f"  {tag}: {enc.shape[0]} reads x L={enc.shape[1]}: all five "
            f"outputs == the CPU path (card {sec:.3f}s with first calls, "
            f"CPU {cpu_s:.1f}s; {int((g[4][:, 0] > 0).sum())} seeds "
            f"extended) [{card}]")
    d, (_, _, enc, lens) = dfms[1], batches[1]
    mesh = make_mesh()
    for nm, x, y in zip(names, sharded_seed_extend(mesh, d, enc, lens),
                        got[1]):
        if not np.array_equal(x, y.numpy()):
            fail(f"sharded_seed_extend over {mesh}: {nm} differs from the "
                 f"one-card step")
    log(f"  sharded_seed_extend over {[str(m) for m in mesh]} == the "
        f"one-card step on chunk (a)")
    # round1_walk on the chunk: kernel, plain version on the card, bound
    e = torch.from_numpy(enc).cuda()
    ln = torch.from_numpy(lens).cuda()
    N, L = e.shape
    k_ms = cuda_ms(torch, lambda: round1_walk(d, e, ln), 5)
    stats: dict = {}
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    want = round1_walk_ref(d, e, ln, stats)
    ev[1].record()
    torch.cuda.synchronize()
    p_ms = ev[0].elapsed_time(ev[1])
    err = max(int((x.long() - y.long()).abs().max())
              for x, y in zip(round1_walk(d, e, ln), want))
    dh = zero_hi(d)
    err_hi = max(int((x.long() - y.long()).abs().max())
                 for x, y in zip(round1_walk(dh, e, ln), want))
    if err or err_hi:
        fail(f"round1_walk differs from round1_walk_ref on chunk (a) (max "
             f"abs err {err}; through its has_hi body {err_hi})")
    hi_ms = cuda_ms(torch, lambda: round1_walk(dh, e, ln), 5)
    row_b = 32 + (4 if d.has_hi else 0)
    nbytes = stats["rows"] * row_b + N * L * (1 + 20) + 4 * N
    mem_ms = nbytes / HBM_BYTES_PER_S * 1e3
    rb = r1_bounds(stats)
    ops_ms = rb["ops_ms"]
    r1 = dict(reads=N, L=L, lanes=N * L, steps=stats["steps"],
              one_block=stats["one_block"], single=stats["single"],
              single_empty=stats["single_empty"],
              wide_one_block=stats["wide_one_block"],
              rows=stats["rows"], ms=k_ms, hi_body_ms=hi_ms, plain_ms=p_ms,
              mem_ms=mem_ms, **rb, bound_ms=max(mem_ms, ops_ms),
              bound63_ms=max(mem_ms, rb["ops63_ms"]),
              bound_by="operations" if ops_ms >= mem_ms else "bytes", err=err)
    log(f"  round1_walk on chunk (a) ({N * L} lanes, {stats['steps']} LF "
        f"steps: {rb['one_block_share']:.4f} with both ends in one block, "
        f"{rb['single_share']:.4f} at s = 1, "
        f"{rb['single_empty_share']:.4f} at s = 1 emptying the interval; "
        f"{stats['rows']} distinct occ "
        f"rows): kernel {k_ms:.4f} ms (has_hi body {hi_ms:.4f}), "
        f"plain {p_ms:.1f} ms, bound {r1['bound_ms']:.5f} ms by "
        f"{r1['bound_by']} (bytes {mem_ms:.5f}, operations {ops_ms:.5f}; "
        f"two counts a step: {r1['bound63_ms']:.5f}), identical [{card}]")
    # the step's bsw_tiles launch and sa_resolve launch on the chunk
    log(f"  bsw_tiles' bsw_extend launch of the step on chunk (a):")
    bt = bsw_main_path(torch, calls["bsw"][-1:])
    sdfm, pos = calls["sa"][-1]
    P = pos.numel()
    sa_ms = cuda_ms(torch, lambda: seed.sa_resolve(sdfm, pos), 5)
    reads: list = []
    ev[0].record()
    sa_want = seed.sa_resolve_ref(sdfm, pos, reads)
    ev[1].record()
    torch.cuda.synchronize()
    sa_err = int((seed.sa_resolve(sdfm, pos) - sa_want).abs().max())
    if sa_err:
        fail(f"sa_resolve differs from its plain version on the step's "
             f"positions (max abs err {sa_err})")
    sa = dict(positions=P, row_reads=reads[0], ms=sa_ms,
              plain_ms=ev[0].elapsed_time(ev[1]),
              bound_ms=(reads[0] * 32 + P * (5 + 16)) / HBM_BYTES_PER_S * 1e3)
    log(f"  sa_resolve on the step's {P} positions ({reads[0]} row reads): "
        f"kernel {sa_ms:.4f} ms, plain {sa['plain_ms']:.2f} ms, bound "
        f"{sa['bound_ms']:.5f} ms by bytes, identical [{card}]")
    res.update(round1_walk=r1, bsw_tiles=bt, sa_resolve=sa, _out=got[1])
    return res


def legacy_mem(torch, card: str, prefix: str, fq1: str, fq2: str,
               sam_a: str) -> dict:
    """[4h] run (a)'s data through run_pipeline with one
    TorchBackend(pivot_seeding=False) on the card and its K-mer table
    (depth LEGACY_K at this genome's size), every launch counter and PROF
    record set to 0 just before and read just after.  Fails unless the
    SAM equals run (a)'s, round1_compact and the per-stage round-2 and
    round-3 kernels, sa_resolve, bsw_extend and kswv launched,
    smem_collect and round1_chain did not, no plain version ran, and the
    reads on the host oracle (overflow.r1_compact_cap, overflow.long_read)
    stay within MAX_OVERFLOW.  Then the port's kernel_micro entry on this
    genome (one timed call a line), counters set to 0 just before and read
    just after: kswv_phase and bsw_shear (bsw_shear_tiles) must launch.
    The round1_compact, round2_forward, round2_backward and round3_replay
    launches of the first chunk are returned under "_launches"
    ({"kernel.method": [(wrapper args)]}) for phase 5h."""
    import io
    from contextlib import redirect_stdout
    from bwamem2_tpu_torch.align.pipeline import Aligner
    from bwamem2_tpu_torch.index.fmindex import FMIndex
    from bwamem2_tpu_torch.io.fastq import FastxReader
    from bwamem2_tpu_torch.ops.backend import TorchBackend
    from bwamem2_tpu_torch.options import MEM_F_PE, MemOptions
    from bwamem2_tpu_torch.runtime import run_pipeline
    from bwamem2_tpu_torch.tools import kernel_micro
    from bwamem2_tpu_torch.utils.profiling import PROF
    fm = FMIndex.load(prefix)
    opt = MemOptions().finalize(None)
    opt.flag |= MEM_F_PE
    t0 = time.perf_counter()
    be = TorchBackend(fm, opt, "cuda", pivot_seeding=False)
    setup_s = time.perf_counter() - t0
    if be.lut_k != LEGACY_K:
        fail(f"legacy mem: K-mer table of depth {be.lut_k}, expected "
             f"{LEGACY_K} at l_pac {fm.l_pac}")
    al = Aligner(fm, opt, backend=be, verbose=1)
    K = kernels()
    first = FirstChunk([(n, "launch") for n in ("round1_compact",
                                                "round2_forward",
                                                "round2_backward",
                                                "round3_replay")]
                       + [("round2_backward", "resume")])
    for d in (PROF.t, PROF.n, PROF.c, PROF.ctot):
        d.clear()
    for k in K.values():
        k.reset()
    out = io.StringIO()
    t0 = time.perf_counter()
    with first:
        n = run_pipeline([al], FastxReader(fq1), FastxReader(fq2),
                         TASK_BASES, out, verbose=0, n_workers=1)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {nm: k.launches for nm, k in K.items()}
    plain = {nm: k.plain_calls for nm, k in K.items()}
    if any(plain.values()):
        fail(f"legacy mem: plain versions ran on cuda: {plain}")
    for kn in ("round1_compact", "round2_forward", "round2_backward",
               "round3_replay", "sa_resolve", "bsw_extend", "kswv"):
        if not launches[kn]:
            fail(f"legacy mem: {kn} was not launched: {launches}")
    if launches["smem_collect"] or launches["round1_chain"]:
        fail(f"legacy mem: the pivot-chain seeding ran: {launches}")
    routes = {c: [PROF.c.get(c, 0), PROF.ctot.get(c, 0)] for c in (
        "overflow.r1_compact_cap", "overflow.long_read",
        "seeding.cand_wide")}
    for c in ("overflow.r1_compact_cap", "overflow.long_read"):
        m, tot = routes[c]
        if not tot or m > MAX_OVERFLOW * tot:
            fail(f"legacy mem: {c} {m} of {tot} (limit {MAX_OVERFLOW:.0%})")
    got, want = sam_records(out.getvalue(), False), sam_records(sam_a)
    if got != want:
        bad = sum(x != y for x, y in zip(got, want))
        fail(f"legacy mem: SAM differs from run (a)'s: {bad} of "
             f"{len(want)} records ({len(got)} produced)")
    seeding = {k: round(PROF.t.get(k, 0.0), 4) for k in (
        "seeding.round1", "seeding.round1b", "seeding.round2",
        "seeding.round3", "sa_lookup")}
    phases = {k: round(v, 3) for k, v in sorted(PROF.t.items())}
    log(f"  [4h] legacy round 1 (pivot_seeding=False, K-mer table K="
        f"{be.lut_k}; backend set-up {setup_s:.2f}s): {n} reads in "
        f"{wall:.2f}s = {n / wall:.1f} reads/s, SAM == run (a)'s "
        f"({len(want)} records); seeding (s) {json.dumps(seeding)}; routes "
        f"[n, of] {routes}; launches {launches} [{card}]")
    log(f"    host phases (s): {json.dumps(phases)}")
    # the kernel_micro entry on this genome: its path's launches
    for k in K.values():
        k.reset()
    buf = io.StringIO()
    t0 = time.perf_counter()
    with redirect_stdout(buf):
        rc = kernel_micro.main(["--scale", str(DATA_SCALE), "--reps", "1"])
    micro_s = time.perf_counter() - t0
    micro = {nm: k.launches for nm, k in K.items()}
    if rc or any(k.plain_calls for k in K.values()):
        fail(f"kernel_micro: exit {rc}, plain calls "
             f"{[nm for nm, k in K.items() if k.plain_calls]}")
    for kn in ("kswv_phase", "bsw_shear", "round1_compact"):
        if not micro[kn]:
            fail(f"kernel_micro: {kn} was not launched: {micro}")
    for ln in buf.getvalue().splitlines():
        log(f"    kernel_micro: {ln}")
    log(f"  [4h] kernel_micro (scale {DATA_SCALE}, one timed call a line) "
        f"in {micro_s:.1f}s; launches {micro} [{card}]")
    return dict(reads=n, wall_s=round(wall, 3),
                reads_per_s=round(n / wall, 1), lut_k=be.lut_k,
                setup_s=round(setup_s, 3), seeding_s=seeding,
                host_routes=routes, launches=launches, phases_s=phases,
                micro_launches=micro, micro_out=buf.getvalue(),
                _launches=first.calls)


def phase_batch(torch, dev, genome, seed: int, n: int, L: int, qr, tr):
    """A one-phase rescue batch on `dev`: benchdata.rescue_windows
    problems with every third target walked backward from its end, every
    fifth not live and the stop scores mixed (none, 20, 35)."""
    import numpy as np
    from bwamem2_tpu_torch.benchdata import rescue_windows
    from bwamem2_tpu_torch.ops.kswv import NO_LIMIT
    enc, qoff, qdir, qcomp, qlen, toff, tlen = rescue_windows(
        genome, seed=seed, n=n, L=L, qr=qr, tr=tr, nmut=qr[1] // 40,
        n_every=5, plant=11)
    rng = np.random.default_rng(seed)
    tdir = np.where(np.arange(n) % 3 == 1, -1, 1).astype(np.int32)
    toff = np.where(tdir < 0, toff + tlen - 1, toff).astype(np.int64)
    endsc = rng.choice(np.array([NO_LIMIT, 20, 35], np.int32), n)
    live = np.arange(n) % 5 != 2
    return [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in (
        enc, qoff, qdir, qcomp, qlen, toff, tdir, tlen, endsc, live)]


def legacy_vs_plain(torch, card: str, calls: dict, fm, opt,
                    r1walk: dict) -> dict:
    """[5h] round1_compact against round1_compact_ref on the card on the
    legacy run's first-chunk launch at K = LEGACY_K and again at K = 0,
    exact, timed with CUDA events beside the bound from the LF steps,
    distinct occ rows and table entries the plain version counts, with
    the ptxas numbers of each instantiation, and round1_walk's 5f time
    and registers beside them; the run's first-chunk round2_forward,
    round2_backward and round3_replay launches as phase 5g's
    (stage_calls_vs_plain, also over a 2-shard view of the index);
    kswv_phase against kswv_phase_ref on a u8 and an i16 batch with mixed
    target directions, live flags and stop scores; bsw_shear_tiles
    against bsw_shear_desc_ref on long-read tiles whose h0 puts some
    pairs past 16 bits (both bodies)."""
    import numpy as np
    from bwamem2_tpu_torch.ops.bsw import (_tile_descriptors,
                                           bsw_shear_desc_ref,
                                           bsw_shear_tiles)
    from bwamem2_tpu_torch.ops.bsw_shear_cuda import bsw_shear
    from bwamem2_tpu_torch.ops.kswv import kswv_phase_ref
    from bwamem2_tpu_torch.ops.kswv_cuda import kswv_phase
    from bwamem2_tpu_torch.ops.smem import round1_compact, round1_compact_ref
    from bwamem2_tpu_torch.tools.kernel_micro import shear_tiles
    ev = lambda: torch.cuda.Event(enable_timing=True)  # noqa: E731
    out: dict = {}

    def plain_ms(fn):
        e0, e1 = ev(), ev()
        e0.record()
        r = fn()
        e1.record()
        torch.cuda.synchronize()
        return r, e0.elapsed_time(e1)

    # ---- round1_compact at K = LEGACY_K (the run's launch) and K = 0
    dfm, enc, lens, K, msl, cap = calls["round1_compact.launch"][0]
    dev = enc.device
    N, L = enc.shape
    ptx = {int(k[0]): v for k, v in
           instances(kernels()["round1_compact"].build_log,
                     "round1_compact").items()}
    dfm_hi = zero_hi(dfm)
    for k_ in (K, 0):
        args = (dfm, enc, lens, k_, msl, cap)
        got = round1_compact.launch(*args)
        got_hi = round1_compact.launch(dfm_hi, *args[1:])
        stats: dict = {}
        want, p_ms = plain_ms(lambda: round1_compact_ref(*args, stats=stats))
        err = max(int((g.long() - w.long()).abs().max()) for g, w in
                  zip(got, want))
        err_hi = max(int((g.long() - w.long()).abs().max()) for g, w in
                     zip(got_hi, want))
        if err or err_hi:
            fail(f"5h: round1_compact at K={k_} differs from "
                 f"round1_compact_ref (max abs err {err}; through its "
                 f"has_hi body {err_hi})")
        k_ms = cuda_ms(torch, lambda: round1_compact.launch(*args), 5)
        row_b = 32 + (4 if dfm.has_hi else 0)
        nbytes = (stats["rows"] * row_b + N * (L + 4)
                  + stats["lut_rows"] * 16 + N * (4 + cap * 20))
        mem_ms = nbytes / HBM_BYTES_PER_S * 1e3
        rb = r1_bounds(stats)
        ops_ms = rb["ops_ms"]
        inst = ptx.get(int(bool(k_)), {})
        over = int((got[0] > cap).sum())
        r = dict(K=k_, reads=N, L=L, steps=stats["steps"],
                 one_block=stats["one_block"], single=stats["single"],
                 single_empty=stats["single_empty"],
                 wide_one_block=stats["wide_one_block"],
                 rows=stats["rows"], lut_rows=stats["lut_rows"],
                 emitted=int(got[0].sum()), over_cap=over, ms=k_ms,
                 plain_ms=p_ms, mem_ms=mem_ms, **rb,
                 bound_ms=max(mem_ms, ops_ms),
                 bound63_ms=max(mem_ms, rb["ops63_ms"]),
                 bound_by="operations" if ops_ms >= mem_ms else "bytes",
                 err=err, registers=inst.get("registers"),
                 spill_bytes=inst.get("spill"),
                 stack_bytes=inst.get("stack"))
        out[f"round1_compact_K{k_}"] = r
        log(f"  round1_compact K={k_} on run (a)'s first chunk ({N} reads x "
            f"L={L}; {stats['steps']} LF steps: "
            f"{rb['one_block_share']:.4f} with both ends in one block, "
            f"{rb['single_share']:.4f} at s = 1, "
            f"{rb['single_empty_share']:.4f} at s = 1 emptying the "
            f"interval; {stats['rows']} distinct "
            f"occ rows, {stats['lut_rows']} table entries; {r['emitted']} "
            f"SMEMs, {over} reads over {cap}): kernel {k_ms:.4f} ms, plain "
            f"{p_ms:.1f} ms, bound {r['bound_ms']:.5f} ms by "
            f"{r['bound_by']} (bytes {mem_ms:.5f}, operations "
            f"{ops_ms:.5f}; two counts a step: {r['bound63_ms']:.5f}), "
            f"identical (also through the has_hi body); "
            f"{inst.get('registers')} registers, {inst.get('spill')} B "
            f"spilled, {inst.get('stack')} B stack frame [{card}]")
    log(f"  round1_walk (K = 0, phase 5f) on the same chunk: "
        f"{r1walk['ms']:.4f} ms, bound {r1walk['bound_ms']:.5f} ms; its "
        f"ptxas line is phase 2's [{card}]")

    # ---- the run's round2_forward, round2_backward and round3_replay
    # launches
    from bwamem2_tpu_torch.parallel.shard_index import shard_index
    two = shard_index(dfm, [dev, dev])[0]
    for name in ("round2_forward", "round2_backward", "round3_replay"):
        out[name] = stage_calls_vs_plain(torch, card, name, calls, two,
                                         "the legacy run's first chunk")

    # ---- kswv_phase, u8 and i16, mixed tdir / live / endsc, at the
    # batch of each class and a large one, in the planner's form and the
    # other (one thread a lane, or the split form)
    text = kernels()["kswv_phase"].build_log or kernels()["kswv"].build_log
    ptx = instances(text, "kswv_phase")
    ptx.update(instances(text, "kswv_split"))
    tot = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, ops_ms=0.0, mem_ms=0.0,
               err=0, problems=0, classes={}, forms=[])
    sc = (*opt.mat_scores(), opt.o_del, opt.e_del, opt.o_ins, opt.e_ins)
    minsc = opt.min_seed_len * opt.a
    for small, cls, u8, n, L_, qr, tr, Qmax, Tmax in (
            (1, "u8", True, PHASE_U8, 160, (100, 161), (150, 700), 160,
             700),
            (1, "i16", False, PHASE_I16, 512, (250, 513), (300, 2049), 512,
             2048),
            (0, "u8", True, PHASE_LARGE_U8, 160, (100, 161), (150, 700),
             160, 700),
            (0, "i16", False, PHASE_LARGE_I16, 512, (250, 513), (300, 2049),
             512, 2048)):
        x = phase_batch(torch, dev, fm.ref_string, 41 if u8 else 43, n, L_,
                        qr, tr)
        ref = torch.from_numpy(fm.ref_string).to(dev)
        args = (ref, *x, Qmax, Tmax, minsc, *sc, False, u8)
        work: list = []
        want, p_ms = plain_ms(lambda: kswv_phase_ref(*args, work=work))
        cells, rows = work[0]
        ops_ms = ((cells * KSWV_OPS_PER_CELL[u8]
                   + rows * (16 if u8 else 8) * KSWV_LAZY_OPS)
                  / INT32_OPS_PER_S * 1e3)
        nbytes = (n * (KSWV_DESC_BYTES + 9 + 24) + int(x[4].sum())
                  + int(x[7].sum()))
        mem_ms = nbytes / HBM_BYTES_PER_S * 1e3
        # the other form: one thread a lane, or the S the planner gives a
        # small batch (the least leaving a thread 8 segments at most)
        auto = kswv_phase.plan(n, Qmax, u8, dev)[3]
        slen = Qmax // (16 if u8 else 8)
        other = [1] if auto > 1 else [
            s_ for s_ in (2, 4, 8) if -(-slen // s_) <= 8][:1]
        for split in [0] + other:
            kswv_phase.split = split
            smax, gpb, smem, S = kswv_phase.plan(n, Qmax, u8, dev)
            n0 = kswv_phase.launches
            got = kswv_phase.launch(*args)
            torch.cuda.synchronize()
            if kswv_phase.launches != n0 + 1:
                fail(f"5h: kswv_phase made {kswv_phase.launches - n0} "
                     "launches for one call (1 expected)")
            err = int((got - want).abs().max())
            if err:
                bad = int((got != want).any(1).sum())
                fail(f"5h: kswv_phase ({cls}, P={n}, S={S}) disagrees with "
                     f"kswv_phase_ref on {bad} of {n} problems (max abs "
                     f"err {err})")
            k_ms = cuda_ms(torch, lambda: kswv_phase.launch(*args), 5)
            inst = ptx.get((u8, smax, S) if S > 1 else (u8, smax), {})
            c = dict(P=n, Qmax=Qmax, Tmax=Tmax, cells=cells, rows=rows,
                     live=int(x[9].sum()), backward=int((x[6] < 0).sum()),
                     ms=k_ms, plain_ms=p_ms, bound_ms=max(ops_ms, mem_ms),
                     register_bucket=smax, groups_per_block=gpb, S=S,
                     planned=split == 0, err=err,
                     registers=inst.get("registers"),
                     spill_bytes=inst.get("spill"),
                     stack_bytes=inst.get("stack"))
            tot["forms"].append(dict(cls=cls, **c))
            log(f"  kswv_phase {cls}: P={n} ({c['live']} live, "
                f"{c['backward']} targets walked backward, stop scores "
                f"mixed) Qmax={Qmax} Tmax={Tmax}, {cells} cells in {rows} "
                f"rows, {'the planner' if split == 0 else 'forced'} S={S}: "
                f"kernel {k_ms:.4f} ms, plain {p_ms:.1f} ms, bound "
                f"{max(ops_ms, mem_ms):.5f} ms, identical; SMAX={smax}, "
                f"{gpb} groups/block, {inst.get('registers')} registers, "
                f"{inst.get('spill')} B spilled, {inst.get('stack')} B "
                f"stack frame [{card}]")
            if split or not small:
                continue
            # the kernels line: each class's batch in the planner's form
            tot["classes"][cls] = c
            for key, v in (("ms", k_ms), ("plain_ms", p_ms),
                           ("bound_ms", max(ops_ms, mem_ms)),
                           ("ops_ms", ops_ms), ("mem_ms", mem_ms),
                           ("problems", n)):
                tot[key] += v
        kswv_phase.split = 0
    if not {f["S"] > 1 for f in tot["forms"]} == {True, False}:
        fail("5h: kswv_phase ran only one form")
    tot["bound_by"] = "operations" if tot["ops_ms"] >= tot["mem_ms"] \
        else "bytes"
    out["kswv_phase"] = tot

    # ---- bsw_shear_tiles on long-read tiles, both bodies, at the 5h batch
    # and a large one, in the planner's form and the others (one warp a
    # pair: a launch per body; the split band: one launch)
    P_small, qr, Wh = SHEAR_TILES
    sc_t = (*sc, opt.zdrop, opt.pen_clip5, max(opt.a, 1))
    sh_ptx = {("blk",) + k: v for k, v in
              instances(bsw_shear.build_log, "bsw_shear_blk").items()}
    forms = []
    for P in (P_small, SHEAR_LARGE):
        rng = np.random.default_rng(47 if P == P_small else 53)
        q, t, qlen, tlen = shear_tiles(rng, P, qr, dev)
        h0 = torch.from_numpy(np.where(np.arange(P) % 4 == 0,
                                       rng.integers(30000, 40000, P),
                                       rng.integers(20, 200, P))
                              .astype(np.int32)).to(dev)
        w = torch.full((P,), Wh, dtype=torch.int32, device=dev)
        cells: list = []
        ref, enc_t, *desc = _tile_descriptors(q, t, qlen, tlen)
        want, p_ms = plain_ms(lambda: bsw_shear_desc_ref(
            ref, enc_t, *desc, h0, w, Wh, t.shape[1], *sc_t, cells=cells))
        fit = bsw_shear.fits16(qlen.cpu().numpy(), h0.cpu().numpy(), Wh,
                               *sc, max(opt.a, 1))
        if not 0 < fit.sum() < P:
            fail(f"5h: {int(fit.sum())} of {P} tile pairs fit 16 bits "
                 "(both bodies expected)")
        ql, tl = qlen.long(), tlen.long()
        nbytes = (P * (DESC_BYTES + OUT_BYTES) + int(ql.sum())
                  + int(torch.minimum(tl, ql + Wh + 2).sum()))
        ops_ms = cells[0] * OPS_PER_CELL / INT32_OPS_PER_S * 1e3
        mem_ms = nbytes / HBM_BYTES_PER_S * 1e3
        for split in (0, 1, 2):
            bsw_shear.split = split
            K_ = bsw_shear.plan(P, Wh, dev)[5]
            if split and any(f["P"] == P and f["K"] == K_ for f in forms):
                continue            # the planner's form, already run
            b0 = bsw_shear.launches
            got = bsw_shear_tiles(q, t, qlen, tlen, h0, w, Wh, *sc_t)
            torch.cuda.synchronize()
            n_launch = bsw_shear.launches - b0
            err = int((got - want).abs().max())
            if err:
                bad = int((got != want).any(1).sum())
                fail(f"5h: bsw_shear_tiles (P={P}, K={K_}) disagrees with "
                     f"bsw_shear_desc_ref on {bad} of {P} tile pairs (max "
                     f"abs err {err})")
            if n_launch != (1 if K_ > 1 else 2):
                fail(f"5h: bsw_shear_tiles made {n_launch} launches at K="
                     f"{K_} ({1 if K_ > 1 else 2} expected: "
                     f"{'one split-band launch' if K_ > 1 else 'one per body'})")
            k_ms = cuda_ms(torch, lambda: bsw_shear_tiles(
                q, t, qlen, tlen, h0, w, Wh, *sc_t), 3)
            plan = bsw_shear.plan(P, Wh, dev)
            inst = sh_ptx.get(("blk", K_, plan[0]), {}) if K_ > 1 else {}
            f = dict(P=P, Qmax=q.shape[1], Tmax=t.shape[1], Wh=Wh,
                     s16=int(fit.sum()), K=K_, planned=split == 0,
                     launches=n_launch, cells=cells[0], ms=k_ms,
                     plain_ms=p_ms, ops_ms=ops_ms, mem_ms=mem_ms,
                     bound_ms=max(ops_ms, mem_ms),
                     bound_by="operations" if ops_ms >= mem_ms else "bytes",
                     err=err, registers=inst.get("registers"),
                     spill_bytes=inst.get("spill"),
                     stack_bytes=inst.get("stack"))
            forms.append(f)
            log(f"  bsw_shear_tiles: {P} tile pairs of {qr[0]}-{qr[1]} "
                f"bases (Qmax {q.shape[1]}, Tmax {t.shape[1]}, Wh {Wh}; "
                f"{int(fit.sum())} fit 16 bits), {cells[0]} cells, "
                f"{'the planner' if split == 0 else 'forced'} K={K_} "
                f"({'split band' if K_ > 1 else 'one warp a pair'}, "
                f"{n_launch} launches): {k_ms:.4f} ms a call, plain "
                f"{p_ms:.1f} ms, bound {max(ops_ms, mem_ms):.5f} ms, "
                f"identical; {inst.get('registers')} registers [{card}]")
        bsw_shear.split = 0
    if {f["K"] > 1 for f in forms} != {True, False}:
        fail("5h: bsw_shear_tiles ran only one form")
    planned = next(f for f in forms if f["P"] == P_small and f["planned"])
    out["bsw_shear_tiles"] = dict(planned, forms=forms)
    return out


def goldens() -> str:
    """The goldens on cuda (phase 7); returns the SAM text of the long-read
    fixture at -x pacbio -w WIDE_W, whose band radii (WIDE_W, 2 * WIDE_W on
    the band-doubling retry) run bsw_shear's shared-memory frame, for
    phase 8."""
    from bwamem2_tpu_torch.align.pipeline import Aligner
    from bwamem2_tpu_torch.ops.bsw_shear_cuda import BswShear
    from bwamem2_tpu_torch.index.fmindex import FMIndex
    from bwamem2_tpu_torch.io.fastq import FastxReader, read_chunk
    from bwamem2_tpu_torch.ops.backend import TorchBackend
    from bwamem2_tpu_torch.options import MEM_F_PE, MemOptions
    from bwamem2_tpu_torch.utils.profiling import PROF
    K = {n: k for n, k in kernels().items() if n != "row_gather"}
    fx = os.path.join(REPO, "tests", "fixtures")
    data = os.path.join(REPO, "tests", "data")
    fm = FMIndex.load(os.path.join(fx, "ref_small.fa"))
    # the kernels each golden must launch: the short-read ones extend on
    # the flat path (no bsw_shear), SE has no rescue, the long-read presets
    # extend on the object path
    short = {"smem_collect", "sa_resolve", "bsw_extend"}
    long = short | {"bsw_shear"}
    for golden, fqs, pe, preset, need in (
            ("golden_se.sam", ("reads_se.fq",), False, None, short),
            ("golden_pe.sam", ("reads_r1.fq", "reads_r2.fq"), True, None,
             short | {"kswv"}),
            ("golden_pacbio.sam", ("reads_pacbio.fq",), False, "pacbio",
             long),
            ("golden_ont2d.sam", ("reads_pacbio.fq",), False, "ont2d",
             long)):
        opt = MemOptions().finalize(preset)
        if pe:
            opt.flag |= MEM_F_PE
        ks = [FastxReader(os.path.join(data, f)) for f in fqs]
        reads = read_chunk(ks[0], ks[1] if pe else None, 10**9)
        n0 = {n: k.launches for n, k in K.items()}
        tail0 = PROF.c.get("overflow.bsw_host_tail", 0)
        backend = TorchBackend(fm, opt)
        Aligner(fm, opt, backend=backend, verbose=0).process(reads, 0)
        if PROF.c.get("overflow.bsw_host_tail", 0) != tail0:
            fail(f"{golden}: extension pairs ran on the host kernel")
        if not backend._bsw.encj.is_cuda:
            fail(f"{golden}: the read grid is not on the card")
        with open(os.path.join(fx, golden)) as f:
            want = [ln for ln in f if not ln.startswith("@")]
        ours = "".join(r.sam for r in reads).splitlines(keepends=True)
        if ours != want:
            bad = sum(a != b for a, b in zip(ours, want))
            fail(f"{golden} differs on cuda ({bad} lines of {len(want)}, "
                 f"{len(ours)} produced)")
        n = {name: k.launches - n0[name] for name, k in K.items()}
        if not all(n[name] for name in need):
            fail(f"{golden}: a kernel was not launched: {n}")
        log(f"  {golden}: identical ({len(want)} records, launches {n})")
    # the SE flag matrix (tests/test_golden_flags.py:SE_CASES) on cuda;
    # -A2 against the host-native run: its golden is bwa-mem2's vectorized
    # 8-bit kernel, which deviates from the scalar semantics the port keeps
    from bwamem2_tpu_torch.cli import parse_mem_args
    prefix = os.path.join(fx, "ref_small.fa")
    t0 = time.perf_counter()
    for flags, golden in SE_FLAGS:
        parsed = parse_mem_args(flags.split() + [prefix, "x"])
        opt, pes0 = parsed[0], parsed[9]
        opt.finalize(parsed[1])
        runs = []
        for be in (TorchBackend(fm, opt), None):
            reads = read_chunk(FastxReader(os.path.join(data, "reads_se.fq")),
                               None, 10**9)
            Aligner(fm, opt, backend=be, verbose=0).process(reads, 0,
                                                            pes0=pes0)
            runs.append("".join(r.sam for r in reads).splitlines(
                keepends=True))
            if golden:
                break
        if golden:
            with open(os.path.join(fx, golden)) as f:
                runs.append([ln for ln in f if not ln.startswith("@")])
        if runs[0] != runs[1]:
            bad = sum(a != b for a, b in zip(*runs))
            fail(f"SE flags {flags}: {bad} lines of {len(runs[1])} differ "
                 f"on cuda from {golden or 'the host-native run'}")
    log(f"  SE flag matrix ({len(SE_FLAGS)} flag sets) on cuda: identical "
        f"to the goldens, -A2 to the host-native run "
        f"({time.perf_counter() - t0:.1f}s)")
    bands = []
    orig = BswShear.launch

    def spy(self, *args, **kw):
        bands.append(args[10])
        return orig(self, *args, **kw)

    opt = MemOptions()
    opt.set("w", WIDE_W)
    opt.finalize("pacbio")
    reads = read_chunk(FastxReader(os.path.join(data, "reads_pacbio.fq")),
                       None, 10**9)
    for r in reads:
        r.comment = None
    tail0 = PROF.c.get("overflow.bsw_host_tail", 0)
    BswShear.launch = spy
    try:
        Aligner(fm, opt, backend=TorchBackend(fm, opt), verbose=0).process(
            reads, 0)
    finally:
        BswShear.launch = orig
    if PROF.c.get("overflow.bsw_host_tail", 0) != tail0:
        fail(f"-w {WIDE_W}: extension pairs ran on the host kernel")
    frames = {wh: K["bsw_shear"].plan(1, wh, "cuda")[4]
              for wh in set(bands)}
    if not frames or not all(frames.values()):
        fail(f"-w {WIDE_W}: a bsw_shear launch did not use the "
             f"shared-memory frame (band radii {sorted(frames)})")
    log(f"  reads_pacbio.fq at -x pacbio -w {WIDE_W} on cuda: "
        f"{len(bands)} bsw_shear launches at band radii {sorted(frames)} "
        f"(shared-memory frame bytes {frames}); SAM checked in phase 8")
    return "".join(r.sam for r in reads)


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
    # the host-native oracle of run (a)'s first chunk, the longest task of
    # phase 8's pool (one process, ~400 s), starts now and runs beside the
    # card phases; leaving the script terminates it
    import atexit
    import multiprocessing as mp
    first_oracle = mp.get_context("spawn").Pool(1)
    atexit.register(first_oracle.terminate)
    fut_a0 = first_oracle.apply_async(oracle_chunk, (prefix, fq1, fq2, 0))

    # ---- the seeding stage's first call, split, in a fresh process
    r = subprocess.run([sys.executable, os.path.abspath(__file__),
                        "--first-call", fq1, fq2, prefix],
                       capture_output=True, text=True, timeout=600)
    if r.returncode:
        fail(f"first-call split failed:\n{r.stderr[-3000:]}")
    first = json.loads(r.stdout.strip().splitlines()[-1])
    log("[3b] seeding's first call on run (a)'s first chunk, fresh process "
        f"(s) [{card}]: " + ", ".join(f"{k} {v:.4f}" for k, v in
                                       first.items()))

    # ---- main path, twice: counts to 0, drive the CLI entry, read them
    os.makedirs(WORK, exist_ok=True)
    sam = os.path.join(WORK, "main_path.sam")
    log("[4] main path (mem PE, CLI entry, cuda):")
    run_a = drive_main(torch, card, f"(a) -K {TASK_BASES}", [
        "-K", str(TASK_BASES), "-v", "1", "-o", sam, prefix, fq1, fq2],
        fq1, fq2, 2 * N_PAIRS, TASK_BASES)
    chunks = run_a["chunks"]
    _, fq1d, fq2d = benchdata.ensure(
        os.path.join(REPO, ".tmp", f"bench_scale{DATA_SCALE}"), DATA_SCALE,
        DEFAULT_PAIRS)
    run_b = drive_main(torch, card, "(b) default task size", [
        "-v", "1", "-o", os.path.join(WORK, "main_default.sam"), prefix,
        fq1d, fq2d], fq1d, fq2d, 2 * DEFAULT_PAIRS, DEFAULT_TASK_BASES)
    # (c): -A52 (-B scaled to 208, beyond the int8 score matrix, which
    # holds a mismatch of +48) on the first A52_PAIRS pairs, -K as (a)
    fq1c, fq2c = (head_fastq(f, os.path.join(WORK, f"a52_{i}.fq"),
                             A52_PAIRS) for i, f in ((1, fq1), (2, fq2)))
    sam_c = os.path.join(WORK, "main_a52.sam")
    run_c = drive_main(torch, card, f"(c) -A52 -K {TASK_BASES}", [
        "-A52", "-K", str(TASK_BASES), "-v", "1", "-o", sam_c, prefix, fq1c,
        fq2c], fq1c, fq2c, 2 * A52_PAIRS, TASK_BASES)
    # (d): -x pacbio (SE) on LONG_READS 2-8 kb reads of the same genome:
    # the object-path extension, long pairs on bsw_shear
    _, fq_long = benchdata.ensure_long(
        os.path.join(REPO, ".tmp", f"bench_scale{DATA_SCALE}"), DATA_SCALE,
        LONG_READS)
    sam_d = os.path.join(WORK, "main_pacbio.sam")
    run_d = drive_long(torch, card, "(d) -x pacbio", [
        "-x", "pacbio", "-v", "1", "-o", sam_d, prefix, fq_long], fq_long,
        LONG_READS)
    shear_d = run_d.pop("_shear")
    log("[4e] round-robin over per-card backends, run (a)'s data:")
    rr = round_robin(torch, card, prefix, fq1, fq2, sam)
    log("[4f] --shard h:2 processes + merge, run (a)'s data:")
    shards = shard_phase(card, prefix, fq1, fq2)
    log("[4g] mem over a sharded index, run (a)'s data:")
    run_g = sharded_mem(torch, card, prefix, fq1, fq2, sam)
    stage_calls = run_g.pop("_launches")
    log("[4h] mem PE with the legacy round 1 (TorchBackend(pivot_seeding="
        "False), K-mer table), run (a)'s data, and the kernel_micro entry:")
    run_h = legacy_mem(torch, card, prefix, fq1, fq2, sam)
    legacy_calls = run_h.pop("_launches")
    log("[4i] host ceiling (record / replay), run (a)'s data:")
    ceiling = host_ceiling_phase(card, prefix, fq1, fq2, sam)
    log("[4j] run (a) traced under BWAMEM2_TPU_TRACE, fresh process:")
    traced = trace_phase(card, prefix, fq1, fq2, sam, run_a["wall_s"])
    runs = (run_a, run_b, run_c, run_d, rr, run_g, run_h)
    # the kernels line counts the launches of the seven runs
    launches = {n: sum(r["launches"][n] for r in runs)
                for n in run_a["launches"]}
    cap_a, cap_b = run_a.pop("_capture"), run_b.pop("_capture")
    bsw_b = run_b.pop("_bsw")
    for r in (run_a, run_c):
        r.pop("_bsw")
    run_c.pop("_capture")

    # the host-native oracle (one process per chunk) runs while the kernels
    # are held against their plain versions and the goldens run
    # (leaving the `with` terminates the pool, also when a phase fails)
    opt = MemOptions().finalize(None)
    t0 = time.perf_counter()
    cuts = [LONG_READS * k // LONG_ORACLE_PARTS
            for k in range(LONG_ORACLE_PARTS + 1)]
    with mp.get_context("spawn").Pool(min(chunks + 1 + LONG_ORACLE_PARTS,
                                          os.cpu_count() or 1)) as pool:
        futs = [fut_a0] + [pool.apply_async(oracle_chunk,
                                            (prefix, fq1, fq2, i))
                           for i in range(1, chunks)]
        fut_c = pool.apply_async(oracle_chunk, (prefix, fq1c, fq2c, 0, 52))
        fut_d = [pool.apply_async(oracle_long, (prefix, fq_long, lo, hi,
                                                "pacbio"))
                 for lo, hi in zip(cuts, cuts[1:])]
        fx = os.path.join(REPO, "tests", "fixtures")
        fut_w = pool.apply_async(oracle_long, (
            os.path.join(fx, "ref_small.fa"),
            os.path.join(REPO, "tests", "data", "reads_pacbio.fq"), 0, 25,
            "pacbio", WIDE_W))
        log(f"[5f] seed-extend step (round1_walk, sa_resolve, bsw_tiles) on "
            f"{name}:")
        st = step_phase(torch, card, prefix, fq1, fq2)
        log(f"[5g] per-stage seeding kernels vs plain on the sharded run's "
            f"first chunk, and the 2-shard index on {name}:")
        sg = stage_vs_plain(torch, card, stage_calls, prefix, fq1, fq2,
                            st.pop("_out"))
        del stage_calls
        log(f"[5h] the legacy round 1, the one-phase kswv and the tile "
            f"form of bsw_shear vs plain on {name}:")
        lh = legacy_vs_plain(torch, card, legacy_calls, fm, opt,
                             st["round1_walk"])
        del legacy_calls
        log(f"[5a] bsw_extend vs plain on {name}, P={P_KERNEL} per rung:")
        tot = kernel_vs_plain(torch, fm, opt)
        log(f"  all rungs identical; kernel {tot['ms']:.3f} ms (one-thread "
            f"design {ONE_THREAD_BSW_MS['synthetic rungs']} ms), plain "
            f"{tot['plain_ms']:.1f} ms, bound {tot['bound_ms']:.4f} ms "
            f"({OPS_PER_CELL_24}-op model {tot['bound24_ms']:.4f} ms; "
            f"{tot['cells']} cells) [{card}]")
        pm = pallas_matrix(torch)
        log(f"[5a] bsw_tiles vs bsw_desc_ref on tools/pallas_parity_hw.py's "
            f"matrix: {pm['configs']} configurations, {pm['pairs']} pairs "
            f"({pm['launches']} launches), all identical [{card}]")
        log(f"[5a] bsw_extend vs plain on the main path's {len(bsw_b)} "
            f"launches of run (b)'s first chunk [{card}]:")
        bm = bsw_main_path(torch, bsw_b)
        del bsw_b
        log(f"  all identical; kernel {bm['ms']:.4f} ms over "
            f"{bm['launches']} launches ({bm['pairs']} pairs, {bm['cells']} "
            f"cells; one-thread design {ONE_THREAD_BSW_MS['main path']} "
            f"ms), plain {bm['plain_ms']:.1f} ms, bound "
            f"{bm['bound_ms']:.5f} ms ({OPS_PER_CELL_24}-op model "
            f"{bm['bound24_ms']:.5f} ms) [{card}]")
        log(f"[5e] bsw_shear vs plain on run (d)'s {len(shear_d)} "
            f"calls [{card}]:")
        sh = shear_main_path(torch, shear_d)
        del shear_d
        log(f"  all identical; kernel {sh['ms']:.4f} ms over "
            f"{sh['launches']} launches of {sh['calls']} calls "
            f"({sh['pairs']} pairs: {sh['routes']['s16']} 16-bit, "
            f"{sh['routes']['int32']} int32; {sh['cells']} cells), plain "
            f"{sh['plain_ms']:.1f} ms, bound {sh['bound_ms']:.5f} ms "
            f"[{card}]")
        log(f"[5b] smem_collect / sa_resolve vs plain on {name} [{card}]:")
        sd = seeding_vs_plain(torch, fm, (
            ("sample", fq1, fq2, TASK_BASES, N_SEED, None),
            ("chunk (a)", fq1, fq2, TASK_BASES, None, None),
            ("chunk (b)", fq1d, fq2d, DEFAULT_TASK_BASES, None, None)), opt)
        t1 = time.perf_counter()
        prefix2, fq1x, fq2x = benchdata.ensure(
            os.path.join(REPO, ".tmp", f"bench_scale{DRAM_SCALE}"),
            DRAM_SCALE, DEFAULT_PAIRS)
        fm2 = FMIndex.load(prefix2)
        log(f"[5d] smem_collect / sa_resolve at DRAM scale: l_pac="
            f"{fm2.l_pac} ({DRAM_SCALE}x chr21, occ table "
            f"{fm2.l_pac * 2 // 64 * 32 / 1e6:.1f} MB), data "
            f"{time.perf_counter() - t1:.1f}s [{card}]:")
        sd.update(seeding_vs_plain(torch, fm2, (
            ("DRAM chunk", fq1x, fq2x, DEFAULT_TASK_BASES, None, N_SEED),),
            opt))
        del fm2
        log(f"[5c] kswv vs plain and DeviceKswv vs native ksw_align on "
            f"{name} [{card}]:")
        rs = rescue_vs_plain(torch, fm, opt, (
            ("chunk (a)", *cap_a), ("chunk (b)", *cap_b),
            synthetic_rescue(torch, fm.ref_string, "i16 batch", 17, [
                (N_I16, (250, 513), (300, 2049), False)]),
            synthetic_rescue(torch, fm.ref_string, "long batch", 19, [
                (N_LONG, (513, 1501), (600, 3001), False),
                (N_LONG, (60, 150), (2049, 4001), True)])))
        # i16 scores past 16 bits (a = 64, the other scores at their
        # defaults): the kernel saturates at 32767 as the native one does
        wide = MemOptions()
        wide.a = 64
        wide.finalize(None)
        rs.update(rescue_vs_plain(torch, fm, wide, (synthetic_rescue(
            torch, fm.ref_string, "i16 a=64 batch", 29, [
                (N_WIDE, (513, 701), (600, 1201), False)]),)))
        if not rs["i16 a=64 batch"]["saturated_i16"]:
            fail("5c: no i16 score of the a=64 batch reached 32767")
        # -A52 as the CLI sets it (-B 208 raw, +48 in the int8 matrix): the
        # i16 batch's problems again
        a52 = MemOptions()
        a52.set("a", 52)
        a52.finalize(None)
        rs.update(rescue_vs_plain(torch, fm, a52, (synthetic_rescue(
            torch, fm.ref_string, "i16 a=52 batch", 17, [
                (N_I16, (250, 513), (300, 2049), False)]),)))
        del cap_a, cap_b
        torch.save(KSWV_B, os.path.join(WORK, "kswv_b_first.pt"))
        KSWV_B.clear()
        log(f"[6] gather probe on {name} [{card}]:")
        gt = gather_phase(torch, fm)
        log("[7] goldens on cuda:")
        wide_sam = goldens()
        oracle = [f.get() for f in futs]
        first_oracle.close()
        oracle_c = fut_c.get()
        oracle_d = [f.get() for f in fut_d]
        oracle_w = fut_w.get()
    if wide_sam != oracle_w[0]:
        fail(f"-x pacbio -w {WIDE_W} on the long-read fixture differs from "
             f"the host-native run")
    log(f"[8] -x pacbio -w {WIDE_W} (fixture) SAM == host-native "
        f"Aligner(backend=None) SAM")
    for tag, path, texts in (("(a)", sam, [o[0] for o in oracle]),
                             ("(c) -A52", sam_c, [oracle_c[0]]),
                             ("(d) -x pacbio", sam_d,
                              [o[0] for o in oracle_d])):
        ours = [ln for ln in read_sam_body(path) if not ln.startswith("@")]
        want = "".join(texts).splitlines(keepends=True)
        if ours != want:
            bad = sum(x != y for x, y in zip(ours, want))
            fail(f"run {tag}'s SAM differs from the host-native run: {bad} "
                 f"of {len(want)} records ({len(ours)} produced)")
        log(f"[8] run {tag}'s SAM == host-native Aligner(backend=None) SAM "
            f"({len(want)} records)")
    log(f"    oracle {time.perf_counter() - t0:.1f}s, per chunk of (a) "
        + ", ".join(f"{o[1]:.1f}s" for o in oracle)
        + f", (c) {oracle_c[1]:.1f}s, (d) "
        + ", ".join(f"{o[1]:.1f}s" for o in oracle_d))

    # the seeding kernels' times and bounds at run (b)'s first chunk, the
    # largest shape the main path gave them; errors over every pass
    big = sd["chunk (b)"]
    sm_err = max(r["smem_err"] for r in sd.values())
    for tag, r in sd.items():
        if tag != "sample" and r["overflow_share"] > MAX_OVERFLOW:
            fail(f"{tag}: {r['overflowed']} of {r['reads']} reads outran "
                 f"the seeding kernel's list or slots")
    sa_err = max(r["sa_err"] for r in sd.values())
    by = lambda ops, mem: "operations" if ops >= mem else "bytes"  # noqa
    # kswv's time and bound on run (b)'s first chunk's rescue problems, the
    # largest batch the main path gave it; errors over every batch
    rb = rs["chunk (b)"]["classes"]
    ks_err = max(c["err"] for r in rs.values() for c in r["classes"].values())
    # bsw_extend's time and bound: its launches on run (b)'s first chunk
    kern = [
        dict(name="bsw_extend", route="cuda",
             source="bwamem2_tpu_torch/csrc/bsw_extend.cu",
             replaces="bwamem2_tpu/ops/bsw_pallas.py:69",
             launches=launches["bsw_extend"], max_abs_err=tot["err"],
             ms=round(bm["ms"], 4), plain_ms=round(bm["plain_ms"], 3),
             bound_ms=round(bm["bound_ms"], 5),
             bound_by=by(bm["ops_ms"], bm["mem_ms"]), library_ms=None,
             library_note="no PyTorch call computes banded SW",
             shape=f"sum over the {bm['launches']} launches of run (b)'s "
                   f"first chunk, {bm['pairs']} pairs"),
        dict(name="bsw_shear", route="cuda",
             source="bwamem2_tpu_torch/csrc/bsw_shear.cu",
             replaces="bwamem2_tpu/ops/bsw.py:572",
             launches=launches["bsw_shear"], max_abs_err=sh["err"],
             ms=round(sh["ms"], 4), plain_ms=round(sh["plain_ms"], 3),
             bound_ms=round(sh["bound_ms"], 5),
             bound_by=by(sh["ops_ms"], sh["mem_ms"]), library_ms=None,
             library_note="no PyTorch call computes banded SW",
             shape=f"sum over the {sh['calls']} calls ({sh['launches']} "
                   f"launches) of run (d) (-x pacbio, {LONG_READS} reads "
                   f"of 2-8 kb), {sh['pairs']} pairs"),
        dict(name="smem_collect", route="cuda",
             source="bwamem2_tpu_torch/csrc/smem_collect.cu",
             replaces="bwamem2_tpu/ops/seedall.py:93",
             launches=launches["smem_collect"], max_abs_err=sm_err,
             ms=round(big["smem_ms"], 4),
             plain_ms=round(big["smem_plain_ms"], 3),
             bound_ms=round(big["smem_bound_ms"], 5),
             bound_by=big["smem_bound_by"],
             library_ms=None, library_note="no PyTorch call computes SMEMs",
             shape=f"{big['reads']} reads x L={big['L']} (run (b)'s first "
                   f"chunk), {big['bwd_ext']} backward_ext, "
                   f"{big['lanes']} lanes per read"),
        dict(name="sa_resolve", route="cuda",
             source="bwamem2_tpu_torch/csrc/sa_resolve.cu",
             replaces="bwamem2_tpu/ops/seedall.py:602",
             launches=launches["sa_resolve"], max_abs_err=sa_err,
             ms=round(big["sa_ms"], 4), plain_ms=round(big["sa_plain_ms"], 3),
             bound_ms=round(big["sa_bound_ms"], 5), bound_by="bytes",
             library_ms=None,
             library_note="no PyTorch call computes SA walks",
             shape=f"{big['positions']} positions (run (b)'s first chunk), "
                   f"{big['sa_row_reads']} row reads"),
        dict(name="kswv", route="cuda",
             source="bwamem2_tpu_torch/csrc/kswv.cu",
             replaces="bwamem2_tpu/ops/kswv.py:303",
             launches=launches["kswv"], max_abs_err=ks_err,
             ms=round(sum(c["ms"] for c in rb.values()), 4),
             plain_ms=round(sum(c["plain_ms"] for c in rb.values()), 3),
             bound_ms=round(sum(c["bound_ms"] for c in rb.values()), 5),
             bound_by=rb[max(rb, key=lambda k: rb[k]["P"])]["bound_by"],
             library_ms=None,
             library_note="no PyTorch call computes striped SW",
             shape=", ".join(f"{c['P']} {k} problems, Qmax={c['Qmax']}, "
                             f"Tmax={c['Tmax']}" for k, c in rb.items())
             + " (run (b)'s first chunk)"),
        dict(name="row_gather", route="cuda",
             source="bwamem2_tpu_torch/csrc/row_gather.cu",
             replaces="tools/gather_scale_probe.py:78",
             launches=gt["launches"], max_abs_err=gt["err"],
             ms=round(gt["ms"], 4), plain_ms=round(gt["plain_ms"], 4),
             bound_ms=round(gt["bound_ms"], 5), bound_by="bytes",
             library_ms=round(gt["library_ms"], 4),
             library_note="torch.index_select",
             shape=f"sum over the probe's {len(PROBE_SIZES_MB)} tables "
                   f"(4-4096 MB), P={P_GATHER} rows of 16 int32 each"),
        dict(name="round1_walk", route="cuda",
             source="bwamem2_tpu_torch/csrc/round1_walk.cu",
             replaces="bwamem2_tpu/ops/smem.py:164",
             launches=st["launches"]["round1_walk"],
             max_abs_err=st["round1_walk"]["err"],
             ms=round(st["round1_walk"]["ms"], 4),
             plain_ms=round(st["round1_walk"]["plain_ms"], 3),
             bound_ms=round(st["round1_walk"]["bound_ms"], 5),
             bound_by=st["round1_walk"]["bound_by"], library_ms=None,
             bound63_ms=round(st["round1_walk"]["bound63_ms"], 5),
             library_note="no PyTorch call walks an FM-index",
             shape=f"{st['round1_walk']['lanes']} lanes (run (a)'s first "
                   f"chunk, {st['round1_walk']['reads']} reads x L="
                   f"{st['round1_walk']['L']}), {st['round1_walk']['steps']}"
                   f" LF steps"),
    ]
    r1k = lh[f"round1_compact_K{LEGACY_K}"]
    kp = lh["kswv_phase"]
    kern += [
        dict(name="round1_compact", route="cuda",
             source="bwamem2_tpu_torch/csrc/round1_compact.cu",
             replaces="bwamem2_tpu/ops/smem.py:171",
             launches=launches["round1_compact"],
             max_abs_err=max(lh["round1_compact_K0"]["err"], r1k["err"]),
             ms=round(r1k["ms"], 4), plain_ms=round(r1k["plain_ms"], 3),
             bound_ms=round(r1k["bound_ms"], 5), bound_by=r1k["bound_by"],
             library_ms=None, bound63_ms=round(r1k["bound63_ms"], 5),
             library_note="no PyTorch call walks an FM-index",
             shape=f"run (a)'s first chunk, {r1k['reads']} reads x L="
                   f"{r1k['L']}, K={LEGACY_K}, {r1k['steps']} LF steps "
                   f"(K=0: {lh['round1_compact_K0']['ms']:.4f} ms)"),
        dict(name="kswv_phase", route="cuda",
             source="bwamem2_tpu_torch/csrc/kswv.cu",
             replaces="bwamem2_tpu/ops/kswv.py:66",
             launches=run_h["micro_launches"]["kswv_phase"],
             max_abs_err=kp["err"], ms=round(kp["ms"], 4),
             plain_ms=round(kp["plain_ms"], 3),
             bound_ms=round(kp["bound_ms"], 5), bound_by=kp["bound_by"],
             library_ms=None,
             library_note="no PyTorch call computes striped SW",
             shape=", ".join(f"{c['P']} {k} problems, Qmax={c['Qmax']}, "
                             f"Tmax={c['Tmax']}"
                             for k, c in kp["classes"].items())
             + " (mixed target directions, live flags, stop scores)"),
    ]
    replaces = dict(round1_chain="bwamem2_tpu/ops/smem.py:308",
                    round2_forward="bwamem2_tpu/ops/smem.py:387",
                    round2_backward="bwamem2_tpu/ops/smem.py:464",
                    round3_replay="bwamem2_tpu/ops/smem.py:209")
    for n in STAGES:
        r = sg[n]
        shape = (f"sum over the {r['launches']} launches of the sharded "
                 f"run's first chunk (run (a)'s reads, 2 shards), "
                 f"{r['steps']} steps")
        shape += f"; replicated {r['other_ms']:.4f} ms"
        if "chain_loads" in r:
            shape += f"; longest chain {r['chain_loads']} dependent loads"
        if n in lh:
            shape += (f"; the legacy run's {lh[n]['launches']} first-chunk "
                      f"launches {lh[n]['ms']:.4f} ms")
        kern.append(dict(
            name=n, route="cuda", source=f"bwamem2_tpu_torch/csrc/{n}.cu",
            replaces=replaces[n], launches=launches[n],
            max_abs_err=max(r["err"], lh.get(n, r)["err"]),
            ms=round(r["ms"], 4), plain_ms=round(r["plain_ms"], 3),
            bound_ms=round(r["bound_ms"], 5), bound_by=r["bound_by"],
            library_ms=None,
            library_note="no PyTorch call walks an FM-index", shape=shape))
    result = dict(kernels=kern, card=card, first_call_s=first,
                  main_a=run_a, main_b=run_b, main_a52=run_c,
                  main_pacbio=run_d, round_robin=rr, shards=shards,
                  sharded_index=run_g, stages=sg, step=st,
                  legacy=run_h, legacy_kernels=lh,
                  host_ceiling=ceiling, trace=traced, bsw_pallas_matrix=pm,
                  launches=launches,
                  build_s={k: round(v, 1) for k, v in secs.items()},
                  bsw_main=bm, bsw_rungs=tot, bsw_shear=sh,
                  seeding=sd, rescue=rs, gather=gt,
                  total_s=round(time.perf_counter() - t_start, 1))
    with open(os.path.join(WORK, "chip_smoke.json"), "w") as f:
        json.dump(result, f, indent=1)
    log(f"[done] {result['total_s']}s")
    print(json.dumps({"kernels": kern}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--first-call"]:
        sys.path.insert(0, REPO)
        first_call_split(*sys.argv[2:5])
    elif sys.argv[1:2] == ["--trace-run"]:
        sys.path.insert(0, REPO)
        trace_run(*sys.argv[2:7])
    else:
        main()

"""Per-kernel microbenchmarks at bench-run shapes, on the card.

The port of tools/kernel_micro.py: times each device kernel warm, end to
end (enqueue, execute, fetch: the best of --reps calls, each ending in a
synchronize), at the JAX tool's shapes and in its order, on the
chr21-scale genome that benchdata.ensure_genome generates under .tmp/,
and prints one line of ms per call for each:

  round1_chain     N = 5,120 reads x L = 152 (random bases, 151 long)
  round2_forward   11,520 pivots, 24 candidate slots
  round2_backward  11,520 lanes from the forward candidates, 32 steps
  round3_replay    the N reads, max_intv 20, min length 20, 8 slots
  sa_resolve       32,768 positions
  bsw_extend       (P, Q, T) = (512, 127, 96), (512, 255, 320),
                   (1024, 127, 96)
  kswv_phase       the one-phase u8 rescue kernel at (P, Q, T) =
                   (512, 160, 512) and (512, 160, 1024)
and two lines the JAX tool has no counterpart for: round1_compact (the
legacy round 1) on the N reads at K = default_k(l_pac), and
bsw_shear_tiles on one long-read tile shape (256 pairs of 4-8 kb at
Wh = 100).

    python3 -m bwamem2_tpu_torch.tools.kernel_micro [--device cuda]
        [--scale 1.0] [--reps 5]

--device defaults to cuda and raises without a card (no silent CPU run);
--device cpu runs the plain versions.  The first line is the card's name
and power limit (nvidia-smi).  The kswv_phase and bsw_shear_tiles lines
also give the least time the card could take for the same work, from the
models of csrc/kswv.cu's and csrc/bsw_shear.cu's headers (as chip_smoke.py
phase 5h counts them: int32 operations per cell the plain version counts
on these inputs, at the card's INT32 issue rate, against the bytes
moved).
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

N_READS, READ_L = 5120, 152
N_PIVOTS = 11520
N_SA = 32768
BSW_RUNGS = ((512, 127, 96), (512, 255, 320), (1024, 127, 96))
KSWV_SHAPES = ((512, 160, 512), (512, 160, 1024))
SHEAR_TILE = (256, (4000, 8000), 100)     # pairs, query lengths, Wh

# the bounds' models (chip_smoke.py's constants): H100 SXM INT32 issue
# rate (132 SMs x 64 lanes x 1.98 GHz) and HBM rate; int32 operations per
# kswv cell (u8 main pass; i16 9) and per lazy-F cell of a row's first
# sweep; per banded-SW cell; bytes of a descriptor and an output row
INT32_OPS_PER_S = 132 * 64 * 1.98e9
HBM_BYTES_PER_S = 3.35e12
KSWV_OPS_PER_CELL, KSWV_LAZY_OPS = {True: 10, False: 9}, 4
KSWV_DESC_BYTES = 25
SHEAR_OPS_PER_CELL, SHEAR_DESC_BYTES, SHEAR_OUT_BYTES = 10, 36, 24


def card(dev: torch.device) -> str:
    if dev.type != "cuda":
        return f"cpu (torch {torch.__version__})"
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    return r.stdout.strip().splitlines()[0] if r.returncode == 0 else \
        torch.cuda.get_device_name(dev)


def timed(dev, f, reps: int) -> float:
    """The best wall ms of `reps` calls of f (after one warm call), each
    ending in a synchronize (the result fetched)."""
    def once():
        out = f()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return out
    once()
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        once()
        best = min(best, time.perf_counter() - t0)
    return best * 1e3


def shear_tiles(rng, P: int, qr: tuple, dev):
    """P long-read tiles: targets of random bases, queries copied from
    their starts with ~10 % substitutions, insertions and deletions."""
    qs, ts = [], []
    for _ in range(P):
        ql = int(rng.integers(*qr))
        t = rng.integers(0, 4, ql + 200).astype(np.int8)
        keep = rng.random(ql) >= 0.03                   # deletions
        q = t[:ql][keep].copy()
        sub = rng.random(len(q)) < 0.04
        q[sub] = rng.integers(0, 4, int(sub.sum()))
        ins = np.flatnonzero(rng.random(len(q)) < 0.03)
        q = np.insert(q, ins, rng.integers(0, 4, len(ins)).astype(np.int8))
        qs.append(q[:ql])
        ts.append(t)
    qlen = np.array([len(q) for q in qs], np.int32)
    tlen = np.array([len(t) for t in ts], np.int32)
    q = np.full((P, int(qlen.max())), 4, np.int8)
    t = np.full((P, int(tlen.max())), 4, np.int8)
    for i in range(P):
        q[i, :qlen[i]] = qs[i]
        t[i, :tlen[i]] = ts[i]
    return [torch.from_numpy(a).to(dev) for a in (q, t, qlen, tlen)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--scale", type=float, default=1.0,
                    help="genome scale of the chr21 class (benchdata)")
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)

    from .. import benchdata
    from ..index.fmindex import FMIndex
    from ..index.klut import default_k, load_or_build_klut
    from ..ops import resolve_device
    from ..ops.bsw import (_tile_descriptors, bsw_shear_desc_ref,
                           bsw_shear_tiles)
    from ..ops.bsw_cuda import bsw_extend
    from ..ops.device_index import DeviceFMIndex
    from ..ops.kswv import NO_LIMIT, kswv_phase_ref
    from ..ops.kswv_cuda import kswv_phase
    from ..ops.seed import sa_resolve
    from ..ops.smem import (round1_chain, round1_compact, round2_backward,
                            round2_forward, round3_replay)
    from ..options import MemOptions

    dev = resolve_device(args.device)       # cuda without a card raises
    print(f"card: {card(dev)}", flush=True)
    prefix = benchdata.ensure_genome(
        os.path.join(REPO, ".tmp", f"bench_scale{args.scale}"), args.scale)
    fm = FMIndex.load(prefix)
    opt = MemOptions().finalize()
    K = default_k(fm.l_pac)
    dfm = DeviceFMIndex.from_host(fm, dev, load_or_build_klut(fm, None, K))
    print(f"genome: {prefix}, l_pac={fm.l_pac}, K-mer table depth {K}",
          flush=True)
    rng = np.random.default_rng(7)
    put = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa
    reps = args.reps

    def line(name: str, shape: str, ms: float, bound=None) -> None:
        if bound is not None:       # the time stays last on the line
            shape = f"{shape:<40} (bound {bound[0]:.5f} ms, {bound[1]})"
        print(f"{name:<15} {shape:<40} {ms:10.4f} ms", flush=True)

    def bound(ops: float, nbytes: float) -> tuple:
        o, b = ops / INT32_OPS_PER_S * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
        return (o, "operations") if o >= b else (b, "bytes")

    # --- seeding round 1: the chain kernel, one lane a read ---
    N, L = N_READS, READ_L
    enc = put(rng.integers(0, 4, (N, L)).astype(np.int8))
    lens = put(np.full(N, L - 1, np.int32))
    line("round1_chain", f"N={N} L={L}",
         timed(dev, lambda: round1_chain(dfm, enc, lens, 48), reps))
    # --- round 2 forward / backward at the observed pivot counts ---
    rid = put(rng.integers(0, N, N_PIVOTS).astype(np.int32))
    x = put(rng.integers(20, 100, N_PIVOTS).astype(np.int32))
    mi = put(np.ones(N_PIVOTS, np.int64))
    line("round2_forward", f"P={N_PIVOTS}",
         timed(dev, lambda: round2_forward(dfm, enc, rid, x, mi, 24), reps))
    cn, ck, cl, cs, ncand = round2_forward(dfm, enc, rid, x, mi, 24)
    piv = put(np.arange(N_PIVOTS, dtype=np.int32))
    slot = put(np.zeros(N_PIVOTS, np.int32))
    line("round2_backward", f"M={N_PIVOTS} (32-step phase)",
         timed(dev, lambda: round2_backward(dfm, enc, rid, x, ck, cs, piv,
                                            slot, mi, 32), reps))
    line("round3_replay", f"N={N} L={L}",
         timed(dev, lambda: round3_replay(dfm, enc, lens, 20, 20, 8), reps))
    # --- the legacy round 1 (no counterpart in the JAX tool) ---
    line("round1_compact", f"N={N} L={L} K={K}",
         timed(dev, lambda: round1_compact(dfm, enc, lens, K,
                                           opt.min_seed_len, 24), reps))
    # --- SA resolution ---
    pos = put(rng.integers(0, 2 * fm.l_pac, N_SA).astype(np.int64))
    line("sa_resolve", f"M={N_SA}",
         timed(dev, lambda: sa_resolve(dfm, pos), reps))
    # --- extension at the dominant rungs ---
    scores = (*opt.mat_scores(), opt.o_del, opt.e_del, opt.o_ins, opt.e_ins)
    for P, Q, T in BSW_RUNGS:
        qoff = put(rng.integers(0, N * L - 200, P).astype(np.int32))
        one = put(np.ones(P, np.int32))
        qlen = put(np.full(P, min(Q, 120), np.int32))
        toff = put(rng.integers(0, fm.l_pac, P).astype(np.int64))
        tlen = put(np.full(P, min(T, 150), np.int32))
        h0 = put(np.full(P, 30, np.int32))
        w = put(np.full(P, opt.w, np.int32))
        line("bsw_extend", f"P={P} Q={Q} T={T}", timed(
            dev, lambda: bsw_extend(
                dfm.ref, enc, qoff, one, qlen, toff, one, tlen, h0, w, Q, T,
                *scores, opt.zdrop, opt.pen_clip5, max(opt.a, 1),
                dfm.ref_packed), reps))
    # --- the one-phase rescue kernel, u8, at rescue shapes ---
    for P, Q, T in KSWV_SHAPES:
        qoff = put(rng.integers(0, N * L - 200, P).astype(np.int32))
        one = put(np.ones(P, np.int32))
        qcomp = put(np.zeros(P, bool))
        qlen = put(np.full(P, 151, np.int32))
        toff = put(rng.integers(0, fm.l_pac, P).astype(np.int64))
        tlen = put(np.full(P, min(T, 500), np.int32))
        endsc = put(np.full(P, NO_LIMIT, np.int32))
        live = put(np.ones(P, bool))
        kargs = (dfm.ref, enc, qoff, one, qcomp, qlen, toff, one, tlen,
                 endsc, live, Q, T, opt.min_seed_len * opt.a, *scores,
                 dfm.ref_packed, True)
        work: list = []
        kswv_phase_ref(*kargs, work=work)
        cells, rows = work[0]
        line("kswv_phase", f"u8 P={P} Q={Q} T={T}",
             timed(dev, lambda: kswv_phase(*kargs), reps),
             bound(cells * KSWV_OPS_PER_CELL[True] + rows * 16
                   * KSWV_LAZY_OPS, P * (KSWV_DESC_BYTES + 9 + 24)
                   + int(qlen.sum()) + int(tlen.sum())))
    # --- long-read tiles on the sheared band (no JAX counterpart) ---
    P, qr, Wh = SHEAR_TILE
    q, t, qlen, tlen = shear_tiles(rng, P, qr, dev)
    h0 = put(rng.integers(20, 200, P).astype(np.int32))
    w = put(np.full(P, Wh, np.int32))
    sargs = (q, t, qlen, tlen, h0, w, Wh, *scores, opt.zdrop,
             opt.pen_clip5, max(opt.a, 1))
    ref, enc_t, *desc = _tile_descriptors(q, t, qlen, tlen)
    cells: list = []
    bsw_shear_desc_ref(ref, enc_t, *desc, h0, w, Wh, t.shape[1], *scores,
                       opt.zdrop, opt.pen_clip5, max(opt.a, 1), cells=cells)
    ql, tl = qlen.long(), tlen.long()
    line("bsw_shear_tiles", f"P={P} Q={q.shape[1]} T={t.shape[1]} Wh={Wh}",
         timed(dev, lambda: bsw_shear_tiles(*sargs), reps),
         bound(cells[0] * SHEAR_OPS_PER_CELL,
               P * (SHEAR_DESC_BYTES + SHEAR_OUT_BYTES) + int(ql.sum())
               + int(torch.minimum(tl, ql + Wh + 2).sum())))
    return 0


if __name__ == "__main__":
    sys.exit(main())

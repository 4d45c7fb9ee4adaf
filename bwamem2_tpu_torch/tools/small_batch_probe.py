"""kswv_phase and bsw_shear_tiles of a checkout over a sweep of batch
sizes, to compare two commits' small-batch forms on the same inputs and
card.

    python3 bwamem2_tpu_torch/tools/small_batch_probe.py --root DIR
        [--sizes 64,512,4096,32768] [--reps 5] [--forms] [--plain P]
        [--kswv-b FILE] [--micro SCALE]

Imports bwamem2_tpu_torch from the checkout at --root (this commit's or an
earlier one's) and builds its kswv and bsw_shear libraries afresh in a
temporary directory, so that nvcc's ptxas numbers (registers, spill
bytes, stack frame) of every instantiation are at hand.  On the smoke
genome (benchdata.ensure_genome at scale 0.25, under .tmp/) it makes,
from fixed seeds, for each P of --sizes:
  * kswv_phase batches of P problems in each class, u8 (queries of
    100-160 bases, targets of 150-699, Qmax 160, Tmax 700) and i16
    (250-512 and 300-2048, Qmax 512, Tmax 2048), every third target
    walked backward and every fifth problem not live, with no stop score,
    so that a live problem runs all of its rows and the bound's cells
    follow from the lengths: tlen x NL x ceil(qlen / NL) a live problem,
    NL lazy-F cells a row (csrc/kswv.cu's model);
  * bsw_shear_tiles on P tile pairs of 1-3 kb at Wh 100
    (kernel_micro.shear_tiles), every fourth h0 past 16 bits (both
    bodies); its bound's cells are counted by the plain version, run for
    every P on the card when --forms is given.
Each is timed with CUDA events (after a warm-up, the mean of --reps) in
the form the checkout's planner picks and, with --forms (a checkout whose
wrappers have `split`), in every form the planner allows (kswv_phase S =
1, 2, 4, 8; bsw_shear K = 1, 2), each held equal to the planner's
form; up to --plain problems also to the plain version.  Each output's
md5 lets two checkouts' runs be compared.  --kswv-b FILE times the
two-phase kswv on launches saved by chip_smoke.py (run (b)'s first
chunk, phase 4); --micro SCALE runs the checkout's kernel_micro at that
genome scale.  One JSON line a measurement, each with the card's name and
power limit.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys
import tempfile

import numpy as np

INT32_OPS_PER_S = 132 * 64 * 1.98e9       # H100 SXM INT32 issue rate
HBM_BYTES_PER_S = 3.35e12
KSWV_OPS_PER_CELL, KSWV_LAZY_OPS = {True: 10, False: 9}, 4
KSWV_DESC_BYTES = 25
SHEAR_OPS_PER_CELL, SHEAR_DESC_BYTES, SHEAR_OUT_BYTES = 10, 36, 24
KSWV_CLASSES = (("u8", True, 160, (100, 161), (150, 700), 160, 700),
                ("i16", False, 512, (250, 513), (300, 2049), 512, 2048))
SHEAR_QR, SHEAR_WH = (1000, 3000), 100


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


def md5(t) -> str:
    return hashlib.md5(t.cpu().numpy().tobytes()).hexdigest()


def bound(ops: float, nbytes: float) -> dict:
    o, b = ops / INT32_OPS_PER_S * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return dict(bound_ms=max(o, b), bound_by="operations" if o >= b
                else "bytes")


def ptxas(log: str, pattern: str) -> dict:
    """{kernel entry (mangled): registers, spill, stack} of the entries
    whose name holds `pattern`, from nvcc -Xptxas -v output."""
    import re
    out, cur = {}, None
    for ln in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?(\w+)'?", ln)
        if m:
            cur = out.setdefault(m.group(1), {}) if pattern in m.group(1) \
                else None
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", ln)
        if m:
            cur.update(stack=int(m[1]), spill=int(m[2]) + int(m[3]))
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            cur["registers"] = int(m[1])
    return out


def kswv_inst(log: str, u8: bool, smax: int, S: int,
              kernel: str = "kswv_phase") -> dict:
    """The ptxas numbers of the instantiation a kswv_phase (or kswv) plan
    runs."""
    b = "Lb1E" if u8 else "Lb0E"
    if S > 1:
        key = f"kswv_split_kernelI{b}Li{smax}ELi{S}E"
    else:
        key = f"{kernel}_kernelI{b}Li{smax}E"
    return next((v for k, v in ptxas(log, "kswv").items() if key in k), {})


def shear_inst(log: str, plan: tuple, s16: bool) -> dict:
    if len(plan) > 5 and plan[5] > 1:
        key = f"bsw_shear_blk_kernelILi{plan[5]}ELi{plan[0]}E"
    elif s16:
        key = f"bsw_shear_s16_kernelILi{plan[1]}E"
    else:
        key = f"bsw_shear_kernelILi{plan[0]}E"
    return next((v for k, v in ptxas(log, "bsw_shear").items()
                 if key in k), {})


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", required=True)
    ap.add_argument("--sizes", default="64,512,4096,32768")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--forms", action="store_true")
    ap.add_argument("--plain", type=int, default=512,
                    help="hold kswv_phase to its plain version up to this P")
    ap.add_argument("--kswv-b", default=None)
    ap.add_argument("--micro", type=float, default=None)
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch
    from bwamem2_tpu_torch import benchdata
    from bwamem2_tpu_torch.ops import cuda_build
    from bwamem2_tpu_torch.index.fmindex import FMIndex
    from bwamem2_tpu_torch.ops.bsw import (_tile_descriptors,
                                           bsw_shear_desc_ref,
                                           bsw_shear_tiles)
    from bwamem2_tpu_torch.ops.bsw_shear_cuda import bsw_shear
    from bwamem2_tpu_torch.ops.kswv import NO_LIMIT, kswv_phase_ref
    from bwamem2_tpu_torch.ops.kswv_cuda import kswv, kswv_phase
    from bwamem2_tpu_torch.options import MemOptions
    from bwamem2_tpu_torch.tools.kernel_micro import shear_tiles
    assert bsw_shear.__module__.startswith("bwamem2_tpu_torch")
    if not torch.cuda.is_available():
        raise SystemExit("small_batch_probe: no CUDA device")
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    card = r.stdout.strip().splitlines()[0] if r.returncode == 0 else \
        torch.cuda.get_device_name(0)
    # a fresh build of this checkout's libraries, for their ptxas lines
    cuda_build.BUILD_DIR = tempfile.mkdtemp(
        prefix="probe_build_", dir=os.path.join(os.getcwd(), ".tmp"))
    kswv_phase.lib()
    bsw_shear.lib()
    klog = kswv_phase.build_log or kswv.build_log
    slog = bsw_shear.build_log
    has_split = hasattr(kswv_phase, "split")

    def emit(**kw):
        print(json.dumps(dict(root=args.root, card=card, **kw)), flush=True)

    prefix = benchdata.ensure_genome(
        os.path.join(os.getcwd(), ".tmp", "bench_scale0.25"), 0.25)
    genome = FMIndex.load(prefix).ref_string
    dev = torch.device("cuda")
    ref = torch.from_numpy(genome).to(dev)
    opt = MemOptions().finalize()
    sc = (*opt.mat_scores(), opt.o_del, opt.e_del, opt.o_ins, opt.e_ins)
    minsc = opt.min_seed_len * opt.a
    sizes = [int(x) for x in args.sizes.split(",")]

    # ---- kswv_phase
    for cls, u8, L, qr, tr, Qmax, Tmax in KSWV_CLASSES:
        NL = 16 if u8 else 8
        for P in sizes:
            enc, qoff, qdir, qcomp, qlen, toff, tlen = \
                benchdata.rescue_windows(genome, seed=101 + P, n=P, L=L,
                                         qr=qr, tr=tr, nmut=qr[1] // 40,
                                         n_every=5, plant=11)
            tdir = np.where(np.arange(P) % 3 == 1, -1, 1).astype(np.int32)
            toff = np.where(tdir < 0, toff + tlen - 1, toff).astype(
                np.int64)
            live = np.arange(P) % 5 != 2
            endsc = np.full(P, NO_LIMIT, np.int32)
            x = [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in (
                enc, qoff, qdir, qcomp, qlen, toff, tdir, tlen, endsc, live)]
            kargs = (ref, *x, Qmax, Tmax, minsc, *sc, False, u8)
            rows = int((tlen.astype(np.int64) * live).sum())
            cells = int((tlen.astype(np.int64) * live * NL
                         * -(-qlen.astype(np.int64) // NL)).sum())
            bd = bound(cells * KSWV_OPS_PER_CELL[u8] + rows * NL
                       * KSWV_LAZY_OPS, P * (KSWV_DESC_BYTES + 9 + 24)
                       + int(qlen.sum()) + int(tlen.sum()))
            forms = [0] + ([1, 2, 4, 8] if args.forms and has_split else [])
            want = None
            if P <= args.plain:
                work: list = []
                want = kswv_phase_ref(*kargs, work=work)
                if work[0] != (cells, rows):
                    raise SystemExit(f"kswv_phase {cls} P={P}: plain work "
                                     f"{work[0]} != ({cells}, {rows})")
            first = None
            for s in forms:
                if has_split:
                    kswv_phase.split = s
                try:
                    plan = kswv_phase.plan(P, Qmax, u8, dev)
                except ValueError:
                    continue        # a form this Qmax does not allow
                got = kswv_phase.launch(*kargs)
                first = got if first is None else first
                exact = None if want is None else bool(torch.equal(got,
                                                                   want))
                if not torch.equal(got, first) or exact is False:
                    raise SystemExit(f"kswv_phase {cls} P={P} split={s}: "
                                     "output differs")
                ms = cuda_ms(torch, lambda: kswv_phase.launch(*kargs),
                             args.reps)
                S = plan[3] if len(plan) > 3 else 1
                emit(what="kswv_phase", cls=cls, P=P, Qmax=Qmax, Tmax=Tmax,
                     split=s, plan=list(plan), S=S, ms=ms, cells=cells,
                     rows=rows, **bd, plain_exact=exact, md5=md5(got),
                     **kswv_inst(klog, u8, plan[0], S))
            if has_split:
                kswv_phase.split = 0

    # ---- bsw_shear_tiles
    sct = (*sc, opt.zdrop, opt.pen_clip5, max(opt.a, 1))
    for P in sizes:
        rng = np.random.default_rng(200 + P)
        q, t, qlen, tlen = shear_tiles(rng, P, SHEAR_QR, dev)
        h0 = torch.from_numpy(np.where(np.arange(P) % 4 == 0,
                                       rng.integers(30000, 40000, P),
                                       rng.integers(20, 200, P))
                              .astype(np.int32)).to(dev)
        w = torch.full((P,), SHEAR_WH, dtype=torch.int32, device=dev)
        sargs = (q, t, qlen, tlen, h0, w, SHEAR_WH, *sct)
        ql, tl = qlen.long(), tlen.long()
        nbytes = (P * (SHEAR_DESC_BYTES + SHEAR_OUT_BYTES) + int(ql.sum())
                  + int(torch.minimum(tl, ql + SHEAR_WH + 2).sum()))
        want, bd, cells = None, {}, None
        if args.forms:
            ref_t, enc_t, *desc = _tile_descriptors(q, t, qlen, tlen)
            c: list = []
            want = bsw_shear_desc_ref(ref_t, enc_t, *desc, h0, w, SHEAR_WH,
                                      t.shape[1], *sct, cells=c)
            cells = c[0]
            bd = bound(cells * SHEAR_OPS_PER_CELL, nbytes)
        forms = [0] + ([1, 2] if args.forms and has_split else [])
        for k in forms:
            if has_split:
                bsw_shear.split = k
            n0 = bsw_shear.launches
            got = bsw_shear_tiles(*sargs)
            torch.cuda.synchronize()
            launches = bsw_shear.launches - n0
            if want is not None and not torch.equal(got, want):
                raise SystemExit(f"bsw_shear_tiles P={P} split={k}: output "
                                 "differs from the plain version")
            ms = cuda_ms(torch, lambda: bsw_shear_tiles(*sargs), args.reps)
            plan = bsw_shear.plan(P, SHEAR_WH, dev)
            insts = {"int32": shear_inst(slog, plan, False)}
            if len(plan) <= 5 or plan[5] == 1:
                insts["16-bit"] = shear_inst(
                    slog, bsw_shear.plan(P, SHEAR_WH, dev, True), True)
            emit(what="bsw_shear_tiles", P=P, Wh=SHEAR_WH, split=k,
                 plan=list(plan), launches=launches, ms=ms, cells=cells,
                 **bd, plain_exact=None if want is None else True,
                 md5=md5(got), ptxas=insts)
        if has_split:
            bsw_shear.split = 0

    # ---- the two-phase kswv on saved main-path launches
    if args.kswv_b:
        saved = torch.load(args.kswv_b, weights_only=False)
        for tag, a in saved:
            a = [x.to(dev) if isinstance(x, torch.Tensor) else x for x in a]
            got = kswv.launch(*a)
            ms = cuda_ms(torch, lambda: kswv.launch(*a), args.reps)
            plan = kswv.plan(a[2].shape[0], a[8], a[-1], dev)
            emit(what="kswv", launch=tag, P=int(a[2].shape[0]), Qmax=a[8],
                 Tmax=a[9], plan=list(plan), ms=ms,
                 md5=md5(torch.stack(got)),
                 **kswv_inst(klog, a[-1], plan[0], 1, "kswv"))

    if args.micro is not None:
        from bwamem2_tpu_torch.tools import kernel_micro
        kernel_micro.main(["--scale", str(args.micro), "--reps",
                           str(args.reps)])


if __name__ == "__main__":
    main()

"""Run `mem -x pacbio` (or -x ont2d) of a checkout on a long-read FASTQ,
to compare two commits' long-read path on the same inputs and card.

    python bwamem2_tpu_torch/tools/long_probe.py --root DIR --index PREFIX
        --reads FQ [--preset pacbio] [--band W] [--device cuda] [--shear]

Imports bwamem2_tpu_torch from the checkout at --root (this commit's or an
earlier one's), runs `mem -x PRESET` (with `-w W` when --band is given)
through its CLI entry on cuda (or --device cpu) with every PROF record
set to 0 just before, and prints one JSON line: the card with its power
limit (none on the CPU), the wall seconds, the PROF phase seconds
(extension.bsw among them) and counters, each kernel wrapper's launches
and plain calls, and the md5 of the SAM records (without the header), so
that two checkouts' outputs compare.  With --shear (cuda), the run's
bsw_shear launches are kept per extension call (DeviceBSW._enqueue_long:
one side and band try), and after the run each call's launches are timed
together with CUDA events (after a warm-up, the mean of 3), as is the
call's longest pair launched alone in the body it took, one warp a pair
(its rows, min(tlen, qlen + w + 2), and microseconds a row) and in the
int32 body (its h0 raised by 32,700, past 16 bits, which changes its
scores but not its rows when it runs them all), and the whole call with
every h0 so
raised, all in the int32 body: whatever the checkout's dispatch (a launch
per row rung, or one per body), the same pairs on the same card.
chip_smoke.py's run (d) makes such inputs under .tmp/bench_scale0.25/
(genome.fa, long200.fq).
"""

from __future__ import annotations

import argparse
import hashlib
import importlib
import json
import os
import subprocess
import sys
import tempfile
import time

WRAPPERS = (("ops.bsw_cuda", "bsw_extend"),
            ("ops.bsw_shear_cuda", "bsw_shear"),
            ("ops.seed", "smem_collect"), ("ops.seed", "sa_resolve"),
            ("ops.kswv_cuda", "kswv"))


def cuda_ms(torch, fn, reps: int = 3) -> float:
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


def shear_call(torch, kernel, launches: list) -> dict:
    """One extension call's bsw_shear launches [(args, kwargs)] timed
    together, and its longest pair alone, in its body and in the int32
    body (module docstring)."""
    def run(raise_h0=False):
        for args, kw in launches:
            if raise_h0:
                args = (*args[:8], args[8] + 32700, *args[9:])
                kw = {"n16": 0} if "n16" in kw else {}
            kernel.launch(*args, **kw)

    best = None
    for args, kw in launches:
        rows = torch.minimum(args[7].long(), args[4].long()
                             + args[9].long() + 2)
        j = int(rows.argmax())
        if best is None or int(rows[j]) > best[0]:
            best = (int(rows[j]), args, kw, j)
    rows, args, kw, j = best
    one = (*args[:2], *(t[j:j + 1] for t in args[2:10]), *args[10:])
    big = (*one[:8], one[8] + 32700, *one[9:])
    # a checkout with two bodies takes n16, the pairs in the 16-bit one
    kw1 = {"n16": int(j < kw["n16"])} if "n16" in kw else {}
    kw32 = {"n16": 0} if "n16" in kw else {}
    us = lambda ms: ms * 1e3 / rows  # noqa: E731
    # a lone pair in one warp, as a checkout without the split-band form
    # runs it (a checkout with it would give a lone pair that form)
    split = getattr(kernel, "split", None)
    if split is not None:
        kernel.split = 1
    try:
        one_ms = cuda_ms(torch, lambda: kernel.launch(*one, **kw1))
        one32_ms = cuda_ms(torch, lambda: kernel.launch(*big, **kw32))
    finally:
        if split is not None:
            kernel.split = split
    return dict(Wh=args[10], launches=len(launches),
                pairs=sum(a[2].shape[0] for a, _ in launches),
                ms=cuda_ms(torch, run),
                ms_int32=cuda_ms(torch, lambda: run(True)), longest_rows=rows,
                longest_ms=one_ms, longest_us_per_row=us(one_ms),
                longest_body=("16-bit" if kw1.get("n16") else "int32"),
                us_per_row_int32=us(one32_ms))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", required=True)
    ap.add_argument("--index", required=True)
    ap.add_argument("--reads", required=True)
    ap.add_argument("--preset", default="pacbio")
    ap.add_argument("--band", type=int, default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--shear", action="store_true")
    a = ap.parse_args()
    root = os.path.abspath(a.root)
    sys.path.insert(0, root)
    import torch
    cuda = a.device == "cuda"
    if cuda and not torch.cuda.is_available():
        sys.exit("long_probe: no CUDA device")
    from bwamem2_tpu_torch import cli
    from bwamem2_tpu_torch.utils.profiling import PROF
    kernels = {}
    for mod, name in WRAPPERS:    # an earlier checkout may lack one
        try:
            kernels[name] = getattr(
                importlib.import_module(f"bwamem2_tpu_torch.{mod}"), name)
        except (ImportError, AttributeError):
            continue
    card = None
    if cuda:
        for k in kernels.values():
            k.lib()               # builds outside the timed run
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True,
                              text=True).stdout.strip().splitlines()[0]
    for d in (PROF.t, PROF.n, PROF.c, PROF.ctot):
        d.clear()
    for k in kernels.values():
        k.reset()
    calls: list = []        # per extension call: its bsw_shear launches
    if a.shear:
        from bwamem2_tpu_torch.ops.bsw import DeviceBSW
        shear = kernels["bsw_shear"]
        enqueue, launch = DeviceBSW._enqueue_long, type(shear).launch

        def spy_enqueue(self, *args, **kw):
            calls.append([])
            return enqueue(self, *args, **kw)

        def spy_launch(self, *args, **kw):
            calls[-1].append((args, kw))
            return launch(self, *args, **kw)

        DeviceBSW._enqueue_long = spy_enqueue
        type(shear).launch = spy_launch
    with tempfile.TemporaryDirectory() as tmp:
        sam = os.path.join(tmp, "out.sam")
        t0 = time.perf_counter()
        band = [] if a.band is None else ["-w", str(a.band)]
        rc = cli.main(["mem", "--device", a.device, "-x", a.preset, *band,
                       "-v", "1", "-o", sam, a.index, a.reads])
        if cuda:
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        with open(sam, "rb") as f:
            body = b"".join(ln for ln in f if not ln.startswith(b"@"))
    shear_calls = None
    if a.shear:
        DeviceBSW._enqueue_long = enqueue
        type(shear).launch = launch
        shear_calls = [shear_call(torch, shear, c) for c in calls if c]
    print(json.dumps(dict(
        root=root, card=card, rc=rc, preset=a.preset, band=a.band,
        wall_s=round(wall, 3),
        phases_s={k: round(v, 3) for k, v in sorted(PROF.t.items())},
        counters={k: [PROF.c[k], PROF.ctot[k]] for k in sorted(PROF.c)},
        launches={n: k.launches for n, k in kernels.items()},
        plain_calls={n: k.plain_calls for n, k in kernels.items()},
        sam_md5=hashlib.md5(body).hexdigest(), shear_calls=shear_calls,
        shear_ms=(sum(c["ms"] for c in shear_calls) if shear_calls
                  else None))), flush=True)


if __name__ == "__main__":
    main()

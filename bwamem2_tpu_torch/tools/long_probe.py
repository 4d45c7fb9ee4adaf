"""Run `mem -x pacbio` (or -x ont2d) of a checkout on a long-read FASTQ,
to compare two commits' long-read path on the same inputs and card.

    python bwamem2_tpu_torch/tools/long_probe.py --root DIR --index PREFIX
        --reads FQ [--preset pacbio] [--device cuda]

Imports bwamem2_tpu_torch from the checkout at --root (this commit's or an
earlier one's), runs `mem -x PRESET` through its CLI entry on cuda (or
--device cpu) with every PROF record set to 0 just before, and prints one
JSON line: the card with its power limit (none on the CPU), the wall
seconds, the PROF phase seconds (extension.bsw among them) and counters,
each kernel wrapper's launches and plain calls, and the md5 of the SAM
records (without the header), so that two checkouts' outputs compare.
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


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", required=True)
    ap.add_argument("--index", required=True)
    ap.add_argument("--reads", required=True)
    ap.add_argument("--preset", default="pacbio")
    ap.add_argument("--device", default="cuda")
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
    with tempfile.TemporaryDirectory() as tmp:
        sam = os.path.join(tmp, "out.sam")
        t0 = time.perf_counter()
        rc = cli.main(["mem", "--device", a.device, "-x", a.preset, "-v",
                       "1", "-o", sam, a.index, a.reads])
        if cuda:
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        with open(sam, "rb") as f:
            body = b"".join(ln for ln in f if not ln.startswith(b"@"))
    print(json.dumps(dict(
        root=root, card=card, rc=rc, preset=a.preset, wall_s=round(wall, 3),
        phases_s={k: round(v, 3) for k, v in sorted(PROF.t.items())},
        counters={k: [PROF.c[k], PROF.ctot[k]] for k in sorted(PROF.c)},
        launches={n: k.launches for n, k in kernels.items()},
        plain_calls={n: k.plain_calls for n, k in kernels.items()},
        sam_md5=hashlib.md5(body).hexdigest())), flush=True)


if __name__ == "__main__":
    main()

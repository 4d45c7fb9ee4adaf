"""Readings for the check's limits: the program's numbers and the
control's on many seeds, in one process (set-up once).

    python3 portbench/calibrate.py --workload <cell> --seeds 1,2,3
        --seconds <s> [--out calib.json]

For each seed: one window of the cell at its own load, then the check of
that window's sample, once on the program's SAM records and rescue scores
and once with the control in the program's place: the plain reference
computed with 8-bit saturating scores (`bench.CONTROL_BITS`).  Both go
through `bench.verdict` against the cell's limits, so each row says
whether the program and the control come out `correct`.  A limit lies
above every sound reading and below the control's smallest.  Prints a
JSON line per seed and writes them all to --out.
"""

import os
import sys
import time

T0 = time.perf_counter()
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

# run.py's caches and host thread settings, as in a timed run
from portbench.run import ROOT  # noqa: E402


def main(argv=None) -> int:
    import argparse
    import json
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda:0")
    a = ap.parse_args(argv)
    from portbench.bench import Setup, check, load_cell, run_window, \
        verdict
    c = load_cell(a.workload, ROOT)
    s = Setup(c, a.device, T0)
    rows = []
    for seed in (int(x) for x in a.seeds.split(",")):
        w = run_window(s, seed, a.seconds, False)
        t = time.perf_counter()
        prog = check(s, w, seed)
        t_check = time.perf_counter() - t
        ctrl = check(s, w, seed, control=True)
        lim = c.limits["limits"]
        ok, _ = verdict(prog, lim)
        row = {"seed": seed, "reads": w.reads, "seconds": w.seconds,
               "reads_per_s": w.reads_per_s, "failed": w.failed,
               "program": prog, "control": ctrl, "check_s": t_check,
               "program_correct": ok and w.failed == 0,
               "control_correct": verdict(ctrl, lim)[0]}
        rows.append(row)
        print(json.dumps(row), flush=True)
    if a.out:
        os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
        with open(a.out, "w") as f:
            json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Count bsw_shear's SASS instructions per frame slot, for two checkouts.

    python3 bwamem2_tpu_torch/tools/shear_sass.py [--root DIR ...]

For each checkout (this one by default), compiles its
bwamem2_tpu_torch/csrc/bsw_shear.cu for sm_90a into a cubin (with
-DSHEAR_SASS_PROBE, which adds one kernel per body of
csrc/shear_group.cuh at two slot counts; an earlier checkout's
bsw_shear_kernel<C> are its bodies), disassembles it with cuobjdump -sass
and counts the instructions of each kernel's row loop: the span of its
widest backward branch, NOPs left out.  A body's instructions per slot are
the slope between its two slot counts (the per-row work that does not grow
with the slots cancels out): int32 C 7 -> 13, 16-bit R 4 -> 7 registers
(two slots each).  With each body's registers at each slot count (ptxas -v).
Prints one JSON line per checkout.  Needs nvcc and cuobjdump (the
CUDA toolkit); no card.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(HERE))

# (body, mangled kernel name pattern, slots per template step): the
# probe kernels and an earlier checkout's kernel
BODIES = (
    ("int32", r"shear_probe_i32ILi(\d+)EE", 1),
    ("16-bit", r"shear_probe_s16ILi(\d+)EE", 2),
    ("int32 (bsw_shear_kernel<C>)", r"bsw_shear_kernelILi([1-9]\d*)EE[Ev]", 1),
)


def nvcc_tools() -> tuple[str, str]:
    sys.path.insert(0, REPO)
    from bwamem2_tpu_torch.ops.cuda_build import _nvcc
    nvcc = _nvcc()
    return nvcc, os.path.join(os.path.dirname(nvcc), "cuobjdump")


def loop_counts(sass: str) -> dict:
    """{function: instructions in its widest backward branch's span}."""
    out, name, ins = {}, None, []

    def close():
        if name is None:
            return
        addr = {a: i for i, (a, _) in enumerate(ins)}
        best = None
        for i, (a, text) in enumerate(ins):
            m = re.search(r"\bBRA\b.*?0x([0-9a-f]+)", text)
            if m and int(m[1], 16) < a and int(m[1], 16) in addr:
                lo = addr[int(m[1], 16)]
                if best is None or i - lo > best[1] - best[0]:
                    best = (lo, i)
        if best:
            out[name] = sum(1 for _, t in ins[best[0]:best[1] + 1]
                            if not t.startswith("NOP"))
    for ln in sass.splitlines():
        m = re.match(r"\s*Function : (\S+)", ln)
        if m:
            close()
            name, ins = m[1], []
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", ln)
        if m and name:
            ins.append((int(m[1], 16), m[2].strip()))
    close()
    return out


def count(root: str, nvcc: str, cuobjdump: str) -> dict:
    src = os.path.join(root, "bwamem2_tpu_torch", "csrc", "bsw_shear.cu")
    with tempfile.TemporaryDirectory() as tmp:
        cubin = os.path.join(tmp, "bsw_shear.cubin")
        r = subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
                            "-std=c++17", "-O3", "-cubin",
                            "-DSHEAR_SASS_PROBE", "-Xptxas", "-v", "-o",
                            cubin, src], check=True, capture_output=True,
                           text=True)
        sass = subprocess.run([cuobjdump, "-sass", cubin], check=True,
                              capture_output=True, text=True).stdout
    loops = loop_counts(sass)
    regs, cur = {}, None
    for ln in (r.stdout + r.stderr).splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        cur = m[1] if m else cur
        m = re.search(r"Used (\d+) registers", ln)
        if m and cur:
            regs[cur] = int(m[1])
    res = {"root": root, "row_loop_instructions": {}, "per_slot": {},
           "registers": {}}
    for body, pat, per_step in BODIES:
        pts, rg = {}, {}
        for fn, n in loops.items():
            m = re.search(pat, fn)
            if m:
                pts[int(m[1])] = n
                rg[m[1]] = regs.get(fn)
        if len(pts) < 2:
            continue
        res["row_loop_instructions"][body] = {str(k): v for k, v in
                                              sorted(pts.items())}
        (a, na), (b, nb) = sorted(pts.items())[:2]
        res["per_slot"][body] = round((nb - na) / ((b - a) * per_step), 2)
        res["registers"][body] = rg
    return res


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", action="append",
                    help="a checkout (repeatable); default this one")
    a = ap.parse_args()
    nvcc, cuobjdump = nvcc_tools()
    for root in a.root or [REPO]:
        print(json.dumps(count(os.path.abspath(root), nvcc, cuobjdump)),
              flush=True)


if __name__ == "__main__":
    main()

"""Time the seeding kernels smem_collect and sa_resolve of a checkout on one
default-size chunk, to compare two commits' kernels on the same inputs and
card.

    python bwamem2_tpu_torch/tools/seed_probe.py --root DIR [--scale 2.0]
        [--data DIR] [--reps 3] [--pairs 35000] [--task-bases 10000000]
        [--walk] [--stages]

Imports bwamem2_tpu_torch from the checkout at --root (this commit's or an
earlier one's whose smem_collect takes per-read slot offsets), makes or
reuses the benchdata genome of --scale (2.0: 93.4 Mbp, an occ table beyond
the H100's 50 MB L2) with 35,000 2x150 pairs under --data, takes the first
chunk at the CLI's default task size (10 Mbp: 66,668 reads), and prints
one JSON line: the card with its power limit, the reads, the backward_ext
calls and smem_collect's CUDA-event milliseconds, then the chunk's
max_occ-sampled SA positions (FusedSeeder's compaction of that output) and
sa_resolve's milliseconds on them, each the mean of --reps launches after
a warm-up.  --pairs and --task-bases pick another chunk (chip_smoke.py's
run (a): --scale 0.25 --pairs 10000 --task-bases 2250000).  --walk also
times the round-1 walk kernels on the chunk (the checkout must have them):
round1_walk (the seed-extend step's) over the replicated index and over
the index in 2 shards on the card, and round1_compact (the legacy round
1) at the index's K-mer depth (index/klut.py:default_k) and at K = 0,
with the registers, stack frame and spill of each instantiation where
this process built the library, and each instantiation's SASS
instructions and the order of its 16-byte loads and popcounts (from a
cubin of the checkout's source).  --stages seeds the
chunk through a TorchBackend over the index in 2 shards on the card (the
sharded index's per-stage seeding, as chip_smoke.py's run (g)), captures
its round1_chain, round2_forward, round2_backward (both entries) and
round3_replay launches, and times each again (the mean of --reps after a
warm-up), per launch and summed per kernel, with a digest of the captured
inputs (two checkouts that compute the same outputs time the same
launches), each round-2 kernel's longest walk launched alone (its steps,
milliseconds and microseconds a step: the latency of one step), and for
round1_chain and round3_replay every launch held against the checkout's
plain version and, where that plain version names the read with the
longest chain (`longest_read`), that read launched alone (its dependent
loads, milliseconds and microseconds a load), with the registers, stack
frame and spill ptxas gave each stage kernel's instantiations where this
process built them.
Run (a)'s chunk, parent, change, change, parent in one call:

    python bwamem2_tpu_torch/tools/seed_probe.py --root DIR \
        --data .tmp/bench_scale0.25 --scale 0.25 --pairs 10000 \
        --task-bases 2250000 --stages --reps 5

(--walk in place of --stages for the round-1 walk kernels).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", required=True)
    ap.add_argument("--scale", type=float, default=2.0)
    ap.add_argument("--data", default=None)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--pairs", type=int, default=35_000)
    ap.add_argument("--task-bases", type=int, default=10_000_000)
    ap.add_argument("--walk", action="store_true")
    ap.add_argument("--stages", action="store_true")
    a = ap.parse_args()
    root = os.path.abspath(a.root)
    sys.path.insert(0, root)
    import torch
    if not torch.cuda.is_available():
        sys.exit("seed_probe: no CUDA device")
    from bwamem2_tpu_torch import benchdata
    from bwamem2_tpu_torch.align.seeding import encode_reads
    from bwamem2_tpu_torch.index.fmindex import FMIndex
    from bwamem2_tpu_torch.io.fastq import FastxReader, read_chunk
    from bwamem2_tpu_torch.ops import seed
    from bwamem2_tpu_torch.ops.backend import _pad_reads
    from bwamem2_tpu_torch.ops.device_index import DeviceFMIndex
    from bwamem2_tpu_torch.options import MemOptions
    data = a.data or os.path.join(root, ".tmp", f"bench_scale{a.scale}")
    prefix, fq1, fq2 = benchdata.ensure(data, a.scale, a.pairs)
    fm = FMIndex.load(prefix)
    reads = read_chunk(FastxReader(fq1), FastxReader(fq2), a.task_bases)
    enc, lens = _pad_reads(encode_reads([r.seq for r in reads]))
    dfm = DeviceFMIndex.from_host(fm, "cuda")
    e, ln = torch.from_numpy(enc).cuda(), torch.from_numpy(lens).cuda()
    opt = MemOptions().finalize()
    N, L = enc.shape
    split_len = int(opt.min_seed_len * opt.split_factor + 0.499)
    off = seed.slot_offsets(ln)
    args = (dfm, e, ln, opt.min_seed_len, split_len, int(opt.split_width),
            int(opt.max_mem_intv), seed.list_cap(L), off)
    sa = seed.sa_resolve
    if hasattr(sa, "shape_for"):
        W, threads = sa.shape_for(0)
        sa_design = f"{W} walks per lane, {threads} threads per block"
    else:
        sa_design = "one thread per position"

    def timed(fn) -> float:
        fn()
        torch.cuda.synchronize()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(a.reps):
            fn()
        e1.record()
        torch.cuda.synchronize()
        return e0.elapsed_time(e1) / a.reps

    out = seed.smem_collect(*args)
    sm_ms = timed(lambda: seed.smem_collect(*args))
    pos = seed.compact_and_expand(*out[:5], off, int(opt.max_occ))[3]
    sa_ms = timed(lambda: sa(dfm, pos))
    walk = walk_kernels(fm, prefix, dfm, e, ln, timed) if a.walk else {}
    stages = (stage_launches(fm, opt, reads, timed, torch.device("cuda", 0))
              if a.stages else {})
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    print(json.dumps(dict(
        root=root, card=card, scale=a.scale, l_pac=int(fm.l_pac), reads=N,
        L=L, lanes=seed.smem_collect.lanes_for(N),
        bwd_ext=int(out[5].sum()), overflowed=int((out[4] < 0).sum()),
        smem_collect_ms=sm_ms, positions=int(pos.numel()),
        sa_design=sa_design, sa_resolve_ms=sa_ms, **walk, **stages)),
        flush=True)


def walk_kernels(fm, prefix: str, dfm, e, ln, timed) -> dict:
    """round1_walk on the chunk over the replicated index and over the
    index in 2 shards on the same card, and round1_compact (the legacy
    round 1, min_seed_len 19, 24 slots a read) at K = default_k (the index
    with its K-mer table) and at K = 0, each timed; with the registers,
    stack frame and spill ptxas gave each instantiation where this
    process built the library, and each instantiation's SASS (sass_order)."""
    from bwamem2_tpu_torch.index.klut import load_or_build_klut
    from bwamem2_tpu_torch.ops.device_index import DeviceFMIndex
    from bwamem2_tpu_torch.ops.smem import round1_compact, round1_walk
    from bwamem2_tpu_torch.parallel.shard_index import shard_index
    walk = {"round1_walk_ms": timed(lambda: round1_walk(dfm, e, ln))}
    two = shard_index(dfm, [dfm.device, dfm.device])[0]
    walk["round1_walk_2shards_ms"] = timed(lambda: round1_walk(two, e, ln))
    lut = load_or_build_klut(fm, prefix)
    dl = DeviceFMIndex.from_host(fm, dfm.device, lut)
    for K in (lut[0], 0):
        walk[f"round1_compact_K{K}_ms"] = timed(
            lambda: round1_compact(dl, e, ln, K, 19, 24))
    for name, kern, names in (
            ("round1_walk", round1_walk, ("FmView", "FmShardView")),
            ("round1_compact", round1_compact, ("noLUT", "LUT"))):
        for view, (reg, stack, spill) in ptxas(kern, names).items():
            walk[f"{name}_registers_{view}"] = reg
            walk[f"{name}_stack_{view}"] = stack
            walk[f"{name}_spill_{view}"] = spill
        for view, (n, order) in sass_order(name, names).items():
            walk[f"{name}_sass_{view}"] = n
            walk[f"{name}_order_{view}"] = order
    return walk


def sass_order(name: str, names: tuple) -> dict:
    """{instantiation: (SASS instructions, order)} of csrc/`name`.cu,
    compiled to a cubin for sm_90a (nvcc -cubin) and read by cuobjdump
    -sass; `order` is the kernel's 16-byte global loads and popcounts in
    address order (L a load, l a predicated load, p a popcount): whether a
    step issues its rows' loads before it counts.  Instantiations are
    named as ptxas() names them."""
    import re
    import tempfile
    from bwamem2_tpu_torch.ops.cuda_build import CSRC, _nvcc
    with tempfile.TemporaryDirectory() as d:
        cubin = os.path.join(d, name + ".cubin")
        subprocess.run([_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                        "-std=c++17", "-O3", "-cubin", "-o", cubin,
                        os.path.join(CSRC, name + ".cu")], check=True,
                       capture_output=True)
        text = subprocess.run([os.path.join(os.path.dirname(_nvcc()),
                                            "cuobjdump"), "-sass", cubin],
                              check=True, capture_output=True,
                              text=True).stdout
    out, fn, body = {}, None, []

    def close():
        if fn:
            order = "".join(("l" if ins.startswith("@") else "L")
                            if "LDG.E.128" in ins else "p" for ins in body
                            if "LDG.E.128" in ins or "POPC" in ins)
            out[names[1] if re.search(r"IL[ib]1E", fn) else names[0]] = (
                len(body), order)

    for ln in text.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            close()
            fn, body = m[1], []
            continue
        m = re.match(r"\s+/\*[0-9a-f]{4}\*/\s+(.*?)\s*;", ln)
        if m and fn:
            body.append(m[1])
    close()
    return out


def ptxas(kernel, names: tuple = ("FmView", "FmShardView")) -> dict:
    """{instantiation: [registers, stack bytes, spill bytes]} of a kernel's
    two instantiations from its build log (empty where the library was
    built before this process): names[1] is the one whose template
    argument is 1 or true (FmShardView; round1_compact's LUT)."""
    import re
    out, view = {}, None
    for ln in kernel.build_log.splitlines():
        m = re.search(r"Function properties for (\w+)|(\d+) bytes stack "
                      r"frame, (\d+) bytes spill stores|Used (\d+) "
                      r"registers", ln)
        if m and m[1]:
            view = names[1] if re.search(r"IL[ib]1E", m[1]) else names[0]
            out.setdefault(view, [0, 0, 0])
        elif m and m[2] and view:
            out[view][1:] = [int(m[2]), int(m[3])]
        elif m and m[4] and view:
            out[view][0] = int(m[4])
    return out


def stage_launches(fm, opt, reads, timed, dev) -> dict:
    """The per-stage seeding launches of the chunk `reads` through a
    TorchBackend over the index in 2 shards on device `dev`, captured at the
    wrappers and each timed again: {"stages": {kernel: {launches, ms,
    per_launch, ...}}, "stages_digest": sha1 of the captured inputs}."""
    import hashlib
    import torch
    from bwamem2_tpu_torch.align.seeding import encode_reads
    from bwamem2_tpu_torch.ops import smem
    from bwamem2_tpu_torch.ops.backend import TorchBackend
    be = TorchBackend(fm, opt, devices=[dev, dev], sharded=True)
    kern = {"round1_chain": smem.round1_chain,
            "round2_forward": smem.round2_forward,
            "round2_backward": smem.round2_backward,
            "round3_replay": smem.round3_replay}
    methods = [(n, "launch") for n in kern] + [("round2_backward",
                                                "resume")]
    calls = []
    orig = {(n, m): getattr(type(kern[n]), m) for n, m in methods}

    def spy_for(n, m):
        def spy(self, *args):
            calls.append((n, m, args))
            return orig[n, m](self, *args)
        return spy

    for n, m in methods:
        setattr(type(kern[n]), m, spy_for(n, m))
    try:
        be.collect_smems(encode_reads([r.seq for r in reads]), opt)
    finally:
        for (n, m), fn in orig.items():
            setattr(type(kern[n]), m, fn)
    # the cards' threads launch in either order: calls in the order of
    # their inputs' digests, the digest over those
    def digest(args) -> str:
        h = hashlib.sha1()
        for x in args:
            if isinstance(x, torch.Tensor):
                h.update(x.cpu().numpy().tobytes())
            elif isinstance(x, int):
                h.update(str(x).encode())
        return h.hexdigest()

    calls = sorted(((n, m, digest(args), args) for n, m, args in calls),
                   key=lambda c: c[:3])
    h = hashlib.sha1("".join(c[2] for c in calls).encode())
    out: dict = {}
    plain = {"round1_chain": smem.round1_chain_ref,
             "round3_replay": smem.round3_replay_ref}
    for n, m, _, args in calls:
        ms = timed(lambda: getattr(kern[n], m)(*args))
        r = out.setdefault(n, dict(launches=0, ms=0.0, per_launch=[]))
        r["launches"] += 1
        r["ms"] += ms
        r["per_launch"].append(ms)
        if n in plain:
            st: dict = {}
            got, want = kern[n](*args), plain[n](*args, st)
            r["exact"] = r.get("exact", True) and all(
                torch.equal(g.long(), w.long()) for g, w in zip(got, want))
            i = st.get("longest_read")
            if i is not None and st["longest"] > r.get("one_chain_loads", 0):
                # the launch's longest chain alone: one read of it
                one = (args[0], args[1][i:i + 1], args[2][i:i + 1]) \
                    + args[3:]
                r["one_chain_loads"] = st["longest"]
                r["one_chain_ms"] = timed(lambda: kern[n](*one))
                r["us_per_load"] = 1e3 * r["one_chain_ms"] / st["longest"]
            r["ptxas"] = ptxas(kern[n])
        if n.startswith("round2"):
            r["ptxas"] = ptxas(kern[n])
            steps, one = longest_walk(n, m, args, getattr(kern[n], m))
            if steps > r.get("one_walk_steps", 0):
                r["one_walk_steps"] = steps
                r["one_walk_ms"] = timed(lambda: getattr(kern[n], m)(*one))
                r["us_per_step"] = 1e3 * r["one_walk_ms"] / steps
    return dict(stages=out, stages_digest=h.hexdigest())


def longest_walk(n: str, m: str, args: tuple, fn) -> tuple:
    """(steps, wrapper args) of a launch of the captured launch `args`'s
    longest walk alone: a backward lane's steps are its output column
    less its start; a forward pivot's walk is at least its last
    candidate's end offset."""
    if n == "round2_forward":
        cn, _, _, _, nc = fn(*args)
        p = int(cn.max(1).values.argmax())
        return (int(cn[p].max()), (args[0], args[1])
                + tuple(a[p:p + 1] for a in args[2:5]) + args[5:])
    col = fn(*args)[0].long()
    if m == "launch":
        i = int(col.argmax())
        return (int(col[i]), args[:6] + tuple(a[i:i + 1] for a in args[6:8])
                + args[8:])
    i = int((col - args[5].long()).argmax())
    return (int(col[i] - args[5][i]), args[:2]
            + tuple(a[i:i + 1] for a in args[2:8]) + args[8:])


if __name__ == "__main__":
    main()

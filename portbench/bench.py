"""The benchmark's core: set-up, the measured window, the check, the
result line.  `run.py` is its command line.

Everything is found by name: the cell in `BENCHMARK.json`, its
configuration (`configs/<config>.json`), its traffic mix
(`traffic/<mix>.json`), its limits (`cells/<cell>.json`) and each metric's
reader (`metrics/<metric>.py`).  Adding a cell, a configuration, a mix or
a metric adds files and `BENCHMARK.json` entries and edits none.

Set-up (all of it counts in `setup_s`): the genome and index from the
configuration's own seed, made once per checkout (`genome.py`); the
kernel libraries; the index loaded and put on the card; the `Aligner` built
as `bwamem2_tpu_torch.cli`'s `mem` builds it from the configuration's
flags; the read stream started from `--seed`; and the pipeline's first
`workers + 1` chunks, which warm every worker and every shape the traffic
uses.  The window (`window.py`) then opens with every worker busy.  As
it runs, `RescueTap` keeps the mate-rescue problems posed for the pairs
the check may sample, with the scores the program gave them.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import os
import sys
import tempfile
import threading
from types import SimpleNamespace

import numpy as np

from portbench import genome as genome_mod
from portbench.guard import forbidden_modules
from portbench.reference.check import judge
from portbench.stream import ReadStream, rc_codes, seed_words
from portbench.window import SamSink, idle_gaps, prof_delta, rate, \
    union_seconds

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
CONTROL_BITS = 8            # the control's arithmetic (reference/sw.py)


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(name: str, root: str = ROOT) -> SimpleNamespace:
    """The cell `name` of root/BENCHMARK.json with its files."""
    spec = _json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    cfgs = {c["name"]: c for c in spec["configs"]}
    bench = os.path.join(root, "portbench")
    return SimpleNamespace(
        name=name, spec=spec, cell=cell, chips=int(cell["chips"]),
        config=_json(os.path.join(root, cfgs[cell["config"]]["file"])),
        traffic=_json(os.path.join(bench, "traffic",
                                   cell["traffic"] + ".json")),
        limits=_json(os.path.join(bench, "cells", name + ".json")),
        bench=bench)


def metric_names(c, trace: bool) -> list[str]:
    """The cell's metrics: end-to-end untraced, per-layer traced (those
    that list no workloads apply to every cell)."""
    key = "per_layer" if trace else "end_to_end"
    return [m["name"] for m in c.spec[key]
            if c.name in m.get("workloads", [c.name])]


def load_reader(bench: str, name: str):
    path = os.path.join(bench, "metrics", name + ".py")
    sp = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(sp)
    sp.loader.exec_module(mod)
    return mod.read


def units(c) -> dict:
    return {m["name"]: m["unit"] for k in ("end_to_end", "per_layer")
            for m in c.spec[k]}


class RescueTap:
    """Keeps, as the window runs, every mate-rescue problem that a chunk
    poses for a fragment the check may sample (every `every`-th), with the
    score the program's rescue kernel gave it, for `reference.check` to
    judge.  It wraps the aligner's `process` (to know the chunk's reads)
    and its backend's `rescue_batch` (the problems and their scores),
    and changes neither's result."""

    def __init__(self, aligner):
        self.every = 1
        self.rows: list[tuple] = []
        self.local = threading.local()
        process = aligner.process

        def tapped_process(reads, n_processed, pes0=None):
            self.local.reads = reads
            return process(reads, n_processed, pes0=pes0)
        aligner.process = tapped_process
        be = aligner.backend
        batch = getattr(be, "rescue_batch", None)
        if batch is None:
            return

        def tapped_batch(desc):
            res = batch(desc)
            if res is not None:
                self.note(desc, res, be.read_grid_width())
            return res
        be.rescue_batch = tapped_batch

    def start(self, every: int) -> None:
        self.every = every
        self.rows = []

    def note(self, desc: dict, res: np.ndarray, width: int) -> None:
        """The chunk's reads are consecutive pairs, mate 1 then mate 2."""
        reads = self.local.reads
        qlen = np.asarray(desc["qlen"], np.int64)
        qoff = np.asarray(desc["qoff"], np.int64)
        row = (qoff - np.where(np.asarray(desc["qdir"]) < 0, qlen - 1, 0)
               ) // width
        frag = int(reads[0].name) + row // 2
        for j in np.flatnonzero(frag % self.every == 0).tolist():
            self.rows.append((int(frag[j]), int(row[j] & 1),
                              bool(desc["qcomp"][j]), int(desc["toff"][j]),
                              int(desc["tlen"][j]), int(res[j, 0])))


class Setup:
    """Everything made before a window: the index, the aligner, the
    genome's codes.  Reused by several windows in `calibrate.py`."""

    def __init__(self, c, device: str, t0: float):
        import torch
        from bwamem2_tpu_torch.align.pipeline import Aligner
        from bwamem2_tpu_torch.cli import parse_mem_args
        from bwamem2_tpu_torch.index.fmindex import FMIndex
        from bwamem2_tpu_torch.ops.backend import TorchBackend
        from bwamem2_tpu_torch.options import MEM_F_PE
        self.c = c
        self.t0 = t0
        cfg = c.config
        self.dev = torch.device(device)
        gspec = dict(cfg["genome"], length=int(cfg["genome_length"]))
        g = genome_mod.ensure(gspec, log)
        self.built = g["built"]
        self.codes = np.load(g["codes"], mmap_mode="r")
        self.contig = gspec.get("contig", "chr1s")
        if self.dev.type == "cuda":
            self._build_kernels()
        self.workers = int(cfg["workers"])
        self.task_size = int(cfg["chunk_bases"])
        argv = list(cfg["mem_args"]) + ["-t", str(self.workers), "-K",
                                         str(self.task_size), g["prefix"],
                                         "reads"]
        opt, mode = parse_mem_args(argv)[:2]
        opt.finalize(mode)
        opt.flag |= MEM_F_PE                # the traffic is read pairs
        self.scoring = {"a": opt.a, "b": opt.b, "o_del": opt.o_del,
                        "e_del": opt.e_del, "o_ins": opt.o_ins,
                        "e_ins": opt.e_ins}
        self.fm = FMIndex.load(g["prefix"])
        self.aligner = Aligner(self.fm, opt, backend=TorchBackend(
            self.fm, opt, device=self.dev), verbose=1)
        self.rescue = RescueTap(self.aligner)

    @staticmethod
    def _build_kernels() -> None:
        """Build (first run) or load the kernel libraries of `mem`, so that
        none loads inside the window."""
        from concurrent.futures import ThreadPoolExecutor
        from bwamem2_tpu_torch.ops.bsw_cuda import bsw_extend
        from bwamem2_tpu_torch.ops.bsw_shear_cuda import bsw_shear
        from bwamem2_tpu_torch.ops.kswv_cuda import kswv
        from bwamem2_tpu_torch.ops.seed import sa_resolve, smem_collect
        with ThreadPoolExecutor(5) as pool:
            list(pool.map(lambda k: k.lib(), (bsw_extend, bsw_shear, kswv,
                                              sa_resolve, smem_collect)))

    def free(self) -> None:
        """Drop the program's state (before the reference runs)."""
        self.aligner = self.fm = None
        gc.collect()
        if self.dev.type == "cuda":
            import torch
            torch.cuda.empty_cache()


def run_window(s: Setup, seed: int, seconds: float, trace: bool):
    """One window over a fresh stream from `seed`; returns its record."""
    import torch
    from bwamem2_tpu_torch.io.fastq import Read
    from bwamem2_tpu_torch.io.sam import pg_line, sam_header
    from bwamem2_tpu_torch.runtime import run_pipeline
    from bwamem2_tpu_torch.utils.profiling import PROF
    c = s.c
    every = int(c.traffic.get("check_every", 1))
    stream = ReadStream(s.codes, c.traffic, seed, s.task_size,
                        lambda n, q, ql: Read(n, None, q, ql))
    s.rescue.start(every)
    tracer = None
    if trace:
        from portbench.trace import DeviceTrace
        tracer = DeviceTrace(s.dev)
    fd, path = tempfile.mkstemp(suffix=".sam")
    try:
        with os.fdopen(fd, "w") as f:
            f.write(sam_header(s.fm, None, pg_line(
                ["portbench", c.name], "bench")))
            sink = SamSink(f, stream, s.workers, seconds, PROF,
                           keep=lambda i: (i // 2) % every == 0,
                           on_edge=tracer.mark if tracer else None)
            ks1, ks2 = stream.mates()
            run_pipeline(s.aligner, ks1, ks2, s.task_size, sink,
                         pipeline_depth=2, verbose=1, n_workers=s.workers)
    finally:
        os.remove(path)
    if sink.close is None:
        raise RuntimeError("the window never closed")
    mem = 0
    if s.dev.type == "cuda":
        free_b, total_b = torch.cuda.mem_get_info(s.dev)
        mem = max(torch.cuda.max_memory_reserved(s.dev), total_b - free_b)
    if tracer:
        tracer.stop()
    o, cl = sink.open, sink.close
    w = SimpleNamespace(
        reads=cl["reads"] - o["reads"], seconds=cl["t"] - o["t"],
        chunks=cl["chunk"] - o["chunk"], setup_s=o["t"] - s.t0,
        cpu_s=cl["cpu"] - o["cpu"], prof=prof_delta(o["prof"], cl["prof"]),
        failed=sink.bad_in_window,
        memory_peak_bytes=int(mem), device_ops=None, dev_lo=None,
        dev_hi=None, busy_s=None, window_s=None, sink=sink, stream=stream,
        rescue=list(s.rescue.rows))
    w.reads_per_s = rate(w.reads, o["t"], cl["t"])
    if tracer and tracer.lo is not None:
        ops = tracer.window_ops()
        w.device_ops, w.dev_lo, w.dev_hi = ops, tracer.lo, tracer.hi
        w.window_s = tracer.hi - tracer.lo
        w.busy_s = union_seconds([(a, b) for _, a, b in ops], tracer.lo,
                                 tracer.hi)
    return w


def sample_reads(s: Setup, w, seed: int) -> tuple[list[dict], list[dict]]:
    """What the check judges: `check_sample` pairs drawn from `seed` among
    the window's kept ones, both mates of each, and the rescue problems
    posed for them."""
    c, st, sink = s.c, w.stream, w.sink
    lo, hi = sink.open["reads"], sink.close["reads"]
    kept = np.array(sorted(i for i in sink.kept if lo <= i < hi), np.int64)
    frags = np.unique(kept // 2)
    rng = np.random.default_rng(seed_words(seed) + [7])
    n = min(int(c.traffic["check_sample"]), len(frags))
    pick = set(rng.choice(frags, n, replace=False).tolist())
    truth = st.truth()
    reads = []
    for fr in sorted(pick):
        for i in (2 * fr, 2 * fr + 1):
            reads.append({"name": st.name_of(i), "mate": i % 2,
                          "seq": truth["seq"][i],
                          "start": int(truth["start"][i]),
                          "span": int(truth["span"][i]),
                          "rev": bool(truth["rev"][i]),
                          "sam": sink.kept.get(i, "")})
    problems = []
    for fr, mate, comp, toff, tlen, score in w.rescue:
        if fr in pick:
            q = truth["seq"][2 * fr + mate]
            problems.append({"query": rc_codes(q) if comp else q,
                             "toff": toff, "tlen": tlen, "score": score})
    return reads, problems


def check(s: Setup, w, seed: int, control: bool = False) -> dict:
    reads, problems = sample_reads(s, w, seed)
    dev = s.dev if s.dev.type == "cuda" else "cpu"
    fr = s.c.traffic["fragment"]
    band = (fr["mean"] - 2 * fr["std"], fr["mean"] + 2 * fr["std"])
    return judge(reads, s.codes, s.scoring, s.contig, device=dev,
                 control_bits=CONTROL_BITS if control else None,
                 rescue=problems, frag_band=band)


def verdict(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """Each compared number beside its limit; correct when none is over.
    The control yields only some numbers; those it lacks are not shown."""
    shown = {k: {"value": numbers[k], "limit": v} for k, v in limits.items()
             if k in numbers}
    return all(v["value"] <= v["limit"] for v in shown.values()), shown


def run(cell: str, seed: int, seconds: float, trace: bool, t0: float,
        device: str | None = None, root: str = ROOT) -> int:
    """One run of one cell; prints the result line.  device None: the
    cell's cards, and none is an error; a test passes "cpu"."""
    import torch
    c = load_cell(cell, root)
    if device is None:
        if not torch.cuda.is_available() or \
                torch.cuda.device_count() < c.chips:
            log(f"[portbench] {cell} needs {c.chips} CUDA card(s); "
                f"torch.cuda.is_available() = {torch.cuda.is_available()}, "
                f"device_count() = {torch.cuda.device_count()}")
            return 3
        device = "cuda:0"
    s = Setup(c, device, t0)
    w = run_window(s, seed, seconds, trace)
    log(f"[portbench] window: {w.reads} reads in {w.chunks} chunks, "
        f"{w.seconds:.3f}s, set-up {w.setup_s:.3f}s, "
        f"{torch.get_num_threads()} host thread(s) a pool"
        + (" (built the genome and index)" if s.built else ""))
    names = metric_names(c, trace)
    u = units(c)
    metrics = {}
    for name in names:
        v = load_reader(c.bench, name)(w)
        if v is not None:
            metrics[name] = {"value": float(v), "unit": u[name]}
    dev = s.dev
    device_rec = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                  "kind": (torch.cuda.get_device_name(dev)
                           if dev.type == "cuda" else "cpu"),
                  "count": c.chips,
                  "memory_peak_bytes": w.memory_peak_bytes}
    breakdown = None
    if trace:
        device_rec["busy_s"] = w.busy_s
        device_rec["window_s"] = w.window_s
        if w.device_ops is not None:
            by = {}
            for n, a, b in w.device_ops:
                by[n] = by.get(n, 0.0) + (b - a)
            top = sorted(by.items(), key=lambda x: -x[1])[:10]
            breakdown = {"device_ops": [[n[:200], v] for n, v in top],
                         "idle_gaps": [[n[:200], v] for n, v in idle_gaps(
                             w.device_ops, w.dev_lo, w.dev_hi)[:10]]}
    s.free()
    numbers = check(s, w, seed)
    ok, shown = verdict(numbers, c.limits["limits"])
    if len(shown) != len(c.limits["limits"]):
        raise KeyError("the check gave no number for a limit")
    bad = forbidden_modules()
    if bad:
        log(f"[portbench] forbidden modules loaded: {', '.join(bad)}")
        return 4
    correct = ok and w.failed == 0
    log(f"[portbench] sampled {numbers['sampled']} reads, "
        f"{numbers['short']} short, worst gap {numbers['worst_gap']}, "
        f"{numbers['records_skipped']} records beside an N not judged; "
        f"{numbers['pairs']} pairs, {numbers['pairs_at_origin']} of them "
        f"at their origin in the band; {numbers['rescue_judged']} rescue "
        f"problems judged, {numbers['rescue_skipped']} beside an N not")
    log(f"check: failed {w.failed} (limit 0)")
    for k, v in shown.items():
        log(f"check: {k} {v['value']} (limit {v['limit']})")
    shown = dict({"failed": {"value": w.failed, "limit": 0}}, **shown)
    out = {"correct": bool(correct), "attempted": int(w.reads),
           "failed": int(w.failed), "metrics": metrics, "device": device_rec}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["check"] = shown
    print(json.dumps(out), flush=True)
    return 0

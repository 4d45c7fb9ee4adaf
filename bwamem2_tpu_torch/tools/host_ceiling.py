"""The host's ceiling on `mem` PE throughput, by record and replay (the
port of tools/host_ceiling.py).

One pass records every device boundary's outputs; replay passes serve
them from memory, so no kernel runs and the replay's wall is what the
host side of the whole pipeline costs: the chunks' host seeding of
overflowed reads, chaining, the extension acceptance loop, pairing, SAM
text and I/O.

    python -m bwamem2_tpu_torch.tools.host_ceiling [--scale 1.0]
        [--pairs 50000] [--device cuda]

Data: benchdata.ensure(.tmp/bench_scale<scale>, scale, pairs), chunks of
2,250,000 bases (bench.py's task size).  Passes, each one run_pipeline with n_workers=1 so that host
and device work are serialized: warm (kernel builds, index upload), a
clean end-to-end pass, a record pass, then two replay passes (the faster
is the host's wall).  Prints one JSON line: the keys of the JAX tool
(reads, wall_e2e_1worker_s, wall_host_s, host_frac_of_e2e,
host_ceiling_rps, wall_at_10x_device_s, implied_rps_at_10x_device: the
wall once the device part is 10x faster) with the card and its power
limit, the boundary outputs recorded, and the replay's kernel launches
and plain-version calls (all 0).

DeviceTap cuts at the device calls themselves, on one TorchBackend:
  TorchBackend._attach_grid   the chunk's read-grid upload; in replay a
                              host stand-in of the grid's shape is set on
                              the worker thread (DeviceBSW.encj and .lens
                              are per thread: read_grid_width and the
                              extension path read them);
  FusedSeeder.run             seeding and SA resolution (fused path);
  TorchBackend.collect_smems, .sa_lookup
                              the per-stage seeding of a sharded index or
                              of the legacy round 1 (the host work inside
                              collect_smems, round 2's emission and the
                              sort, is charged to the device side);
  DeviceKswv.align_batch      the chunk's rescue batch;
  DeviceBSW.run_arrays, ._run extension scoring, flat and object paths.
The JAX tool wrapped collect_smems but not the fused collect_chunk, so
its replay still seeded on the device; and a replay lookup that missed
fell through to the device.  Here a miss raises ReplayMiss, and the
replay's launch counters (ops/cuda_build.py:launch_counts) must read 0.
Keys are content digests: a chunk's padded read grid (taken in every pass
when the grid is attached, so its cost is in the replay's wall) and each
boundary's own input arrays.  Replay unpickles the stored outputs, a
small cost charged to the host side.
"""

from __future__ import annotations

import argparse
import hashlib
import io
import json
import os
import pickle
import sys
import threading
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

# bench.py:42-46: the chr21 class, 50,000 pairs, 2.25 Mbp chunks
SCALE, PAIRS, TASK_BASES = 1.0, 50_000, 2_250_000


class ReplayMiss(KeyError):
    """A replayed boundary was called with inputs the record pass never
    saw (the inputs drifted)."""


def digest(*parts) -> bytes:
    """A content digest of arrays, bytes and plain values."""
    h = hashlib.blake2b(digest_size=16)
    for p in parts:
        if isinstance(p, np.ndarray):
            h.update(f"{p.dtype.str}{p.shape}".encode())
            h.update(np.ascontiguousarray(p).data)
        elif isinstance(p, bytes):
            h.update(p)
        else:
            h.update(repr(p).encode())
    return h.digest()


class HostGrid:
    """The replay's stand-in for a chunk's read grid on the device: only
    its shape is read outside the tapped boundaries."""

    def __init__(self, shape):
        self.shape = shape


class DeviceTap:
    """Record / replay of one TorchBackend's device boundaries (see the
    module docstring).  `mode` is "record" or "replay"; `store` maps an
    input digest to the pickled output; `recorded` counts the outputs per
    boundary and `misses` the replay lookups that failed (each raised)."""

    def __init__(self, backend):
        self.be = backend
        self.mode = "record"
        self.store: dict[bytes, bytes] = {}
        self.recorded: dict[str, int] = {}
        self.misses = 0
        self._tls = threading.local()
        bsw = backend._bsw
        self.orig = dict(attach_grid=backend._attach_grid,
                         collect_smems=backend.collect_smems,
                         sa_lookup=backend.sa_lookup,
                         align_batch=backend._kswv.align_batch,
                         run_arrays=bsw.run_arrays, _run=bsw._run)
        if hasattr(backend, "seeder"):
            self.orig["seed"] = backend.seeder.run
            backend.seeder.run = self._seed
        backend._attach_grid = self._attach_grid
        backend.collect_smems = self._collect_smems
        backend.sa_lookup = self._sa_lookup
        backend._kswv.align_batch = self._align_batch
        bsw.run_arrays = self._run_arrays
        bsw._run = self._run_pairs

    def _io(self, name: str, key: bytes, thunk):
        """Record thunk()'s output under key, or replay it."""
        if self.mode == "record":
            out = thunk()
            self.store[key] = pickle.dumps(out, protocol=4)
            self.recorded[name] = self.recorded.get(name, 0) + 1
            return out
        blob = self.store.get(key)
        if blob is None:
            self.misses += 1
            raise ReplayMiss(f"{name}: no recorded output for these inputs "
                             "(they drifted since the record pass)")
        return pickle.loads(blob)

    def _grid(self) -> bytes:
        return self._tls.grid

    # -- boundary wrappers --
    def _attach_grid(self, encs):
        from ..ops.backend import _pad_reads
        from ..ops.cuda_build import launch_tally
        enc, lens = _pad_reads(encs)
        self._tls.grid = digest(enc)
        if self.mode == "record":
            return self.orig["attach_grid"](encs)
        launch_tally(self.be.launches)
        self.be._bsw.encj = HostGrid(enc.shape)
        self.be._bsw.lens = lens
        return lens

    def _seed(self, encj, lensj, opt):
        return self._io("seed", digest("seed", self._grid()),
                        lambda: self.orig["seed"](encj, lensj, opt))

    def _collect_smems(self, encs, opt):
        if self.mode == "record":
            out = self.orig["collect_smems"](encs, opt)
        else:
            self.be._attach_long(encs)     # the grid stand-in, long reads
            out = None
        return self._io("collect_smems", digest("smems", self._grid()),
                        lambda: out)

    def _sa_lookup(self, positions):
        return self._io("sa_lookup", digest("sal", positions),
                        lambda: self.orig["sa_lookup"](positions))

    def _align_batch(self, encj, desc):
        key = digest("kswv", self._grid(), *(desc[k] for k in sorted(desc)))
        return self._io("align_batch", key,
                        lambda: self.orig["align_batch"](encj, desc))

    def _run_arrays(self, desc, w, opt, end_bonus):
        key = digest("bswa", self._grid(), w, end_bonus,
                     *(desc[k] for k in sorted(desc)))
        return self._io("run_arrays", key, lambda: self.orig["run_arrays"](
            desc, w, opt, end_bonus))

    def _run_pairs(self, pending, w, opt, end_bonus):
        rows = np.array([(p.seqid, p.qoff, p.qdir, p.toff, p.tdir, p.qlen,
                          p.tlen, p.h0) for p in pending], np.int64)
        key = digest("bswp", self._grid(), w, end_bonus, rows)
        return self._io("_run", key, lambda: self.orig["_run"](
            pending, w, opt, end_bonus))


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def measure(prefix: str, fq1: str, fq2: str | None, task_bases: int,
            device="cuda", log=None) -> dict:
    """The five passes over (fq1, fq2) (SE when fq2 is None) on one
    TorchBackend on `device`.  Returns the report (the JSON keys) with
    "sam" (the record pass's SAM records) and "tap".  Raises unless both
    replays' SAM equals the record pass's, and the replays launched no
    kernel and ran no plain version."""
    from ..align.pipeline import Aligner
    from ..index.fmindex import FMIndex
    from ..io.fastq import FastxReader
    from ..ops.backend import TorchBackend
    from ..ops.cuda_build import launch_counts
    from ..options import MEM_F_PE, MemOptions
    from ..runtime import run_pipeline
    log = log or (lambda m: print(m, file=sys.stderr, flush=True))
    fm = FMIndex.load(prefix)
    opt = MemOptions().finalize(None)
    if fq2:
        opt.flag |= MEM_F_PE
    be = TorchBackend(fm, opt, device=device)
    al = Aligner(fm, opt, backend=be, verbose=0)

    def one_pass():
        out = io.StringIO()
        t0 = time.perf_counter()
        n = run_pipeline(al, FastxReader(fq1),
                         FastxReader(fq2) if fq2 else None, task_bases, out,
                         verbose=0, n_workers=1)
        sync(be.device)
        return n, time.perf_counter() - t0, out.getvalue()

    log("[ceiling] warm pass (builds, uploads)")
    one_pass()
    log("[ceiling] clean e2e pass")
    n, wall_e2e, _ = one_pass()
    tap = DeviceTap(be)
    log("[ceiling] record pass")
    _, _, sam = one_pass()
    tap.mode = "replay"
    before = (launch_counts(), launch_counts(plain=True), dict(be.launches))
    walls = []
    for i in range(2):
        log(f"[ceiling] replay pass {i + 1} (no device work)")
        _, w, sam_r = one_pass()
        walls.append(w)
        if sam_r != sam:
            raise RuntimeError("host_ceiling: the replay's SAM differs from "
                               "the record pass's")
    after = (launch_counts(), launch_counts(plain=True), dict(be.launches))
    launched, plain, tally = ({k: a.get(k, 0) - b.get(k, 0) for k in a}
                              for a, b in zip(after, before))
    if any(launched.values()) or any(plain.values()) \
            or any(tally.values()):
        raise RuntimeError(f"host_ceiling: the replay ran device work: "
                           f"launches {launched}, plain calls {plain}")
    wall_host = min(walls)
    w10 = wall_host + max(wall_e2e - wall_host, 0.0) / 10
    from .kernel_micro import card
    return dict(
        reads=n, wall_e2e_1worker_s=round(wall_e2e, 4),
        wall_host_s=round(wall_host, 4),
        host_frac_of_e2e=round(wall_host / wall_e2e, 4),
        host_ceiling_rps=round(n / wall_host, 1),
        wall_at_10x_device_s=round(w10, 4),
        implied_rps_at_10x_device=round(n / w10, 1),
        replay_walls_s=[round(w, 4) for w in walls],
        card=card(be.device), task_bases=task_bases,
        recorded=dict(tap.recorded), misses=tap.misses,
        replay_launches=sum(launched.values()),
        replay_plain_calls=sum(plain.values()), sam=sam, tap=tap)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--scale", type=float, default=SCALE)
    ap.add_argument("--pairs", type=int, default=PAIRS)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    from .. import benchdata
    from ..ops import resolve_device
    dev = resolve_device(a.device)        # cuda without a card raises
    prefix, fq1, fq2 = benchdata.ensure(
        os.path.join(REPO, ".tmp", f"bench_scale{a.scale}"), a.scale,
        a.pairs)
    rep = measure(prefix, fq1, fq2, TASK_BASES, dev)
    rep.pop("sam")
    rep.pop("tap")
    print(json.dumps(rep))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The configuration's genome and its index, made once per checkout.

The genome is part of a configuration, as a published reference assembly
is: one contig of random core sequence from the configuration's own fixed
seed, with interspersed repeat families (an ALU-like family and a
LINE-like family, each copy diverged from its consensus) and N runs at the
telomeres and the centromere.  This is the model of
`bwamem2_tpu_torch/benchdata.py:make_genome`, parametrised by the
configuration's `genome` block.

`ensure(spec)` writes the genome as FASTA and as a NumPy array of base
codes (0-3 = ACGT, 4 = N, which the plain reference reads), then builds the
index with the program's own index code (what `bwamem2_tpu_torch index`
runs), all under `portbench/.cache/genome-<digest of the spec>/`, a fixed
directory inside the checkout.  A second run finds them there; a file lock
keeps two processes from building at once.
"""

from __future__ import annotations

import fcntl
import hashlib
import json
import os
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
CACHE = os.path.join(HERE, ".cache")
BASES = np.frombuffer(b"ACGTN", dtype=np.uint8)
DONE = "complete"


def spec_key(spec: dict) -> str:
    blob = json.dumps(spec, sort_keys=True).encode()
    return hashlib.sha1(blob).hexdigest()[:16]


def make_codes(spec: dict) -> np.ndarray:
    """Base codes of the genome that `spec` describes (uint8, 4 = N)."""
    rng = np.random.default_rng(int(spec["seed"]))
    n = int(spec["length"])
    g = rng.integers(0, 4, n, dtype=np.uint8)
    for fam in spec["families"]:
        ln, every, div = int(fam["length"]), int(fam["every"]), fam["div"]
        cons = rng.integers(0, 4, ln, dtype=np.uint8)
        copies = n // every
        starts = rng.integers(0, n - ln, copies)
        for p in starts.tolist():      # in order: a later copy overwrites
            cp = cons.copy()
            hit = rng.random(ln) < div
            cp[hit] = rng.integers(0, 4, int(hit.sum()), dtype=np.uint8)
            g[p:p + ln] = cp
    for where, length in spec["n_runs"]:
        s = {"start": 0, "mid": n // 2, "end": n - length}[where]
        g[s:s + length] = 4
    return g


def write_fasta(path: str, codes: np.ndarray, name: str) -> None:
    width = 80
    n = len(codes)
    full = n // width * width
    body = np.empty((n // width, width + 1), np.uint8)
    body[:, :width] = BASES[codes[:full]].reshape(-1, width)
    body[:, width] = ord("\n")
    with open(path, "wb") as f:
        f.write(f">{name} synthetic genome\n".encode())
        f.write(body.tobytes())
        if full < n:
            f.write(BASES[codes[full:]].tobytes() + b"\n")


def ensure(spec: dict, log=None) -> dict:
    """The genome of `spec`, built once: returns {"dir", "prefix" (the
    FASTA, which is also the index prefix), "codes" (the .npy path),
    "built" (True when this call made them)}."""
    log = log or (lambda msg: print(msg, file=sys.stderr))
    d = os.path.join(CACHE, "genome-" + spec_key(spec))
    fa = os.path.join(d, "genome.fa")
    npy = os.path.join(d, "codes.npy")
    out = {"dir": d, "prefix": fa, "codes": npy, "built": False}
    if os.path.exists(os.path.join(d, DONE)):
        return out
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, "lock"), "w") as lk:
        fcntl.flock(lk, fcntl.LOCK_EX)
        if os.path.exists(os.path.join(d, DONE)):
            return out
        t0 = time.perf_counter()
        codes = make_codes(spec)
        np.save(npy, codes)
        write_fasta(fa, codes, spec.get("contig", "chr1s"))
        log(f"[portbench] genome {len(codes)} bp in "
            f"{time.perf_counter() - t0:.1f}s")
        del codes
        t0 = time.perf_counter()
        from bwamem2_tpu_torch.index.build import build_index
        build_index(fa, fa, verbose=False)
        log(f"[portbench] index in {time.perf_counter() - t0:.1f}s")
        with open(os.path.join(d, "spec.json"), "w") as f:
            json.dump(spec, f, indent=1, sort_keys=True)
        with open(os.path.join(d, DONE), "w") as f:
            f.write("ok\n")
        out["built"] = True
    return out


def clean_segments(codes: np.ndarray, margin: int) -> np.ndarray:
    """[start, end) of every stretch without N, each shrunk by `margin`
    at both ends: where the traffic may place its reads."""
    isn = np.concatenate([[True], codes == 4, [True]])
    edges = np.flatnonzero(np.diff(isn.astype(np.int8)))
    starts, ends = edges[0::2], edges[1::2]
    seg = np.stack([starts + margin, ends - margin], 1)
    return seg[seg[:, 1] > seg[:, 0]].astype(np.int64)

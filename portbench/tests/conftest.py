"""Shared fixtures of the benchmark's tests: the repository root on the
path, and a tiny copy of the benchmark (a 120 kb genome, one worker,
small chunks) that runs on the CPU with the kernels' plain versions."""

import json
import os
import shutil
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

TINY_CELL = "tiny_sr.pe150_tiny"


def copy_bench(dst: str) -> str:
    """BENCHMARK.json and the benchmark's data files under dst."""
    os.makedirs(dst, exist_ok=True)
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), dst)
    for sub in ("configs", "traffic", "cells", "metrics"):
        shutil.copytree(os.path.join(ROOT, "portbench", sub),
                        os.path.join(dst, "portbench", sub))
    return dst


def add_tiny_cell(root: str, chunk_bases: int = 6_000) -> None:
    """A tiny configuration, traffic mix and cell: new files and entries."""
    b = os.path.join(root, "portbench")
    with open(os.path.join(b, "configs", "sr_chr1.json")) as f:
        cfg = json.load(f)
    cfg.update(name="tiny_sr", genome_length=120_000, chunk_bases=chunk_bases,
               workers=1)
    with open(os.path.join(b, "configs", "tiny_sr.json"), "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(b, "traffic", "pe150.json")) as f:
        tr = json.load(f)
    tr.update(check_every=1, check_sample=400)
    with open(os.path.join(b, "traffic", "pe150_tiny.json"), "w") as f:
        json.dump(tr, f)
    with open(os.path.join(b, "cells", "sr_chr1.pe150.json")) as f:
        lim = json.load(f)
    with open(os.path.join(b, "cells", TINY_CELL + ".json"), "w") as f:
        json.dump(lim, f)
    path = os.path.join(root, "BENCHMARK.json")
    with open(path) as f:
        spec = json.load(f)
    spec["configs"].append({"name": "tiny_sr", "source": "tests",
                            "file": "portbench/configs/tiny_sr.json",
                            "reduced": [], "why": "a CPU test"})
    spec["workloads"].append({"name": TINY_CELL, "config": "tiny_sr",
                              "traffic": "pe150_tiny", "chips": 1,
                              "why": "a CPU test"})
    with open(path, "w") as f:
        json.dump(spec, f)


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    """A benchmark root holding the tiny cell, its genome cached under it."""
    from portbench import genome
    root = str(tmp_path_factory.mktemp("bench"))
    copy_bench(root)
    add_tiny_cell(root)
    genome.CACHE = os.path.join(root, "cache")
    return root


@pytest.fixture(scope="session")
def card_root(tmp_path_factory):
    """The tiny cell with chunks of 200 pairs, for the card: bwa estimates
    the insert bounds that decide a proper pair (0x2) from each chunk's
    pairs, and the CPU cell's 20-pair chunks leave that estimate to chance,
    as a real chunk of thousands of pairs does not (`pair_lost`)."""
    from portbench import genome
    root = str(tmp_path_factory.mktemp("card"))
    copy_bench(root)
    add_tiny_cell(root, chunk_bases=60_000)
    genome.CACHE = os.path.join(root, "cache")
    return root


def last_json(text: str) -> dict:
    return json.loads(text.strip().splitlines()[-1])

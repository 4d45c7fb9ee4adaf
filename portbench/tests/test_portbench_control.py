"""The check at a size a test run holds: a tiny cell driven end to end on
the CPU (the kernels' plain versions) passes; the control, the plain
reference in the program's place at 8-bit precision, does not; and each
fault that the cell can have, planted under the timed path, turns
`correct` false.  Faults: a step that returns its state unchanged (the
seeding hands back no seeds; the rescue kernel finds nothing), half of
each chunk's reads left out (given unmapped records, or none), and an
answer altered where it is produced (a position moved, a score raised,
a pair's proper flag dropped, a mate's position moved)."""

import time

import pytest

from conftest import TINY_CELL, last_json

from portbench import bench

SEED = 2**31 + 12345


def run_tiny(root, capsys, seed=SEED):
    rc = bench.run(TINY_CELL, seed, 0.5, False, time.perf_counter(),
                   device="cpu", root=root)
    assert rc == 0
    return last_json(capsys.readouterr().out)


def test_sound_run_is_correct_and_control_is_not(tiny_root, capsys):
    out = run_tiny(tiny_root, capsys)
    assert out["correct"] is True, out["check"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert set(out["metrics"]) == {"reads_per_s", "setup_s"}
    assert list(out["check"]) == ["failed", "tag_bad", "over_best",
                                  "pair_bad", "pair_lost", "rescue_bad",
                                  "short_share"]
    c = bench.load_cell(TINY_CELL, tiny_root)
    s = bench.Setup(c, "cpu", time.perf_counter())
    w = bench.run_window(s, SEED + 1, 0.5, False)
    ctrl = bench.check(s, w, SEED + 1, control=True)
    ok, shown = bench.verdict(ctrl, c.limits["limits"])
    assert not ok and ctrl["short_share"] > 0.5, shown


def no_rescue(monkeypatch):
    """The rescue kernel returns every problem unscored: no hit."""
    import numpy as np
    from bwamem2_tpu_torch.ops.backend import TorchBackend
    monkeypatch.setattr(TorchBackend, "rescue_batch", lambda self, desc:
                        np.zeros((len(desc["qoff"]), 7), np.int32))


def unmapped(r):
    flag = 0x45 if r.id % 2 == 0 else 0x85
    return f"{r.name}\t{flag}\t*\t0\t0\t*\t*\t0\t0\t{r.seq}\t{r.qual}\n"


def no_seeds(monkeypatch):
    from bwamem2_tpu_torch.align.pipeline import Aligner
    monkeypatch.setattr(Aligner, "kernel1",
                        lambda self, encs, opt: [[] for _ in encs])


def wrap_process(monkeypatch, after):
    from bwamem2_tpu_torch.align.pipeline import Aligner
    orig = Aligner.process

    def process(self, reads, n_processed, pes0=None):
        n = orig(self, reads, n_processed, pes0)
        after(reads)
        return n
    monkeypatch.setattr(Aligner, "process", process)


def half_left_out(monkeypatch):
    def after(reads):
        for r in reads[len(reads) // 2:]:
            r.sam = unmapped(r)
    wrap_process(monkeypatch, after)


def half_missing(monkeypatch):
    def after(reads):
        for r in reads[len(reads) // 2:]:
            r.sam = ""
    wrap_process(monkeypatch, after)


def move_pos(r):
    f = r.sam.split("\t")
    if f[3] != "0" and not int(f[1]) & 4:
        f[3] = str(int(f[3]) + 1)
    r.sam = "\t".join(f)


def raise_as(r):
    r.sam = r.sam.replace("\tAS:i:", "\tAS:i:1", 1)


def drop_proper(r):
    f = r.sam.split("\t")
    f[1] = str(int(f[1]) & ~2)
    r.sam = "\t".join(f)


def move_pnext(r):
    f = r.sam.split("\t")
    if f[7] != "0":
        f[7] = str(int(f[7]) + 1)
    r.sam = "\t".join(f)


def altered(edit):
    def plant(monkeypatch):
        def after(reads):
            for r in reads[::7]:
                edit(r)
        wrap_process(monkeypatch, after)
    return plant


@pytest.mark.parametrize("fault,number", [
    (no_seeds, "short_share"),
    (no_rescue, "rescue_bad"),
    (half_left_out, "short_share"),
    (half_missing, "failed"),
    (altered(move_pos), "tag_bad"),
    (altered(raise_as), "over_best"),
    (altered(drop_proper), "pair_lost"),
    (altered(move_pnext), "pair_bad"),
])
def test_each_fault_turns_correct_false(tiny_root, capsys, monkeypatch,
                                        fault, number):
    fault(monkeypatch)
    out = run_tiny(tiny_root, capsys)
    assert out["correct"] is False
    v = out["check"][number]
    assert v["value"] > v["limit"], out["check"]

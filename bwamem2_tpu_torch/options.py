"""Alignment options — flag-for-flag mirror of bwa-mem2's `mem_opt_t`.

Reference: bwa-mem2 v2.2.1 src/bwamem.h:76-108 (struct), bwamem.cpp:107-143
(defaults), fastmap.cpp:547-561 (`update_a` -A rescaling), fastmap.cpp:801-843
(-x mode presets).  Field names and defaults are kept identical so a bwa-mem2
user can move a command line over unchanged.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field, fields

# flag bits (bwamem.h:62-73)
MEM_F_PE = 0x2
MEM_F_NOPAIRING = 0x4
MEM_F_ALL = 0x8
MEM_F_NO_MULTI = 0x10
MEM_F_NO_RESCUE = 0x20
MEM_F_REF_HDR = 0x100
MEM_F_SOFTCLIP = 0x200
MEM_F_SMARTPE = 0x400
MEM_F_PRIMARY5 = 0x800
MEM_F_KEEP_SUPP_MAPQ = 0x1000

MEM_MAPQ_COEF = 30.0
MEM_MAPQ_MAX = 60


def fill_scmat(a: int, b: int) -> list[int]:
    """5x5 DNA scoring matrix with ambiguous base rows/cols = -1, each entry
    as bwa-mem2's `int8_t mat[25]` holds it: a score outside -128..127
    wraps (two's complement), so -A52 (-B scaled to 208) scores a mismatch
    +48 there, in every kernel that reads the matrix.

    Reference: bwa.cpp:248-257 (bwa_fill_scmat).
    """
    def i8(x: int) -> int:
        return (x + 128) % 256 - 128

    mat = []
    for i in range(4):
        for j in range(4):
            mat.append(i8(a if i == j else -b))
        mat.append(-1)
    mat.extend([-1] * 5)
    return mat


@dataclass
class MemOptions:
    a: int = 1                    # match score
    b: int = 4                    # mismatch penalty
    o_del: int = 6
    e_del: int = 1
    o_ins: int = 6
    e_ins: int = 1
    pen_unpaired: int = 17
    pen_clip5: int = 5
    pen_clip3: int = 5
    w: int = 100                  # band width
    zdrop: int = 100
    max_mem_intv: int = 20
    T: int = 30                   # output score threshold
    flag: int = 0
    min_seed_len: int = 19
    min_chain_weight: int = 0
    max_chain_extend: int = 1 << 30
    split_factor: float = 1.5
    split_width: int = 10
    max_occ: int = 500
    max_chain_gap: int = 10000
    n_threads: int = 1
    verbose: int = 3      # bwa_verbose analog (-v); >=4 adds debug dumps
    chunk_size: int = 10_000_000
    mask_level: float = 0.50
    drop_ratio: float = 0.50
    XA_drop_ratio: float = 0.80
    mask_level_redun: float = 0.95
    mapQ_coef_len: float = 50.0
    # NB: an int in the reference struct — (int)log(50) == 3 (bwamem.h:103)
    mapQ_coef_fac: int = int(math.log(50.0))
    max_ins: int = 10000
    max_matesw: int = 50
    max_XA_hits: int = 5
    max_XA_hits_alt: int = 200
    mat: list[int] = field(default_factory=lambda: fill_scmat(1, 4))

    # track which fields the user explicitly set (mem_opt_t opt0 shadow)
    _set: set = field(default_factory=set, repr=False)

    def set(self, name: str, value) -> None:
        """Set a field and mark it as user-specified (for update_a / presets)."""
        setattr(self, name, value)
        self._set.add(name)
        if name == "mapQ_coef_len":
            self.mapQ_coef_fac = int(math.log(value)) if value > 0 else 0

    def was_set(self, name: str) -> bool:
        return name in self._set

    def update_a(self) -> None:
        """Rescale penalties when only -A was changed (fastmap.cpp:547-561)."""
        if not self.was_set("a"):
            return
        for name in ("b", "T", "o_del", "e_del", "o_ins", "e_ins", "zdrop",
                     "pen_clip5", "pen_clip3", "pen_unpaired"):
            if not self.was_set(name):
                setattr(self, name, getattr(self, name) * self.a)

    def apply_mode(self, mode: str) -> None:
        """-x presets: pacbio / ont2d / intractg (fastmap.cpp:801-843)."""
        def d(name, value):
            if not self.was_set(name):
                setattr(self, name, value)

        if mode == "intractg":
            d("o_del", 16); d("o_ins", 16); d("b", 9)
            d("pen_clip5", 5); d("pen_clip3", 5)
        elif mode in ("pacbio", "pbref", "ont2d"):
            d("o_del", 1); d("e_del", 1); d("o_ins", 1); d("e_ins", 1); d("b", 1)
            d("split_factor", 10.0)
            if mode == "ont2d":
                d("min_chain_weight", 20); d("min_seed_len", 14)
                d("pen_clip5", 0); d("pen_clip3", 0)
            else:
                d("min_chain_weight", 40); d("min_seed_len", 17)
                d("pen_clip5", 0); d("pen_clip3", 0)
        else:
            raise ValueError(f"unknown read type {mode!r}")

    def finalize(self, mode: str | None = None) -> "MemOptions":
        """Apply mode presets / -A rescaling and refresh the scoring matrix."""
        if mode:
            self.apply_mode(mode)
        else:
            self.update_a()
        self.mat = fill_scmat(self.a, self.b)
        return self

    def mat_scores(self) -> tuple[int, int]:
        """(match score, mismatch penalty) of the int8 matrix: what the
        native kernels score with, so what the device kernels are given."""
        return self.mat[0], -self.mat[1]

    def copy(self) -> "MemOptions":
        o = MemOptions()
        for f in fields(self):
            if f.name in ("mat", "_set"):
                continue
            setattr(o, f.name, getattr(self, f.name))
        o.mat = list(self.mat)
        o._set = set(self._set)
        return o

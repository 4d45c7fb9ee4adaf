"""K-mer interval lookup table: the FM intervals of all 4^K patterns.

The port's copy of bwamem2_tpu/index/klut.py (host numpy).  The legacy
round-1 walk (ops/smem.py:round1_compact, TorchBackend(pivot_seeding=
False)) starts a lane whose last K characters are clean bases from their
interval, one lookup instead of K LF steps.  The stored interval is the
one K LF steps give, so the SMEMs do not change.

Built level by level with a vectorized occ() (np.bitwise_count, numpy 2)
and cached as {prefix}.klut{K}.npz where the caller names a prefix.
"""

from __future__ import annotations

import os

import numpy as np

from .fmindex import FMIndex
from .io import CP_MASK, CP_SHIFT


def _occ_vec(fm: FMIndex, pos: np.ndarray, c: int) -> np.ndarray:
    blk = (pos >> CP_SHIFT).astype(np.int64)
    y = (pos & CP_MASK).astype(np.uint64)
    mask = np.where(y == 0, np.uint64(0),
                    (~np.uint64(0)) << (np.uint64(64) - y))
    base = fm.cp_count[blk, c]
    bits = np.bitwise_count(fm.one_hot[blk, c] & mask).astype(np.int64)
    return base + bits


def default_k(l_pac: int) -> int:
    """The table's depth for a genome of l_pac bases, the JAX package's
    rule (so that both build the same table): 6 up to 2^18 bases, 8 up to
    2^26, 12 beyond (4^12 entries: 268 MB of int64 starts and sizes)."""
    if l_pac >= (1 << 26):
        return 12
    if l_pac >= (1 << 18):
        return 8
    return 6


def build_klut(fm: FMIndex, K: int | None = None):
    """Returns (K, k_arr int64[4^K], s_arr int64[4^K]) with code =
    sum(base[i] * 4^(K-1-i)) over the pattern read left to right."""
    K = K or default_k(fm.l_pac)
    counts = fm.counts
    k_cur = counts[:4].astype(np.int64).copy()
    s_cur = (counts[1:5] - counts[:4]).astype(np.int64)
    for _level in range(2, K + 1):
        n = len(k_cur)
        k_new = np.empty(4 * n, np.int64)
        s_new = np.empty(4 * n, np.int64)
        for a in range(4):
            osp = _occ_vec(fm, k_cur, a)
            oep = _occ_vec(fm, k_cur + s_cur, a)
            k_new[a * n:(a + 1) * n] = counts[a] + osp
            s_new[a * n:(a + 1) * n] = oep - osp
        k_cur, s_cur = k_new, s_new
    return K, k_cur, s_cur


def load_or_build_klut(fm: FMIndex, prefix: str | None = None,
                       K: int | None = None):
    """build_klut, read from {prefix}.klut{K}.npz if it exists and written
    there if not; with no prefix nothing is read or written."""
    K = K or default_k(fm.l_pac)
    path = f"{prefix}.klut{K}.npz" if prefix else None
    if path and os.path.exists(path):
        z = np.load(path)
        return K, z["k"], z["s"]
    K, k_arr, s_arr = build_klut(fm, K)
    if path:
        try:
            np.savez(path, k=k_arr, s=s_arr)
        except OSError:
            pass
    return K, k_arr, s_arr

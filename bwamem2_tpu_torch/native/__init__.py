"""ctypes bindings for the native host-side kernels (core.cpp).

The shared library is compiled on first use with g++ (no pip deps) into
this directory, under a file lock (see _build).  All entry points take
NumPy arrays; see core.cpp for the behavioral spec of each kernel
(file:line citations into the bwa-mem2 reference).
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
import os
import subprocess
import threading

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_LIB_PATH = os.path.join(_HERE, "libbwamem2_core.so")
_SRC_PATHS = [os.path.join(_HERE, "core.cpp"),
              os.path.join(_HERE, "runtime.cpp")]
_HDR_PATHS = [os.path.join(_HERE, "nsort.h")]
_lock = threading.Lock()
_lib = None
KSW_XBYTE, KSW_XSUBO, KSW_XSTART = 0x10000, 0x40000, 0x80000   # ksw.h


def _stale() -> bool:
    src_mtime = max(os.path.getmtime(p) for p in _SRC_PATHS + _HDR_PATHS)
    return (not os.path.exists(_LIB_PATH)
            or os.path.getmtime(_LIB_PATH) < src_mtime)


def _build() -> None:
    """Compile under an exclusive file lock, into a per-process temp name
    that is renamed into place: concurrent test workers (pytest -n) and
    pipeline threads never load a half-written library."""
    with build_lock(_LIB_PATH):
        if not _stale():     # another process built it while we waited
            return
        tmp = f"{_LIB_PATH}.{os.getpid()}.tmp"
        try:
            subprocess.run(
                ["g++", "-O3", "-march=native", "-fPIC", "-std=c++17",
                 "-shared", *_SRC_PATHS, "-o", tmp],
                check=True, capture_output=True,
            )
            os.replace(tmp, _LIB_PATH)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)


@contextlib.contextmanager
def build_lock(path: str):
    """Exclusive advisory lock on `path`.lock (shared with ops/bsw_cuda)."""
    with open(path + ".lock", "w") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def get_lib() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is not None:
            return _lib
        if _stale():
            _build()
        lib = ctypes.CDLL(_LIB_PATH)

        c_i64 = ctypes.c_int64
        c_i32 = ctypes.c_int32
        p_u8 = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
        p_i8 = np.ctypeslib.ndpointer(np.int8, flags="C_CONTIGUOUS")
        p_i32 = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        p_i64 = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
        p_u32 = np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS")

        lib.sais_u8.restype = ctypes.c_int
        lib.sais_u8.argtypes = [p_u8, p_i64, c_i64, c_i64]

        lib.bsw_extend.restype = ctypes.c_int
        lib.bsw_extend.argtypes = [
            ctypes.c_int, p_u8, ctypes.c_int, p_u8, ctypes.c_int, p_i8,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int)]

        lib.bsw_extend_batch.restype = None
        lib.bsw_extend_batch.argtypes = [
            c_i64, p_u8, p_i64, p_i32, p_u8, p_i64, p_i32, p_i32, c_i32,
            p_i8, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, p_i32]

        lib.ksw_align.restype = None
        lib.ksw_align.argtypes = [
            ctypes.c_int, p_u8, ctypes.c_int, p_u8, ctypes.c_int, p_i8,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, p_i32]

        lib.ksw_align_batch.restype = None
        lib.ksw_align_batch.argtypes = [
            c_i64, p_u8, p_i64, p_i32, p_u8, p_i64, p_i32, ctypes.c_int,
            p_i8, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            p_i32, p_i32]

        p_f32 = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        lib.chain_seeds_batch.restype = None
        lib.chain_seeds_batch.argtypes = [
            c_i64, p_i32, p_i64, p_i32, p_i32, p_i64, p_i64, p_i64,
            c_i64, c_i32, p_i64, p_u8,
            c_i32, c_i32, c_i32, c_i32,
            p_i64, p_i64, p_i32, p_u8, p_f32, p_i32,
            p_i64, p_i32, p_i32]

        lib.chain_filter_batch.restype = None
        lib.chain_filter_batch.argtypes = [
            c_i64, p_i64, p_u8, p_i32, p_i64, p_i32, p_i32,
            c_i32, c_i32, c_i32, c_i32, ctypes.c_float, ctypes.c_float,
            p_i64, p_i64, p_i32, p_u8]

        lib.ksw_global.restype = ctypes.c_int
        lib.ksw_global.argtypes = [
            ctypes.c_int, p_u8, ctypes.c_int, p_u8, ctypes.c_int, p_i8,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.POINTER(c_i32), p_u32]

        _lib = lib
    return _lib


def sais(seq: np.ndarray, k: int = 6,
         out: np.ndarray | None = None) -> np.ndarray:
    """Suffix array of a uint8 sequence (values < k), int64 output.

    Matches the reference's sais-lite semantics (end-of-string sorts first);
    used by the index builder exactly like FMI_search.cpp:372.  `out` lets
    the caller provide the destination (e.g. a view into a larger array —
    at human scale an extra 50GB copy is the difference between fitting
    RAM and OOM)."""
    seq = np.ascontiguousarray(seq, dtype=np.uint8)
    n = seq.shape[0]
    sa = out if out is not None else np.empty(n, dtype=np.int64)
    if not (sa.flags["C_CONTIGUOUS"] and sa.dtype == np.int64
            and len(sa) == n):
        raise ValueError("sais out buffer must be C-contiguous int64[n]")
    rc = get_lib().sais_u8(seq, sa, n, k)
    if rc != 0:
        raise RuntimeError("sais failed")
    return sa


def bsw_extend(query: np.ndarray, target: np.ndarray, mat: np.ndarray,
               o_del: int, e_del: int, o_ins: int, e_ins: int, w: int,
               end_bonus: int, zdrop: int, h0: int):
    """Single banded SW extension; returns (score, qle, tle, gtle, gscore, max_off)."""
    query = np.ascontiguousarray(query, dtype=np.uint8)
    target = np.ascontiguousarray(target, dtype=np.uint8)
    mat = np.ascontiguousarray(mat, dtype=np.int8)
    m = int(np.sqrt(mat.size))
    outs = [ctypes.c_int() for _ in range(5)]
    score = get_lib().bsw_extend(
        len(query), query, len(target), target, m, mat, o_del, e_del, o_ins,
        e_ins, w, end_bonus, zdrop, h0,
        *[ctypes.byref(o) for o in outs])
    return (score,) + tuple(o.value for o in outs)


def bsw_extend_batch(refs, ref_off, ref_len, qers, qer_off, qer_len, h0, w,
                     mat, o_del, e_del, o_ins, e_ins, zdrop, end_bonus):
    """Batched banded SW extension. Returns int32 array (n, 6):
    score, qle, tle, gtle, gscore, max_off."""
    n = len(ref_off)
    out = np.empty((n, 6), dtype=np.int32)
    mat = np.ascontiguousarray(mat, dtype=np.int8)
    m = int(np.sqrt(mat.size))
    get_lib().bsw_extend_batch(
        n, np.ascontiguousarray(refs, np.uint8),
        np.ascontiguousarray(ref_off, np.int64),
        np.ascontiguousarray(ref_len, np.int32),
        np.ascontiguousarray(qers, np.uint8),
        np.ascontiguousarray(qer_off, np.int64),
        np.ascontiguousarray(qer_len, np.int32),
        np.ascontiguousarray(h0, np.int32), w, mat, m,
        o_del, e_del, o_ins, e_ins, zdrop, end_bonus, out)
    return out


def ksw_align(query, target, mat, o_del, e_del, o_ins, e_ins, xtra):
    """Local striped SW; returns (score, te, qe, score2, te2, tb, qb)."""
    query = np.ascontiguousarray(query, dtype=np.uint8)
    target = np.ascontiguousarray(target, dtype=np.uint8)
    mat = np.ascontiguousarray(mat, dtype=np.int8)
    m = int(np.sqrt(mat.size))
    out = np.empty(7, dtype=np.int32)
    get_lib().ksw_align(len(query), query, len(target), target, m, mat,
                        o_del, e_del, o_ins, e_ins, xtra, out)
    return tuple(int(x) for x in out)


def ksw_align_batch(queries, targets, mat, o_del, e_del, o_ins, e_ins,
                    xtra) -> np.ndarray:
    """ksw_align over lists of uint8 queries and targets, one xtra per
    problem; returns int32[n, 7] (score, te, qe, score2, te2, tb, qb)."""
    n = len(queries)
    off = lambda xs: np.concatenate(  # noqa: E731
        [[0], np.cumsum([len(x) for x in xs])]).astype(np.int64)
    cat = lambda xs: np.ascontiguousarray(  # noqa: E731
        np.concatenate([np.zeros(0, np.uint8)] + list(xs)), np.uint8)
    mat = np.ascontiguousarray(mat, dtype=np.int8)
    out = np.empty((n, 7), dtype=np.int32)
    get_lib().ksw_align_batch(
        n, cat(queries), off(queries)[:-1],
        np.array([len(x) for x in queries], np.int32), cat(targets),
        off(targets)[:-1], np.array([len(x) for x in targets], np.int32),
        int(np.sqrt(mat.size)), mat, o_del, e_del, o_ins, e_ins,
        np.ascontiguousarray(xtra, np.int32), out)
    return out


def ksw_align_desc(enc: np.ndarray, genome: np.ndarray, desc: dict,
                   opt) -> np.ndarray:
    """The host oracle of ops/kswv.py:DeviceKswv.align_batch: mem_matesw's
    ksw_align on each rescue problem of `desc`, its query read from the
    int8[N, L] read grid `enc` (reverse-complemented when qdir < 0) and its
    target from the doubled genome.  Returns int32[n, 7]."""
    L = enc.shape[1]
    qs, ts = [], []
    for qoff, qdir, ql, t0, tl in zip(desc["qoff"], desc["qdir"],
                                      desc["qlen"], desc["toff"],
                                      desc["tlen"]):
        row, col = divmod(int(qoff), L)
        if qdir < 0:
            q = enc[row, col - ql + 1: col + 1][::-1]
            q = np.where(q < 4, 3 - q, q)
        else:
            q = enc[row, col: col + ql]
        qs.append(q.astype(np.uint8))
        ts.append(genome[t0: t0 + tl])
    xtra = (KSW_XSUBO | KSW_XSTART | np.where(desc["u8"], KSW_XBYTE, 0)
            | opt.min_seed_len * opt.a)
    return ksw_align_batch(qs, ts, np.array(opt.mat, np.int8), opt.o_del,
                           opt.e_del, opt.o_ins, opt.e_ins, xtra)


def ksw_global(query, target, mat, o_del, e_del, o_ins, e_ins, w,
               traceback: bool = True):
    """Banded global alignment. Returns (score, cigar) where cigar is a
    uint32 array of len<<4|op (op: 0=M,1=I,2=D), or (score, None)."""
    query = np.ascontiguousarray(query, dtype=np.uint8)
    target = np.ascontiguousarray(target, dtype=np.uint8)
    mat = np.ascontiguousarray(mat, dtype=np.int8)
    m = int(np.sqrt(mat.size))
    if traceback:
        buf = np.zeros(len(query) + len(target) + 2, dtype=np.uint32)
        n_cigar = ctypes.c_int32()
        score = get_lib().ksw_global(len(query), query, len(target), target,
                                     m, mat, o_del, e_del, o_ins, e_ins, w,
                                     ctypes.byref(n_cigar), buf)
        return score, buf[: n_cigar.value].copy()
    score = get_lib().ksw_global(len(query), query, len(target), target, m,
                                 mat, o_del, e_del, o_ins, e_ins, w,
                                 None, np.zeros(1, dtype=np.uint32))
    return score, None


def chain_seeds_batch(lseq, smem_off, smem_m, smem_n, smem_s, occ_off,
                      occ_rbeg, l_pac, ctg_off, ctg_alt, opt):
    """Batched mem_chain_seeds over a chunk (see core.cpp).  Returns
    (chain_off, chain_pos, chain_rid, chain_alt, chain_frac, chain_nseeds,
    seed_rbeg, seed_qbeg, seed_len) flat arrays."""
    n_reads = len(lseq)
    n_occ = len(occ_rbeg)
    chain_off = np.zeros(n_reads + 1, np.int64)
    chain_pos = np.zeros(n_occ, np.int64)
    chain_rid = np.zeros(n_occ, np.int32)
    chain_alt = np.zeros(n_occ, np.uint8)
    chain_frac = np.zeros(n_occ, np.float32)
    chain_nseeds = np.zeros(n_occ, np.int32)
    seed_rbeg = np.zeros(n_occ, np.int64)
    seed_qbeg = np.zeros(n_occ, np.int32)
    seed_len = np.zeros(n_occ, np.int32)
    get_lib().chain_seeds_batch(
        n_reads, np.ascontiguousarray(lseq, np.int32),
        np.ascontiguousarray(smem_off, np.int64),
        np.ascontiguousarray(smem_m, np.int32),
        np.ascontiguousarray(smem_n, np.int32),
        np.ascontiguousarray(smem_s, np.int64),
        np.ascontiguousarray(occ_off, np.int64),
        np.ascontiguousarray(occ_rbeg, np.int64),
        l_pac, len(ctg_off),
        np.ascontiguousarray(ctg_off, np.int64),
        np.ascontiguousarray(ctg_alt, np.uint8),
        opt.w, opt.max_chain_gap, opt.max_occ, opt.min_seed_len,
        chain_off, chain_pos, chain_rid, chain_alt, chain_frac,
        chain_nseeds, seed_rbeg, seed_qbeg, seed_len)
    return (chain_off, chain_pos, chain_rid, chain_alt, chain_frac,
            chain_nseeds, seed_rbeg, seed_qbeg, seed_len)


def chain_filter_batch(chain_off, chain_alt, chain_nseeds, seed_rbeg,
                       seed_qbeg, seed_len, opt):
    """Batched mem_chain_flt (see core.cpp): returns (out_off, out_idx,
    out_w, out_kept) — surviving chains per read in final sorted order."""
    n_reads = len(chain_off) - 1
    n_chains = int(chain_off[-1])
    out_off = np.zeros(n_reads + 1, np.int64)
    out_idx = np.zeros(max(n_chains, 1), np.int64)
    out_w = np.zeros(max(n_chains, 1), np.int32)
    out_kept = np.zeros(max(n_chains, 1), np.uint8)
    get_lib().chain_filter_batch(
        n_reads, np.ascontiguousarray(chain_off, np.int64),
        np.ascontiguousarray(chain_alt, np.uint8),
        np.ascontiguousarray(chain_nseeds, np.int32),
        np.ascontiguousarray(seed_rbeg, np.int64),
        np.ascontiguousarray(seed_qbeg, np.int32),
        np.ascontiguousarray(seed_len, np.int32),
        opt.min_chain_weight, opt.max_chain_gap, opt.max_chain_extend,
        opt.min_seed_len,
        ctypes.c_float(opt.mask_level), ctypes.c_float(opt.drop_ratio),
        out_off, out_idx, out_w, out_kept)
    return out_off, out_idx, out_w, out_kept

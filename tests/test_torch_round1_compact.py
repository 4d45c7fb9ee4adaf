"""The legacy round-1 seeding configuration of the port, and the one-phase
kswv and tile-form bsw_shear entries, against the JAX package on the CPU
(tolerance 0 throughout: every output is integer).

* index/klut.py's K-mer table equals the JAX package's build_klut.
* round1_walk_ref at K > 0 (the K-mer jump start) equals
  bwamem2_tpu.ops.smem.round1_kernel(lut_k=K); round1_compact_ref equals
  round1_compact_kernel at K = 0 and K = 6 on reads with N runs,
  homopolymers, reads shorter than K and a cap small enough that reads
  overflow; the kernel's read body (csrc/round1_compact.cuh with the
  LUT-start walk of fm_occ.cuh, compiled as host C++) equals it.
* TorchBackend(device="cpu", pivot_seeding=False).collect_smems equals the
  JAX DeviceBackend(pivot_seeding=False)'s and the host oracle, and its
  SAM of reads_se.fq and of the PE pair equals golden_se.sam /
  golden_pe.sam, with the K-mer table and without it.
* kswv_phase (the one-phase entry) equals bwamem2_tpu.ops.kswv.kswv_kernel
  with mixed target directions, live flags and stop scores, both classes;
  the kernel's group body (kswv_group.cuh:kswv_run_phase, host C++)
  equals kswv_phase_ref in every stripe bucket.
* bsw_shear_tiles equals bwamem2_tpu.ops.bsw.bsw_shear_kernel.
Inputs are made with numpy from fixed seeds.
"""

import ctypes
import os
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bwamem2_tpu.index.fmindex import FMIndex as JaxFMIndex
from bwamem2_tpu.index.klut import build_klut as jax_build_klut
from bwamem2_tpu.ops import smem as jsmem
from bwamem2_tpu.ops.backend import DeviceBackend
from bwamem2_tpu.ops.bsw import bsw_shear_kernel
from bwamem2_tpu.ops.device_index import DeviceFMIndex as JaxDFM
from bwamem2_tpu.ops.kswv import kswv_kernel
from bwamem2_tpu.options import MemOptions as JaxMemOptions
from bwamem2_tpu_torch.align.pipeline import Aligner
from bwamem2_tpu_torch.index.fmindex import FMIndex
from bwamem2_tpu_torch.index.klut import (build_klut, default_k,
                                          load_or_build_klut)
from bwamem2_tpu_torch.io.fastq import FastxReader, read_chunk
from bwamem2_tpu_torch.native import hostrt
from bwamem2_tpu_torch.ops import smem
from bwamem2_tpu_torch.ops.backend import ROUND1_CAP, TorchBackend
from bwamem2_tpu_torch.ops.bsw import bsw_shear_tiles
from bwamem2_tpu_torch.ops.bsw_shear_cuda import bsw_shear
from bwamem2_tpu_torch.ops.cuda_build import CSRC
from bwamem2_tpu_torch.ops.device_index import DeviceFMIndex
from bwamem2_tpu_torch.ops.kswv import NO_LIMIT, kswv_phase_ref
from bwamem2_tpu_torch.ops.kswv_cuda import kswv_phase
from bwamem2_tpu_torch.options import MEM_F_PE, MemOptions
from bwamem2_tpu_torch.utils.profiling import PROF

from conftest import DATA, FIXTURES
from test_torch_kswv import DEFAULT, GAPS, MIN_SEED_LEN, genome, windows

torch.set_num_threads(1)

PREFIX = os.path.join(FIXTURES, "ref_small.fa")
MSL = 19            # opt.min_seed_len


@pytest.fixture(scope="module")
def fm():
    return FMIndex.load(PREFIX)


@pytest.fixture(scope="module")
def jfm():
    return JaxFMIndex.load(PREFIX)


@pytest.fixture(scope="module")
def indexes(fm, jfm):
    """{K: (the port's CPU index, the JAX index)} with the K-mer table of
    depth K (none at 0)."""
    out = {}
    for K in (0, 4, 6):
        lut = build_klut(fm, K) if K else None
        jl = jax_build_klut(jfm, K)[1:] if K else None
        out[K] = (DeviceFMIndex.from_host(fm, "cpu", lut),
                  JaxDFM.from_host(jfm, lut=jl))
    return out


def legacy_reads(fm, n=48, L=104, seed=3):
    """n reads cut from the genome with 3 substitutions each, padded to L,
    with edges: N runs, every 7th code N, a homopolymer read, reads of 0,
    3 and 5 bases (shorter than K), an N at the first and last column and
    a random read."""
    rng = np.random.default_rng(seed)
    enc = np.full((n, L), 4, np.int8)
    lens = np.full(n, L, np.int32)
    for i in range(n):
        ln = int(rng.integers(L // 2, L + 1)) if i % 3 == 0 else L
        p = int(rng.integers(0, fm.l_pac - ln))
        enc[i, :ln] = fm.ref_string[p:p + ln]
        mut = rng.integers(0, ln, 3)
        enc[i, mut] = (enc[i, mut] + 1) % 4
        lens[i] = ln
    enc[1, 30:36] = 4
    enc[2, ::7] = 4
    enc[3, :] = 0                       # a homopolymer
    enc[4, :L // 2] = 2
    for i, ln in ((5, 0), (6, 3), (7, 5)):
        lens[i] = ln
        enc[i, ln:] = 4
    enc[8, 0] = 4
    enc[9, L - 1] = 4
    enc[10] = rng.integers(0, 4, L)
    return enc, lens


# -------------------------------------------------------------- the table
@pytest.mark.parametrize("K", [4, None], ids=["K4", "default_k"])
def test_klut_matches_jax(fm, jfm, K):
    got = build_klut(fm, K)
    want = jax_build_klut(jfm, K)
    assert got[0] == want[0] == (K or default_k(fm.l_pac))
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])
    assert got[1].dtype == got[2].dtype == np.int64
    assert (got[2] > 0).mean() > 0.9    # most K-mers occur


def test_klut_cache_only_with_a_prefix(fm, tmp_path):
    """No prefix: nothing is written; a prefix: {prefix}.klut{K}.npz, read
    back on the next call."""
    K, k, s = load_or_build_klut(fm, None, 4)
    assert not list(tmp_path.iterdir())
    pre = str(tmp_path / "idx")
    load_or_build_klut(fm, pre, 4)
    assert os.path.exists(pre + ".klut4.npz")
    K2, k2, s2 = load_or_build_klut(fm, pre, 4)
    assert K2 == K == 4
    np.testing.assert_array_equal(k2, k)
    np.testing.assert_array_equal(s2, s)


def test_index_carries_the_table(fm, indexes):
    dfm0, _ = indexes[0]
    assert dfm0.lut_depth == 0 and dfm0.lut_start.shape == (1,)
    dfm, _ = indexes[6]
    assert dfm.lut_depth == 6
    assert dfm.lut_start.dtype == dfm.lut_size.dtype == torch.int64
    assert dfm.lut_start.shape == dfm.lut_size.shape == (4 ** 6,)


# -------------------------------------------------- walk and compaction
@pytest.mark.parametrize("K", [4, 6])
def test_round1_walk_ref_with_lut_matches_jax(fm, indexes, K):
    dfm, jdfm = indexes[K]
    enc, lens = legacy_reads(fm)
    want = jsmem.round1_kernel(jdfm, jnp.asarray(enc), jnp.asarray(lens), K)
    st0, st = {}, {}
    e, ln = torch.from_numpy(enc), torch.from_numpy(lens)
    got = smem.round1_walk_ref(dfm, e, ln, st, K)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # the table saves steps and changes no output
    plain = smem.round1_walk_ref(indexes[0][0], e, ln, st0)
    for g, w in zip(got, plain):
        np.testing.assert_array_equal(g.numpy(), w.numpy())
    assert st["lut_rows"] > 0 and st["steps"] < st0["steps"]


@pytest.mark.parametrize("K,cap", [(0, ROUND1_CAP), (0, 2), (6, ROUND1_CAP),
                                   (6, 2)])
def test_round1_compact_ref_matches_jax(fm, indexes, K, cap):
    dfm, jdfm = indexes[K]
    enc, lens = legacy_reads(fm)
    msl = MSL if cap == ROUND1_CAP else 8
    want = jsmem.round1_compact_kernel(jdfm, jnp.asarray(enc),
                                       jnp.asarray(lens), K,
                                       jnp.int32(msl), cap)
    n0 = smem.round1_compact.plain_calls
    got = smem.round1_compact(dfm, torch.from_numpy(enc),
                              torch.from_numpy(lens), K, msl, cap)
    assert smem.round1_compact.plain_calls == n0 + 1
    for g, w, dt in zip(got, want, (torch.int32,) * 4 + (torch.int64,)):
        assert g.dtype == dt
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    cnt = got[0].numpy()
    if cap == 2:
        assert (cnt > cap).sum() >= 3        # reads that overflow
    assert (cnt > 0).sum() > 20


SHIM = r'''
// the steps by class: both ends in one block, s = 1, and s = 1 where the
// step (fm_lf_step's) empties the interval
static long long walk_cls[3];
#define FM_WALK_STEP_HOOK(f, k, s, c) do { \
    int64_t k_, s_; \
    fm_lf_step(f, k, s, c, &k_, &s_); \
    walk_cls[0] += ((k) >> 6) == (((k) + (s)) >> 6); \
    walk_cls[1] += (s) == 1; \
    walk_cls[2] += (s) == 1 && s_ <= 0; \
  } while (0)
#include "round1_compact.cuh"
static FmView view(const int32_t *occp, const int32_t *occ_hi, int has_hi,
                   const int64_t *c, int64_t sent) {
  return FmView{occp, occ_hi, {c[0], c[1], c[2], c[3], c[4]}, sent, has_hi};
}
extern "C" void h_r1c(const int32_t *occp, const int32_t *occ_hi,
                      int has_hi, const int64_t *counts, int64_t sent,
                      const int64_t *lk, const int64_t *ls, int K,
                      const int8_t *enc, const int *lens, int N, int L,
                      int min_len, int cap, int *cnt, int *on, int *ob,
                      int *os, int64_t *ok, long long *cls) {
  const FmView f = view(occp, occ_hi, has_hi, counts, sent);
  const FmLut lut{lk, ls, K};
  const SmemGroup<32> g;
  walk_cls[0] = walk_cls[1] = walk_cls[2] = 0;
  for (int r = 0; r < N; ++r) {
    const int len = lens[r] < L ? lens[r] : L;
    const long long o = (long long)r * cap;
    cnt[r] = K ? r1c_read<true>(g, f, lut, enc + (long long)r * L, len,
                                min_len, cap, on + o, ob + o, os + o, ok + o)
               : r1c_read<false>(g, f, lut, enc + (long long)r * L, len,
                                 min_len, cap, on + o, ob + o, os + o,
                                 ok + o);
  }
  for (int i = 0; i < 3; ++i) cls[i] = walk_cls[i];
}
extern "C" long long h_walk(const int32_t *occp, const int32_t *occ_hi,
                            int has_hi, const int64_t *counts, int64_t sent,
                            const int64_t *lk, const int64_t *ls, int K,
                            const int8_t *enc, const int *lens, int N, int L,
                            int *b, int64_t *k, int64_t *s,
                            long long *cls) {
  const FmView f = view(occp, occ_hi, has_hi, counts, sent);
  const FmLut lut{lk, ls, K};
  long long steps = 0;
  walk_cls[0] = walk_cls[1] = walk_cls[2] = 0;
  for (long long t = 0; t < (long long)N * L; ++t) {
    const long long r = t / L;
    const int n = (int)(t - r * L);
    steps += K ? fm_round1_walk_lut<true>(f, lut, enc + r * L, lens[r], n,
                                          b + t, k + t, s + t)
               : fm_round1_walk(f, enc + r * L, lens[r], n, b + t, k + t,
                                s + t);
  }
  for (int i = 0; i < 3; ++i) cls[i] = walk_cls[i];
  return steps;
}
'''


@pytest.fixture(scope="module")
def host_r1c(tmp_path_factory):
    """csrc/round1_compact.cuh (and fm_occ.cuh's walks) built as host C++:
    the warp is smem_group.cuh's host SmemGroup<32>, its lanes stepped in
    lockstep, and a per-read loop stands in for the launch."""
    d = tmp_path_factory.mktemp("r1c")
    src = d / "r1c.cpp"
    src.write_text(SHIM)
    so = str(d / "r1c.so")
    subprocess.run(["g++", "-O2", "-std=c++17", "-shared", "-fPIC", "-I",
                    CSRC, str(src), "-o", so], check=True,
                   capture_output=True)
    lib = ctypes.CDLL(so)
    lib.h_walk.restype = ctypes.c_longlong
    return lib


def _host_args(dfm, K):
    keep = [np.ascontiguousarray(x.numpy()) for x in (
        dfm.occp, dfm.occ_hi, dfm.counts, dfm.lut_start, dfm.lut_size)]
    p = lambda a: ctypes.c_void_p(a.ctypes.data)  # noqa: E731
    return keep, [p(keep[0]), p(keep[1]), ctypes.c_int(dfm.has_hi),
                  p(keep[2]), ctypes.c_int64(int(dfm.sentinel)), p(keep[3]),
                  p(keep[4]), ctypes.c_int(K)]


@pytest.mark.parametrize("K", [0, 6])
@pytest.mark.parametrize("cap", [ROUND1_CAP, 2])
def test_round1_compact_body_source_matches_ref(fm, indexes, host_r1c, K,
                                                cap):
    """The kernel's read body, built with g++ as the launch runs it (one
    lane group per read, 32 columns a pass, reads longer than a pass),
    equals round1_compact_ref, the slots of overflowing reads and the
    empty slots included, and its walks take as many one-row steps (both
    ends in one block), steps at s = 1 and steps at s = 1 that empty the
    interval as the plain version counts."""
    dfm, _ = indexes[K]
    enc, lens = legacy_reads(fm, n=40, L=152, seed=11)
    N, L = enc.shape
    keep, args = _host_args(dfm, K)
    p = lambda a: ctypes.c_void_p(a.ctypes.data)  # noqa: E731
    msl = MSL if cap == ROUND1_CAP else 8
    cnt = np.full(N, -7, np.int32)
    on, ob, os_ = (np.full((N, cap), -7, np.int32) for _ in range(3))
    ok = np.full((N, cap), -7, np.int64)
    cls = np.zeros(3, np.int64)
    host_r1c.h_r1c(*args, p(enc), p(lens), ctypes.c_int(N),
                   ctypes.c_int(L), ctypes.c_int(msl), ctypes.c_int(cap),
                   p(cnt), p(on), p(ob), p(os_), p(ok), p(cls))
    st: dict = {}
    want = smem.round1_compact_ref(dfm, torch.from_numpy(enc),
                                   torch.from_numpy(lens), K, msl, cap, st)
    for g, w in zip((cnt, on, ob, os_, ok), want):
        np.testing.assert_array_equal(g, w.numpy())
    # the walk's steps by class: one row (both ends in a block), s = 1,
    # s = 1 emptying the interval
    assert list(cls) == [st["one_block"], st["single"],
                         st["single_empty"]]
    assert 0 < st["single"] < st["one_block"] < st["steps"]
    assert 0 < st["single_empty"] < st["single"]
    if cap == 2:
        assert (cnt > cap).sum() >= 3


@pytest.mark.parametrize("K", [0, 4, 6])
def test_lut_walk_source_matches_ref(fm, indexes, host_r1c, K):
    """fm_occ.cuh's walk with the LUT start (K > 0) and from scratch, built
    with g++, equals round1_walk_ref, LF steps included (in all, with both
    ends in one block, at s = 1 and at s = 1 emptying the interval)."""
    dfm, _ = indexes[K]
    enc, lens = legacy_reads(fm, n=24, L=96, seed=5)
    N, L = enc.shape
    keep, args = _host_args(dfm, K)
    p = lambda a: ctypes.c_void_p(a.ctypes.data)  # noqa: E731
    b = np.zeros((N, L), np.int32)
    k = np.zeros((N, L), np.int64)
    s = np.zeros((N, L), np.int64)
    cls = np.zeros(3, np.int64)
    steps = host_r1c.h_walk(*args, p(enc), p(lens), ctypes.c_int(N),
                            ctypes.c_int(L), p(b), p(k), p(s), p(cls))
    st: dict = {}
    want = smem.round1_walk_ref(dfm, torch.from_numpy(enc),
                                torch.from_numpy(lens), st, K)
    for g, w in zip((b, k, s), want):
        np.testing.assert_array_equal(g, w.numpy())
    assert steps == st["steps"] > 0
    assert list(cls) == [st["one_block"], st["single"],
                         st["single_empty"]]
    assert 0 < st["single"] < st["one_block"] < st["steps"]
    assert 0 < st["single_empty"] < st["single"]


def test_round1_compact_refuses_cpu_launch_and_wrong_depth(fm, indexes):
    """The CPU runs the plain version only through __call__; the launch
    raises for anything but CUDA, and a K the index's table does not
    have raises in the plain version too."""
    dfm, _ = indexes[6]
    enc, lens = legacy_reads(fm, n=16)
    e, ln = torch.from_numpy(enc), torch.from_numpy(lens)
    n0 = (smem.round1_compact.plain_calls, smem.round1_compact.launches)
    with pytest.raises(ValueError, match="CUDA"):
        smem.round1_compact.launch(dfm, e, ln, 6, MSL, ROUND1_CAP)
    with pytest.raises(ValueError, match="depth 6"):
        smem.round1_compact(dfm, e, ln, 4, MSL, ROUND1_CAP)
    assert smem.round1_compact.launches == n0[1]


# ------------------------------------------------------------ backend
@pytest.fixture(scope="module")
def grid_reads(fm):
    """60 reads of the SE fixture and 24 genome slices with N bases."""
    from bwamem2_tpu_torch.align.seeding import encode_reads
    reads = read_chunk(FastxReader(os.path.join(DATA, "reads_se.fq")), None,
                       10**9)[:60]
    encs = encode_reads([r.seq for r in reads])
    rng = np.random.default_rng(7)
    for _ in range(24):
        p = int(rng.integers(0, 4000))
        s = fm.ref_string[p:p + 120].astype(np.uint8).copy()
        s[rng.integers(0, 120, 3)] = 4
        encs.append(s)
    return encs


def drop_l(per_read):
    return [[t[1:4] + t[5:] for t in r] for r in per_read]


@pytest.mark.parametrize("klut", [False, True], ids=["K0", "lut"])
def test_legacy_collect_smems_matches_jax_backend(fm, jfm, grid_reads,
                                                  klut):
    opt = MemOptions().finalize()
    be = TorchBackend(fm, opt, device="cpu", pivot_seeding=False,
                      use_klut=klut)
    assert be.lut_k == (default_k(fm.l_pac) if klut else 0)
    assert be.collect_chunk(grid_reads, opt) is None
    n0 = (smem.round1_compact.plain_calls, smem.round1_chain.plain_calls)
    got = be.collect_smems(grid_reads, opt)
    assert smem.round1_compact.plain_calls == n0[0] + 1
    assert smem.round1_chain.plain_calls == n0[1]   # no pivot chain
    jbe = DeviceBackend(jfm, JaxMemOptions().finalize(), pivot_seeding=False,
                        use_klut=klut)
    assert jbe.lut_k_bits == be.lut_k
    want = jbe.collect_smems(grid_reads, JaxMemOptions().finalize())
    assert drop_l(got) == drop_l(want)
    assert sum(map(len, got)) > 400
    assert drop_l(got) == drop_l(hostrt.collect_smems_reads(fm, grid_reads,
                                                            opt))
    assert be.launches == {}


def test_legacy_overflow_goes_to_the_oracle(fm, grid_reads, monkeypatch):
    """Reads with more round-1 SMEMs than ROUND1_CAP take the host oracle
    (counted as overflow.r1_compact_cap) and change no output."""
    import bwamem2_tpu_torch.ops.backend as backend
    opt = MemOptions().finalize()
    be = TorchBackend(fm, opt, device="cpu", pivot_seeding=False,
                      use_klut=False)
    monkeypatch.setattr(backend, "ROUND1_CAP", 1)
    c0, t0 = (PROF.c["overflow.r1_compact_cap"],
              PROF.ctot["overflow.r1_compact_cap"])
    got = be.collect_smems(grid_reads, opt)
    n = PROF.c["overflow.r1_compact_cap"] - c0
    assert PROF.ctot["overflow.r1_compact_cap"] - t0 == len(grid_reads)
    assert 5 <= n < len(grid_reads)
    assert drop_l(got) == drop_l(hostrt.collect_smems_reads(fm, grid_reads,
                                                            opt))


def test_legacy_round1_takes_no_sharded_index(fm):
    with pytest.raises(ValueError, match="pivot chain"):
        TorchBackend(fm, MemOptions().finalize(), devices=["cpu"] * 2,
                     sharded=True, pivot_seeding=False)


def golden(name):
    with open(os.path.join(FIXTURES, name)) as f:
        return [ln for ln in f if not ln.startswith("@")]


@pytest.mark.parametrize("klut", [False, True], ids=["K0", "lut"])
@pytest.mark.parametrize("pe", [False, True], ids=["se", "pe"])
def test_legacy_golden_on_cpu(fm, pe, klut):
    opt = MemOptions().finalize()
    if pe:
        opt.flag |= MEM_F_PE
        reads = read_chunk(FastxReader(os.path.join(DATA, "reads_r1.fq")),
                           FastxReader(os.path.join(DATA, "reads_r2.fq")),
                           10**9)
    else:
        reads = read_chunk(FastxReader(os.path.join(DATA, "reads_se.fq")),
                           None, 10**9)
    be = TorchBackend(fm, opt, device="cpu", pivot_seeding=False,
                      use_klut=klut)
    n0 = smem.round1_compact.plain_calls
    Aligner(fm, opt, backend=be, verbose=0).process(reads, 0)
    assert smem.round1_compact.plain_calls == n0 + 1
    ours = "".join(r.sam for r in reads).splitlines(keepends=True)
    assert ours == golden("golden_pe.sam" if pe else "golden_se.sam")


# ------------------------------------------------------ one-phase kswv
def phase_inputs(win, seed):
    """The windows of tests/test_torch_kswv.py with every third problem's
    target walked backward from its end, every fifth not live and stop
    scores mixed (none, 20, 35)."""
    enc, qoff, qdir, qcomp, qlen, toff, tlen = windows(win)
    P = len(qoff)
    rng = np.random.default_rng(seed)
    tdir = np.where(np.arange(P) % 3 == 1, -1, 1).astype(np.int32)
    toff = np.where(tdir < 0, toff + tlen - 1, toff).astype(np.int64)
    endsc = rng.choice(np.array([NO_LIMIT, 20, 35], np.int32), P)
    live = np.arange(P) % 5 != 2
    return (enc, qoff, qdir, qcomp, qlen, toff, tdir, tlen,
            endsc.astype(np.int32), live)


KSWV_PHASE_CASES = {   # name: (windows, Qmax, Tmax, u8, scoring, minsc)
    "u8": ("u8", 128, 608, True, DEFAULT, MIN_SEED_LEN),
    "u8_gaps_no_second": ("u8", 128, 608, True, GAPS, None),
    "i16": ("i16", 512, 2048, False, DEFAULT, MIN_SEED_LEN),
    "u8_main": ("main", 160, 700, True, DEFAULT, MIN_SEED_LEN),
}


@pytest.mark.parametrize("name", list(KSWV_PHASE_CASES))
def test_kswv_phase_matches_jax_kernel(name):
    win, Qmax, Tmax, u8, sc, msl = KSWV_PHASE_CASES[name]
    minsc = NO_LIMIT if msl is None else msl * sc[0]
    x = phase_inputs(win, 5)
    want = np.asarray(kswv_kernel(
        jnp.asarray(genome()), *(jnp.asarray(a) for a in x), Qmax, Tmax,
        minsc, *sc, False, u8))
    n0 = (kswv_phase.plain_calls, kswv_phase.launches)
    got = kswv_phase(torch.from_numpy(genome()),
                     *(torch.from_numpy(np.ascontiguousarray(a)) for a in x),
                     Qmax, Tmax, minsc, *sc, False, u8)
    assert (kswv_phase.plain_calls, kswv_phase.launches) == (n0[0] + 1,
                                                             n0[1])
    np.testing.assert_array_equal(got.numpy(), want)
    live = x[-1]
    assert (got.numpy()[~live, 1] == -1).all()
    assert (got.numpy()[live, 0] > 0).any()


@pytest.fixture(scope="module")
def host_phase(tmp_path_factory):
    """kswv_group.cuh's one-phase body built as host C++ (its lane groups
    int[NL] vectors stepped in lockstep), a per-problem loop for the
    launch; force_ptr selects the shared-memory stripes."""
    d = tmp_path_factory.mktemp("kswv_phase")
    shim = d / "shim.cpp"
    shim.write_text(r'''
#include <vector>
#define BSW_HD static inline
#include "kswv_group.cuh"
template <bool U8, int SMAX>
static void run_all(const KswvBatch &b, const KswvPhaseArgs &a) {
  std::vector<int16_t> stripes(kswv_group_bytes(b.Qmax) / 2);
  const KswvGroup<U8 ? 16 : 8> g;
  for (int p = 0; p < b.P; ++p)
    kswv_run_phase<U8, SMAX>(g, b, a, p, stripes.data());
}
extern "C" int kswv_phase_host(const int8_t *enc, int64_t n_enc,
    const uint8_t *ref, int64_t n_ref, const int *qoff, const int *qdir,
    const uint8_t *qcomp, const int *qlen, const int64_t *toff,
    const int *tdir, const int *tlen, const int *endsc,
    const uint8_t *live, int P, int Qmax, int Tmax, int Tpad, int u8,
    int minsc, const int *sc, int force_ptr, int16_t *rowmax, int *out) {
  const KswvBatch b{enc, n_enc, ref, n_ref, 0, qoff, qdir, qcomp, qlen,
                    toff, tlen, P, Qmax, Tmax, Tpad, minsc,
                    {sc[0], sc[1], sc[2], sc[3], sc[4], sc[5]}, rowmax, out};
  const KswvPhaseArgs a{tdir, endsc, live};
  const int smax = force_ptr ? 0 : kswv_bucket(u8, Qmax);
#define KSWV_HOST_CASE(U, S) if (!!u8 == U && smax == S) run_all<U, S>(b, a);
  KSWV_BUCKETS(KSWV_HOST_CASE)
  return smax;
}
''')
    so = d / "kswv_phase.so"
    subprocess.run(["g++", "-O2", "-std=c++17", "-shared", "-fPIC",
                    "-I", CSRC, str(shim), "-o", str(so)],
                   check=True, capture_output=True)
    return ctypes.CDLL(str(so))


@pytest.mark.parametrize("name,force_ptr,bucket", [
    ("u8", False, 8), ("u8", True, 0), ("i16", False, 0),
    ("u8_main", False, 12), ("u8_gaps_no_second", False, 8)])
def test_kswv_phase_source_matches_ref(host_phase, name, force_ptr, bucket):
    win, Qmax, Tmax, u8, sc, msl = KSWV_PHASE_CASES[name]
    minsc = NO_LIMIT if msl is None else msl * sc[0]
    x = phase_inputs(win, 9)
    enc, qoff, qdir, qcomp, qlen, toff, tdir, tlen, endsc, live = x
    P = len(qoff)
    keep = [np.ascontiguousarray(a) for a in (
        enc, genome(), qoff, qdir, qcomp.astype(np.uint8), qlen, toff, tdir,
        tlen, endsc, live.astype(np.uint8), np.array(sc, np.int32))]
    Tpad = -(-Tmax // 8) * 8
    rowmax = np.zeros(Tpad * P, np.int16)
    out = np.zeros((P, 6), np.int32)
    p = lambda a: ctypes.c_void_p(a.ctypes.data)  # noqa: E731
    e, r, *rest, scv = keep
    smax = host_phase.kswv_phase_host(
        p(e), ctypes.c_int64(e.size), p(r), ctypes.c_int64(r.size),
        *[p(a) for a in rest], ctypes.c_int(P), ctypes.c_int(Qmax),
        ctypes.c_int(Tmax), ctypes.c_int(Tpad), ctypes.c_int(u8),
        ctypes.c_int(minsc), p(scv), ctypes.c_int(int(force_ptr)),
        p(rowmax), p(out))
    assert smax == bucket
    want = kswv_phase_ref(torch.from_numpy(genome()),
                          *(torch.from_numpy(np.ascontiguousarray(a))
                            for a in x), Qmax, Tmax, minsc, *sc, False, u8)
    np.testing.assert_array_equal(out, want.numpy())


# ------------------------------------------------ bsw_shear over tiles
def shear_tiles(seed, P, qr, extra, err=0.08):
    """P (q, t) tiles: a target and a query mutated from its start (~err
    substitutions, insertions and deletions), N codes in one pair in
    seven, padding 4."""
    rng = np.random.default_rng(seed)
    qs, ts = [], []
    for i in range(P):
        ql = int(rng.integers(*qr))
        t = rng.integers(0, 4, ql + int(rng.integers(0, extra)), np.int8)
        q = []
        for c in t[:ql]:
            r = rng.random()
            if r < err * 0.6:
                q.append(rng.integers(0, 4))
            elif r < err * 0.8:
                q += [rng.integers(0, 4), c]
            elif r >= err:
                q.append(c)
        q = np.array(q[:ql] or [t[0]], np.int8)
        if i % 7 == 3:
            q[len(q) // 2] = 4
        qs.append(q)
        ts.append(t)
    qlen = np.array([len(q) for q in qs], np.int32)
    tlen = np.array([len(t) for t in ts], np.int32)
    qt = np.full((P, int(qlen.max())), 4, np.int8)
    tt = np.full((P, int(tlen.max())), 4, np.int8)
    for i in range(P):
        qt[i, :qlen[i]] = qs[i]
        tt[i, :tlen[i]] = ts[i]
    return qt, tt, qlen, tlen


@pytest.mark.parametrize("Wh,h0max", [(100, 4000), (60, 40000)],
                         ids=["16bit", "mixed"])
def test_bsw_shear_tiles_matches_jax_kernel(Wh, h0max):
    """Every pair fits 16 bits (h0 up to 4,000), or some do not (h0 up to
    40,000): the tiles reach bsw_shear in its dispatch order, both bodies'
    shares, and come back in tile order."""
    q, t, qlen, tlen = shear_tiles(13 + Wh, 20, (50, 900), 200)
    P = len(qlen)
    rng = np.random.default_rng(Wh)
    h0 = rng.integers(17, h0max, P).astype(np.int32)
    w = np.full(P, Wh, np.int32)
    sc = (1, 4, 6, 1, 6, 1)
    W = -(-(2 * Wh + 2) // 128) * 128
    want = np.asarray(bsw_shear_kernel(
        jnp.asarray(q), jnp.asarray(t), jnp.asarray(qlen), jnp.asarray(tlen),
        jnp.asarray(h0), jnp.asarray(w), 1, 4, Wh, W, 6, 1, 6, 1, 100, 5,
        1))
    n0 = bsw_shear.plain_calls
    got = bsw_shear_tiles(*(torch.from_numpy(a) for a in (q, t, qlen, tlen,
                                                           h0, w)),
                          Wh, *sc, 100, 5, 1)
    assert bsw_shear.plain_calls == n0 + 1
    np.testing.assert_array_equal(got.numpy(), want)
    fit = bsw_shear.fits16(qlen, h0, Wh, *sc, 1)
    assert fit.any() and (fit.all() == (h0max < 30000))
    assert (got.numpy()[:, 0] > h0).any()


# ------------------------------------------------------ kernel_micro
def test_kernel_micro_needs_a_card_and_prints_every_kernel(
        monkeypatch, tmp_path, capsys):
    """The entry raises on the default device without a card (no silent
    CPU run); with --device cpu (the plain versions, shapes cut down, a
    93 kb genome made under tmp_path) it prints one line per kernel in the
    JAX tool's order plus round1_compact and bsw_shear_tiles."""
    from bwamem2_tpu_torch.tools import kernel_micro as km
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            km.main([])
    monkeypatch.setattr(km, "REPO", str(tmp_path))
    for name, v in (("N_READS", 64), ("N_PIVOTS", 144), ("N_SA", 512),
                    ("BSW_RUNGS", ((16, 127, 96),)),
                    ("KSWV_SHAPES", ((8, 160, 512),)),
                    ("SHEAR_TILE", (3, (200, 400), 50))):
        monkeypatch.setattr(km, name, v)
    n0 = (kswv_phase.plain_calls, bsw_shear.plain_calls)
    assert km.main(["--device", "cpu", "--scale", "0.002", "--reps",
                    "1"]) == 0
    lines = capsys.readouterr().out.splitlines()
    names = [ln.split()[0] for ln in lines[2:]]
    assert names == ["round1_chain", "round2_forward", "round2_backward",
                     "round3_replay", "round1_compact", "sa_resolve",
                     "bsw_extend", "kswv_phase", "bsw_shear_tiles"]
    assert all(ln.endswith(" ms") for ln in lines[2:])
    assert kswv_phase.plain_calls == n0[0] + 2      # a warm call and one
    assert bsw_shear.plain_calls == n0[1] + 2
    assert os.path.exists(tmp_path / ".tmp" / "bench_scale0.002" /
                          "genome.fa.bwt.2bit.64")

"""The fused seed-extend step of the port against the JAX package's, exact
(tolerance 0: integer outputs), on the CPU.

* round1_walk_ref equals bwamem2_tpu.ops.smem.round1_kernel (lut_k = 0) on
  the tiny index's mutated reads (as tests/test_mesh.py builds them) and
  on reads with N codes, short and empty lengths; the kernel's lane walk
  (csrc/fm_occ.cuh:fm_round1_walk, compiled as host C++) equals it, LF
  step counts included (in all, with both ends in one block, at s = 1,
  at s = 1 emptying the interval);
  its LF steps (fm_walk_step, and fm_walk_single at s = 1) equal
  fm_lf_step on every base and every (k, s) starting in the first, the
  sentinel's and the last block, and in every block of an index with the
  count-hi plane.
* bsw_tiles equals bwamem2_tpu.ops.bsw.bsw_kernel on random tiles at
  several (Qmax, Tmax, w, h0).
* seed_extend_step equals the JAX seed_extend_step, all five outputs, on
  the compile-check batch of __graft_entry__.py and on edge reads; on a
  2-bit packed genome it equals the unpacked step.
"""

import ctypes
import os
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bwamem2_tpu.index.fmindex import FMIndex as JaxFMIndex
from bwamem2_tpu.ops import bsw as jbsw
from bwamem2_tpu.ops.device_index import DeviceFMIndex as JaxDFM
from bwamem2_tpu.ops.entry import seed_extend_step as jax_step
from bwamem2_tpu.ops.smem import round1_kernel
from bwamem2_tpu_torch.index.fmindex import FMIndex
from bwamem2_tpu_torch.ops.bsw import bsw_tiles
from bwamem2_tpu_torch.ops.cuda_build import CSRC
from bwamem2_tpu_torch.ops.device_index import DeviceFMIndex
from bwamem2_tpu_torch.ops.entry import seed_extend_step
from bwamem2_tpu_torch.ops.smem import round1_walk, round1_walk_ref

from conftest import FIXTURES
from test_torch_device_index import synthetic_hi

# one intra-op thread: the suite runs several xdist workers side by side
torch.set_num_threads(1)

TINY = os.path.join(FIXTURES, "ref_tiny.fa")
SMALL = os.path.join(FIXTURES, "ref_small.fa")


def mutated_batch(fm, n, L, seed, edges=False):
    """n reads of L bases cut from the genome with 3 substitutions each
    (tests/test_mesh.py, __graft_entry__.py:_example_batch); with edges,
    reads with N runs, a short read, an empty read and a random read."""
    rng = np.random.default_rng(seed)
    enc = np.full((n, L), 4, np.int32)
    lens = np.full((n,), L, np.int32)
    for i in range(n):
        p = int(rng.integers(0, fm.l_pac - L))
        enc[i] = fm.ref_string[p:p + L]
        mut = rng.integers(0, L, 3)
        enc[i, mut] = (enc[i, mut] + 1) % 4
    if edges:
        enc[1, 40:45] = 4
        enc[2, ::9] = 4
        lens[3] = 37
        enc[3, 37:] = 4
        lens[4] = 0
        enc[4] = 4
        lens[5] = 1
        enc[6] = rng.integers(0, 4, L)
        enc[7, 0] = 4
        enc[8, L - 1] = 4
    return enc, lens


@pytest.fixture(scope="module", params=[TINY, SMALL], ids=["tiny", "small"])
def index(request):
    fm = FMIndex.load(request.param)
    return (fm, DeviceFMIndex.from_host(fm, "cpu"),
            JaxDFM.from_host(JaxFMIndex.load(request.param)))


@pytest.mark.parametrize("edges", [False, True], ids=["mesh", "edges"])
def test_round1_walk_ref_matches_jax(index, edges):
    fm, dfm, jdfm = index
    enc, lens = mutated_batch(fm, 16, 128, 0, edges)
    want = round1_kernel(jdfm, jnp.asarray(enc.astype(np.int8)),
                         jnp.asarray(lens))
    n0 = round1_walk.plain_calls
    got = round1_walk(dfm, torch.from_numpy(enc.astype(np.int8)),
                      torch.from_numpy(lens))
    assert round1_walk.plain_calls == n0 + 1
    for g, w, dt in zip(got, want, (torch.int32, torch.int64, torch.int64)):
        assert g.dtype == dt
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # real walks: most lanes extend past their end column
    assert (got[0].numpy() < np.arange(128)).mean() > 0.5


# the kernel's lane walk and its LF steps built as host C++: h_round1 runs
# the walk of every (read, end) lane, counting the steps whose two ends
# share a block, those at s = 1 and those of them that empty the interval
# (FM_WALK_STEP_HOOK); h_step_sweep holds
# fm_walk_step and fm_walk_single against fm_lf_step on every c and every
# (k, s) with k in the given blocks
SHIM = r"""
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
#include "fm_occ.cuh"
static FmView mk(const int32_t *occp, const int32_t *occ_hi, int has_hi,
                 const int64_t *counts, int64_t sent) {
  return FmView{occp, occ_hi, {counts[0], counts[1], counts[2], counts[3],
                               counts[4]}, sent, has_hi};
}
extern "C" long long h_round1(const int32_t *occp, const int32_t *occ_hi,
                              int has_hi, const int64_t *counts,
                              int64_t sent, const int8_t *enc,
                              const int *lens, int N, int L, int *b,
                              int64_t *k, int64_t *s, long long *cls) {
  const FmView f = mk(occp, occ_hi, has_hi, counts, sent);
  long long steps = 0;
  walk_cls[0] = walk_cls[1] = walk_cls[2] = 0;
  for (long long t = 0; t < (long long)N * L; ++t) {
    const long long r = t / L;
    steps += fm_round1_walk(f, enc + r * L, lens[r], (int)(t - r * L),
                            b + t, k + t, s + t);
  }
  for (int i = 0; i < 3; ++i) cls[i] = walk_cls[i];
  return steps;
}
// fm_walk_step (every s) and fm_walk_single (s = 1) against fm_lf_step;
// cases [0] all, [1] one block, [2] s = 1 at k & 63 == 63, [3] k & 63 +
// s == 64, [4] s = 1 with s' = 1; returns the cases whose (k', s') differ
template <bool HI>
static long long sweep(const FmView &f, int64_t n, const int64_t *blocks,
                       int nblk, long long *cases) {
  long long bad = 0;
  for (int i = 0; i < nblk; ++i)
    for (int64_t k = blocks[i] * 64; k < blocks[i] * 64 + 64 && k <= n; ++k)
      for (int64_t s = 0; k + s <= n; ++s)
        for (int c = 0; c < 4; ++c) {
          int64_t k1, s1, k2, s2;
          fm_lf_step(f, k, s, c, &k1, &s1);
          fm_walk_step<HI>(f, k, s, c, &k2, &s2);
          bad += k1 != k2 || s1 != s2;
          if (s == 1) {
            int64_t k3 = -1;
            const int s3 = fm_walk_single<HI>(f, k, c, &k3);
            bad += s3 != s1 || (s3 == 1 && k3 != k1);
            cases[4] += s3 == 1;
          }
          cases[0] += 1;
          cases[1] += (k >> 6) == ((k + s) >> 6);
          cases[2] += s == 1 && (k & 63) == 63;
          cases[3] += (k & 63) + s == 64;
        }
  return bad;
}
extern "C" long long h_step_sweep(const int32_t *occp, const int32_t *occ_hi,
                                  int has_hi, const int64_t *counts,
                                  int64_t sent, int64_t n,
                                  const int64_t *blocks, int nblk,
                                  long long *cases) {
  const FmView f = mk(occp, occ_hi, has_hi, counts, sent);
  return has_hi ? sweep<true>(f, n, blocks, nblk, cases)
                : sweep<false>(f, n, blocks, nblk, cases);
}
"""


@pytest.fixture(scope="module")
def host_walk(tmp_path_factory):
    d = tmp_path_factory.mktemp("r1walk")
    src = d / "r1.cpp"
    src.write_text(SHIM)
    so = str(d / "r1.so")
    subprocess.run(["g++", "-O2", "-std=c++17", "-shared", "-fPIC", "-I",
                    CSRC, str(src), "-o", so], check=True,
                   capture_output=True)
    lib = ctypes.CDLL(so)
    lib.h_round1.restype = lib.h_step_sweep.restype = ctypes.c_longlong
    return lib


def _p(a):
    return ctypes.c_void_p(a.ctypes.data)


def _fm_args(dfm):
    """(arrays to keep alive through the call, the FmView arguments)."""
    keep = [np.ascontiguousarray(x.numpy()) for x in
            (dfm.occp, dfm.occ_hi, dfm.counts)]
    return keep, [_p(keep[0]), _p(keep[1]), ctypes.c_int(int(dfm.has_hi)),
                  _p(keep[2]), ctypes.c_int64(int(dfm.sentinel))]


def test_round1_lane_walk_source_matches_ref(index, host_walk):
    """The kernel's per-lane walk, built with g++ as the kernel's launch
    loop would run it (one lane per (read, end)), equals round1_walk_ref,
    and takes the LF steps the plain version counts, with as many whose
    two ends share a block, as many at s = 1 and as many of those that
    empty the interval."""
    fm, dfm, _ = index
    enc, lens = mutated_batch(fm, 24, 96, 5, edges=True)
    enc = np.ascontiguousarray(enc.astype(np.int8))
    N, L = enc.shape
    b = np.zeros((N, L), np.int32)
    k = np.zeros((N, L), np.int64)
    s = np.zeros((N, L), np.int64)
    cls = np.zeros(3, np.int64)
    keep, args = _fm_args(dfm)
    steps = host_walk.h_round1(*args, _p(enc), _p(lens), ctypes.c_int(N),
                               ctypes.c_int(L), _p(b), _p(k), _p(s),
                               _p(cls))
    stats = {}
    want = round1_walk_ref(dfm, torch.from_numpy(enc),
                           torch.from_numpy(lens), stats)
    for g, w in zip((b, k, s), want):
        np.testing.assert_array_equal(g, w.numpy())
    assert steps == stats["steps"] > N * L
    assert 0 < stats["rows"] <= dfm.occp.shape[0]
    assert list(cls) == [stats["one_block"], stats["single"],
                         stats["single_empty"]]
    assert 0 < stats["single"] < stats["one_block"] < stats["steps"]
    assert 0 < stats["single_empty"] < stats["single"]


@pytest.mark.parametrize("which", ["tiny", "has_hi"])
def test_walk_step_matches_lf_step_exhaustively(host_walk, which):
    """The walk's LF steps equal fm_lf_step on every base and every (k, s),
    k + s up to the BWT length, with k in the first, the sentinel's and the
    last block of ref_tiny.fa's index, and in every block of the has_hi
    synthetic index (counts above 2^32, a negative packed hi word):
    fm_walk_step at every s, fm_walk_single (one row, one count) at s = 1,
    k & 63 == 63 and k & 63 + s == 64 included."""
    if which == "tiny":
        fm = FMIndex.load(TINY)
        dfm = DeviceFMIndex.from_host(fm, "cpu")
        n = fm.ref_seq_len
    else:
        bwt, _, _, _, dfm = synthetic_hi()
        n = len(bwt)
    sent = int(dfm.sentinel)
    assert n >> 6 < dfm.occp.shape[0]       # the row of k + s = n exists
    blocks = np.unique(np.array([0, sent >> 6, n >> 6] if which == "tiny"
                                else range((n >> 6) + 1), np.int64))
    cases = np.zeros(5, np.int64)
    keep, args = _fm_args(dfm)
    bad = host_walk.h_step_sweep(*args, ctypes.c_int64(n), _p(blocks),
                                 ctypes.c_int(len(blocks)), _p(cases))
    assert bad == 0
    assert cases[0] > cases[1] > 0 and cases[2] > 0 and cases[3] > 0
    assert cases[4] > 0


def random_tiles(seed, P, Qmax, Tmax):
    """P (q, t) tiles: the query a mutated copy of the target's start (an
    unrelated target for one pair in six), with N codes, random lengths up
    to the tile and the padding set to 4."""
    rng = np.random.default_rng(seed)
    t = rng.integers(0, 4, (P, Tmax)).astype(np.int8)
    q = t[:, :Qmax].copy()
    sub = rng.random((P, Qmax)) < 0.05
    q[sub] = (q[sub] + 1) % 4
    q[::6] = rng.integers(0, 4, (len(q[::6]), Qmax))
    q[rng.random((P, Qmax)) < 0.01] = 4
    qlen = rng.integers(1, Qmax + 1, P).astype(np.int32)
    tlen = rng.integers(1, Tmax + 1, P).astype(np.int32)
    qlen[:3] = Qmax
    tlen[:3] = Tmax
    q[np.arange(Qmax)[None, :] >= qlen[:, None]] = 4
    t[np.arange(Tmax)[None, :] >= tlen[:, None]] = 4
    return q, t, qlen, tlen


@pytest.mark.parametrize("Qmax,Tmax,w,h0,scoring", [
    (128, 256, 100, 30, (1, 4, 6, 1, 6, 1, 100, 5)),
    (64, 96, 10, 5, (1, 4, 6, 1, 6, 1, 100, 5)),
    (150, 200, 30, 60, (2, 3, 5, 2, 4, 1, 20, 0)),
    (255, 320, 100, 80, (1, 4, 6, 1, 6, 1, 0, 5)),
], ids=["entry", "narrow_band", "rescored_zdrop20", "wide_no_zdrop"])
def test_bsw_tiles_matches_jax(Qmax, Tmax, w, h0, scoring):
    a, b, o_del, e_del, o_ins, e_ins, zdrop, end_bonus = scoring
    q, t, qlen, tlen = random_tiles(Qmax + Tmax, 48, Qmax, Tmax)
    rng = np.random.default_rng(w)
    h0s = rng.integers(1, h0 + 1, 48).astype(np.int32)
    ws = np.full(48, w, np.int32)
    ws[::5] = max(w // 3, 1)
    want = np.asarray(jbsw.bsw_kernel(
        jnp.asarray(q), jnp.asarray(t), jnp.asarray(qlen), jnp.asarray(tlen),
        jnp.asarray(h0s), jnp.asarray(ws), a, b, o_del, e_del, o_ins, e_ins,
        zdrop, end_bonus, a))
    got = bsw_tiles(*(torch.from_numpy(x) for x in (q, t, qlen, tlen, h0s,
                                                     ws)),
                    a, b, o_del, e_del, o_ins, e_ins, zdrop, end_bonus, a)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want[:, 0] > h0s).mean() > 0.5           # real extensions


def test_tiles_refuse_lengths_past_the_tile():
    q, t, qlen, tlen = (torch.from_numpy(x)
                        for x in random_tiles(1, 4, 32, 40))
    qlen[1] = 33
    one = torch.ones(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="outside"):
        bsw_tiles(q, t, qlen, tlen, one, one, 1, 4, 6, 1, 6, 1, 100, 5, 1)


@pytest.mark.parametrize("n,L,seed,edges,scores", [
    (32, 128, 0, False, ()),
    (24, 129, 3, True, ()),
    (16, 100, 4, True, (2, 6, 5, 2, 4, 1, 30)),
], ids=["graft_batch", "edges", "rescored"])
def test_seed_extend_step_matches_jax(index, n, L, seed, edges, scores):
    fm, dfm, jdfm = index
    enc, lens = mutated_batch(fm, n, L, seed, edges)
    want = jax_step(jdfm, jnp.asarray(enc), jnp.asarray(lens), *scores)
    got = seed_extend_step(dfm, enc, lens, *scores)
    assert [g.dtype for g in got] == [torch.int32, torch.int64, torch.int64,
                                      torch.int64, torch.int32]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert (got[4][:, 0].numpy() > 0).mean() > 0.5   # seeds extend


def test_seed_extend_step_reads_a_packed_genome(monkeypatch):
    """The reference window is read through take_ref: with the doubled
    genome 2-bit packed the step's outputs are the unpacked step's."""
    fm = FMIndex.load(TINY)
    enc, lens = mutated_batch(fm, 16, 128, 2, edges=True)
    want = seed_extend_step(DeviceFMIndex.from_host(fm, "cpu"), enc, lens)
    monkeypatch.setattr(DeviceFMIndex, "REF_PACK_MIN", 16)
    dfm = DeviceFMIndex.from_host(fm, "cpu")
    assert dfm.ref_packed and dfm.n_ref == 2 * fm.l_pac
    got = seed_extend_step(dfm, enc, lens)
    for g, w in zip(got, want):
        assert torch.equal(g, w)

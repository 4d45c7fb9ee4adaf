"""The fused seed-extend step of the port against the JAX package's, exact
(tolerance 0: integer outputs), on the CPU.

* round1_walk_ref equals bwamem2_tpu.ops.smem.round1_kernel (lut_k = 0) on
  the tiny index's mutated reads (as tests/test_mesh.py builds them) and
  on reads with N codes, short and empty lengths; the kernel's lane walk
  (csrc/fm_occ.cuh:fm_round1_walk, compiled as host C++) equals it, LF
  step counts included.
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


SHIM = r'''
#include "fm_occ.cuh"
extern "C" long long h_round1(const int32_t *occp, const int32_t *occ_hi,
                              int has_hi, const int64_t *counts,
                              int64_t sent, const int8_t *enc,
                              const int *lens, int N, int L, int *b,
                              int64_t *k, int64_t *s) {
  const FmView f{occp, occ_hi, {counts[0], counts[1], counts[2], counts[3],
                                counts[4]}, sent, has_hi};
  long long steps = 0;
  for (long long t = 0; t < (long long)N * L; ++t) {
    const long long r = t / L;
    steps += fm_round1_walk(f, enc + r * L, lens[r], (int)(t - r * L),
                            b + t, k + t, s + t);
  }
  return steps;
}
'''


def test_round1_lane_walk_source_matches_ref(index, tmp_path):
    """The kernel's per-lane walk, built with g++ as the kernel's launch
    loop would run it (one lane per (read, end)), equals round1_walk_ref,
    and takes the LF steps the plain version counts."""
    fm, dfm, _ = index
    src = tmp_path / "r1.cpp"
    src.write_text(SHIM)
    so = str(tmp_path / "r1.so")
    subprocess.run(["g++", "-O2", "-std=c++17", "-shared", "-fPIC", "-I",
                    CSRC, str(src), "-o", so], check=True,
                   capture_output=True)
    lib = ctypes.CDLL(so)
    lib.h_round1.restype = ctypes.c_longlong
    enc, lens = mutated_batch(fm, 24, 96, 5, edges=True)
    enc = np.ascontiguousarray(enc.astype(np.int8))
    N, L = enc.shape
    b = np.zeros((N, L), np.int32)
    k = np.zeros((N, L), np.int64)
    s = np.zeros((N, L), np.int64)
    keep = [np.ascontiguousarray(x.numpy()) for x in
            (dfm.occp, dfm.occ_hi, dfm.counts)]
    p = lambda a: ctypes.c_void_p(a.ctypes.data)  # noqa: E731
    steps = lib.h_round1(p(keep[0]), p(keep[1]), ctypes.c_int(dfm.has_hi),
                         p(keep[2]), ctypes.c_int64(int(dfm.sentinel)),
                         p(enc), p(lens), ctypes.c_int(N), ctypes.c_int(L),
                         p(b), p(k), p(s))
    stats = {}
    want = round1_walk_ref(dfm, torch.from_numpy(enc),
                           torch.from_numpy(lens), stats)
    for g, w in zip((b, k, s), want):
        np.testing.assert_array_equal(g, w.numpy())
    assert steps == stats["steps"] > N * L
    assert 0 < stats["rows"] <= dfm.occp.shape[0]


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

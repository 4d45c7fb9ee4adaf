"""Port long-pair extension (sheared band) vs the JAX package and the host.

bwamem2_tpu_torch.ops.bsw.bsw_shear_desc_ref (the plain PyTorch version of
the bsw_shear CUDA kernel) must equal, exactly (int32, tolerance 0):
  * bwamem2_tpu's XLA kernel bsw_shear_desc_kernel, on the plain and the
    2-bit packed genome, at w = 100 and 200, under the pacbio and the
    default scores;
  * the port's scalar native kernel on pacbio-like mutated pairs (the
    sweep of tests/test_bsw_shear.py);
  * the CUDA kernel's own bodies (csrc/shear_group.cuh) compiled as host
    C++, each warp a lane vector of 32 ints stepped in lockstep: the int32
    body and the 16-bit body (the DPX 16x2 operations emulated half by
    half), at every slot bucket, with the frame's edge cases (tlen >>
    qlen, qlen <= 256 with tlen > 608, pairs that stop on z-drop, on a
    zero row maximum and after their last row), at the 16-bit body's
    edge, and with the pairs run in a shuffled order.
DeviceBSW.left_kernel / right_kernel (the object path's dispatch) must
equal the JAX package's DeviceBSW._run on the same pending pairs and read
grid, with in-cap and long pairs mixed; the pairs of a read off the grid,
and only those, run on the host kernel (overflow.bsw_host_tail).  Its one
bsw_shear call per extension call must equal the JAX package's calls per
long_classes rung, through the plain version.
Inputs are made with numpy from fixed seeds.
"""

import ctypes
import subprocess
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from bwamem2_tpu_torch import native as tnative
from bwamem2_tpu_torch.align.extend import _Pair
from bwamem2_tpu_torch.ops import bsw_shear_cuda
from bwamem2_tpu_torch.ops.bsw import (QCAP, TCAP, DeviceBSW,
                                       bsw_shear_desc_ref, long_classes)
from bwamem2_tpu_torch.ops.bsw_cuda import bsw_extend
from bwamem2_tpu_torch.ops.device_index import DeviceFMIndex
from bwamem2_tpu_torch.options import MemOptions
from bwamem2_tpu_torch.utils.profiling import PROF

# one intra-op thread: the suite runs several xdist workers side by side,
# each with XLA's thread pools, and torch's OpenMP regions oversubscribed
# that way run 100x slower than on one thread
torch.set_num_threads(1)

# a b o_del e_del o_ins e_ins zdrop end_bonus
PACBIO = (1, 1, 1, 1, 1, 1, 100, 0)
DEFAULT = (1, 4, 6, 1, 6, 1, 100, 5)
ZDROP10 = (1, 4, 6, 1, 6, 1, 10, 5)       # -d 10: z-drop on most pairs


def _mutate(rng, seq, err):
    """~err errors: 60% substitutions, 20% insertions, 20% deletions."""
    out = []
    for c in seq:
        r = rng.random()
        if r < err * 0.6:
            out.append(rng.integers(0, 4))
        elif r < err * 0.8:
            out.append(rng.integers(0, 4))
            out.append(c)
        elif r < err:
            continue
        else:
            out.append(c)
    return np.array(out, np.uint8)


def make_long(seed, P, qr, n_ref=30000, err=0.10, edges=False):
    """P long descriptor pairs over a random doubled genome: the query is a
    pacbio-like mutation of the genome from the target's start (each walk
    direction for half the pairs), tlen = qlen + [0, 400); one in eight
    targets is unrelated (an early stop), a few queries carry an N.  With
    edges, the first pairs are the frame's edge cases: tlen 3x qlen, qlen
    <= 256 with tlen > 608, tlen < qlen, tlen 1, and a query that turns
    random a third of the way in.  Returns (ref, enc, qoff, qdir, qlen,
    toff, tdir, tlen, h0, w=100)."""
    rng = np.random.default_rng(seed)
    ref = rng.integers(0, 4, n_ref).astype(np.uint8)
    L = qr[1] + 8
    enc = np.full((P, L), 4, np.int8)
    qoff, qdir, qlen, tdir, tlen = (np.zeros(P, np.int32) for _ in range(5))
    toff = np.zeros(P, np.int64)
    for p in range(P):
        ql = int(rng.integers(*qr))
        tl = ql + int(rng.integers(0, 400))
        if edges and p < 4:
            ql, tl = ((ql, 3 * ql), (int(rng.integers(60, 257)), 2500),
                      (ql, ql // 2), (ql, 1))[p]
        d = 1 if p % 2 == 0 else -1
        span = max(tl, 2 * ql) + 8
        s = int(rng.integers(8, n_ref - span - 8))
        src = ref[s:s + span] if d > 0 else ref[s:s + span][::-1]
        q = _mutate(rng, src, err)[:ql]
        if len(q) < ql:
            q = np.concatenate([q, rng.integers(0, 4, ql - len(q))])
        q = q.astype(np.int8)
        if edges and p == 4:            # diverges a third of the way in
            q[ql // 3:] = rng.integers(0, 4, ql - ql // 3)
        if rng.random() < 0.1:
            q[rng.integers(0, ql)] = 4
        enc[p, :ql] = q if d > 0 else q[::-1]
        qoff[p] = p * L + (0 if d > 0 else ql - 1)
        toff[p] = s if d > 0 else s + span - 1
        if rng.random() < 0.125:
            toff[p] = int(rng.integers(span, n_ref - span))
        qdir[p] = tdir[p] = d
        qlen[p], tlen[p] = ql, tl
    h0 = rng.integers(19, 400, P).astype(np.int32)
    w = np.full(P, 100, np.int32)
    return ref, enc, qoff, qdir, qlen, toff, tdir, tlen, h0, w


def run_ref(d, Wh, scoring, ref=None, packed=False, cells=None):
    t = [torch.from_numpy(np.ascontiguousarray(x)) for x in d]
    if ref is not None:
        t[0] = ref
    t[9] = torch.full_like(t[9], Wh)
    a = scoring[0]
    Tmax = int(np.minimum(d[7], d[4] + Wh + 2).max())
    return bsw_shear_desc_ref(*t, Wh, Tmax, *scoring, max(a, 1), packed,
                              cells=cells).numpy()


@pytest.mark.parametrize("scoring,Wh,packed", [
    (PACBIO, 100, False), (DEFAULT, 100, True), (PACBIO, 200, True),
    (DEFAULT, 200, False)],
    ids=["pacbio_w100", "default_w100_packed", "pacbio_w200_packed",
         "default_w200"])
def test_ref_matches_jax_shear_kernel(monkeypatch, scoring, Wh, packed):
    from bwamem2_tpu.ops.bsw import bsw_shear_desc_kernel
    d = list(make_long(101 + Wh, 24, (300, 1400), edges=True))
    ref = None
    if packed:
        monkeypatch.setattr(DeviceFMIndex, "REF_PACK_MIN", 16)
        dfm = DeviceFMIndex.from_genome(d[0], "cpu")
        assert dfm.ref_packed
        ref = dfm.ref
        d[0] = dfm.ref.numpy()
    d[9] = np.full_like(d[9], Wh)
    Qmax = int(d[4].max())
    Tmax = int(np.minimum(d[7], d[4] + Wh + 2).max())
    W = -(-(2 * Wh + 2) // 128) * 128        # the JAX dispatch's frame
    want = np.asarray(bsw_shear_desc_kernel(
        *d, Wh, W, Qmax, Tmax, *scoring, max(scoring[0], 1), packed))
    got = run_ref(d, Wh, scoring, ref=ref, packed=packed)
    np.testing.assert_array_equal(got, want)
    assert (want[:, 0] > d[8]).mean() > 0.5       # real extensions


@pytest.mark.parametrize("w", [100, 200])
def test_ref_matches_native_on_mutated_pairs(w):
    """Indel-heavy pairs (8-12 % error) against the port's scalar native
    kernel on the materialized sequences."""
    rng = np.random.default_rng(40 + w)
    for err in (0.08, 0.12):
        d = make_long(int(rng.integers(1 << 30)), 16, (257, 2000), err=err)
        ref, enc, qoff, qdir, qlen, toff, tdir, tlen, h0, _ = d
        flat = enc.reshape(-1)
        q = [flat[qoff[i] + qdir[i] * np.arange(qlen[i])].astype(np.uint8)
             for i in range(len(qlen))]
        t = [ref[np.clip(toff[i] + tdir[i] * np.arange(tlen[i]), 0,
                         len(ref) - 1)] for i in range(len(qlen))]
        off = lambda xs: np.concatenate(  # noqa: E731
            [[0], np.cumsum([len(x) for x in xs])])[:-1]
        want = tnative.bsw_extend_batch(
            np.concatenate(t), off(t), tlen, np.concatenate(q), off(q),
            qlen, h0, w, np.array(MemOptions().finalize().mat, np.int8),
            6, 1, 6, 1, 100, 5)
        np.testing.assert_array_equal(run_ref(d, w, DEFAULT), want)


@pytest.fixture(scope="module")
def host_shear(tmp_path_factory):
    """csrc/shear_group.cuh built as host C++: each warp is a lane vector
    of 32 ints stepped in lockstep, and a loop over the pairs stands in
    for the CUDA launches.  shear_host runs the slot bucket the launch would
    choose for Wh, or the one given (C int32 slots per lane, in registers
    or, with wide, in the memory frame): pairs [0, n16) in the 16-bit
    body, the rest in the int32 body, as the wrapper's two launches do;
    the pairs run in the order perm gives, when one is given; or, with
    split K > 1, every pair in the split-band form (shear_pair_blk on a
    block of K warps, one lane vector of 32 K lanes).  It returns C (+
    1000 for the memory frame, 100 K + C for the split form) and records
    per pair why its row loop ended (0 zero row maximum, 1 z-drop, 2 ran
    every row) and the body that ran it (0 int32, 1 16-bit, 2 split)."""
    d = tmp_path_factory.mktemp("shear_group")
    shim = d / "shim.cpp"
    shim.write_text(r"""
static int *shear_stops;
#define SHEAR_STOP_HOOK(p, why) (shear_stops[p] = (why))
#include "shear_group.cuh"
#include <vector>
template <int C, int R>
static void run_reg(const ShearBatch &b, int n16, const int64_t *perm,
                    int *route) {
  const BswGroup<SHEAR_G> g;
  for (int t = 0; t < b.P; ++t) {
    const int p = perm ? (int)perm[t] : t;
    if (p < n16) {
      shear_pair_s16<R>(g, b, p);
      route[p] = 1;
    } else {
      shear_pair_i32<C>(g, b, p);
      route[p] = 0;
    }
  }
}
template <int K, int C>
static void run_blk(const ShearBatch &b, const int64_t *perm, int *route) {
  int xch[SHEAR_X_SLOTS * K];
  const ShearBlock<K> g(xch);
  for (int t = 0; t < b.P; ++t) {
    const int p = perm ? (int)perm[t] : t;
    shear_pair_blk<C>(g, b, p);
    route[p] = 2;
  }
}
static void run_wide(const ShearBatch &b, const int64_t *perm, int *route) {
  const BswGroup<SHEAR_G> g;
  std::vector<BswLanes<SHEAR_G>> mem(SHEAR_ARRAYS * b.C);
  for (int t = 0; t < b.P; ++t) {
    const int p = perm ? (int)perm[t] : t;
    shear_pair_i32<0>(g, b, p, mem.data(), 1);
    route[p] = 0;
  }
}
extern "C" int shear_host(const int8_t *enc, int64_t n_enc,
    const uint8_t *ref, int64_t n_ref, int packed, const int *qoff,
    const int *qdir, const int *qlen, const int64_t *toff, const int *tdir,
    const int *tlen, const int *h0, const int *w, int P, int Wh, int Tmax,
    const int *sc, int C, int wide, int n16, const int64_t *perm, int *out,
    int *stops, int *route, int split) {
  int ct = wide ? 0 : C;
  if (!C && (ct = shear_bucket(Wh, &C)) < 0) return 0;
  const ShearBatch b{enc, n_enc, ref, n_ref, packed, qoff, qdir, qlen, toff,
                     tdir, tlen, h0, w, 0, P, Wh, Tmax, C,
                     {sc[0], sc[1], sc[2], sc[3], sc[4], sc[5], sc[6], sc[7],
                      sc[8]}, out};
  shear_stops = stops;
  for (int p = 0; p < P; ++p) stops[p] = 2;
  if (split > 1) {     // the split-band form: the plan's bucket for K, Wh
#define SHEAR_HOST_BLK(k, c, wh) \
    if (split == k && Wh <= wh) { run_blk<k, c>(b, perm, route); \
                                  return 100 * k + c; }
    SHEAR_BLK_BUCKETS(SHEAR_HOST_BLK)
    return 0;
  }
  if (ct == 0) { run_wide(b, perm, route); return 1000 + C; }
#define SHEAR_HOST_CASE(c_, r_) \
  if (ct == c_) { run_reg<c_, r_>(b, n16, perm, route); return C; }
  SHEAR_BUCKETS(SHEAR_HOST_CASE)
  return 0;
}
""")
    so = d / "shear_group.so"
    subprocess.run(["g++", "-O2", "-std=c++17", "-shared", "-fPIC",
                    "-I", bsw_shear_cuda.CSRC, str(shim), "-o", str(so)],
                   check=True, capture_output=True)
    return ctypes.CDLL(str(so))


def fit16(d, Wh, scoring):
    """The wrapper's 16-bit test (BswShear.fits16) on pairs d."""
    return bsw_shear_cuda.BswShear.fits16(d[4], d[8], Wh, *scoring[:6],
                                          max(scoring[0], 1))


def run_host(lib, d, Wh, scoring, C=0, ref=None, packed=False, Tmax=None,
             wide=False, n16=None, perm=None, split=1):
    """(out int32[P, 6], bucket C (+ 1000 for the memory frame, 100 K + C
    for the split form), stop reason per pair, body per pair).  n16 None:
    as the dispatch routes the pairs, which fits16 must give as a prefix
    of them (none in the memory frame); split K > 1: the split-band form
    on every pair."""
    ref_a, enc, qoff, qdir, qlen, toff, tdir, tlen, h0, _ = (
        np.ascontiguousarray(x) for x in d)
    if ref is not None:
        ref_a = np.ascontiguousarray(ref)
    P = len(qoff)
    if n16 is None:
        fit = fit16(d, Wh, scoring) & (not wide)
        n16 = int(fit.sum())
        assert fit[:n16].all(), "the 16-bit pairs come first"
    w = np.full(P, Wh, np.int32)
    if Tmax is None:
        Tmax = int(np.minimum(tlen, qlen + Wh + 2).max())
    sc = np.array(list(scoring) + [max(scoring[0], 1)], np.int32)
    out = np.zeros((P, 6), np.int32)
    stops = np.zeros(P, np.int32)
    route = np.full(P, -1, np.int32)
    ptr = lambda x: ctypes.c_void_p(x.ctypes.data)  # noqa: E731
    keep = None if perm is None else np.ascontiguousarray(perm, np.int64)
    perm_p = ctypes.c_void_p(None) if keep is None else ptr(keep)
    got = lib.shear_host(ptr(enc), ctypes.c_int64(enc.size), ptr(ref_a),
                         ctypes.c_int64(ref_a.size), ctypes.c_int(int(packed)),
                         ptr(qoff), ptr(qdir), ptr(qlen), ptr(toff),
                         ptr(tdir), ptr(tlen), ptr(h0), ptr(w),
                         ctypes.c_int(P), ctypes.c_int(Wh),
                         ctypes.c_int(Tmax), ptr(sc), ctypes.c_int(C),
                         ctypes.c_int(int(wide)), ctypes.c_int(n16), perm_p,
                         ptr(out), ptr(stops), ptr(route), ctypes.c_int(split))
    assert (route >= 0).all()
    return out, got, stops, route


# name: (band radius Wh, scoring, forced C or 0 for the launch's choice,
# expected C, + 1000 for the memory frame).  Under the presets' z-drop of
# 100 a pair rarely z-drops (the row maximum follows a gap from the best
# cell, whose penalty z-drop discounts), so one case runs at -d 10.  A
# forced C above 1000 forces the memory frame with C - 1000 slots per lane.
HOST = {
    "w100_pacbio": (100, PACBIO, 0, 7),
    "w100_zdrop10": (100, ZDROP10, 0, 7),
    "w200_default": (200, DEFAULT, 0, 13),
    "w50_default": (50, DEFAULT, 0, 7),
    "w100_forced_13": (100, PACBIO, 13, 13),
    "w300_pacbio": (300, PACBIO, 0, 1019),
    "w400_default": (400, DEFAULT, 0, 1026),
    "w500_memory_frame": (500, PACBIO, 0, 1032),
    "w100_forced_memory_frame": (100, ZDROP10, 1007, 1007),
}


_REF = {}


def host_case(name):
    """HOST case `name`: (Wh, scoring, forced C, expected C, its pairs,
    their plain-version output), the output computed once per module."""
    Wh, scoring, forced, C = HOST[name]
    d = make_long(7 + Wh + forced, 20, (257, 900), edges=True)
    if name not in _REF:
        _REF[name] = run_ref(d, Wh, scoring)
    return Wh, scoring, forced, C, d, _REF[name]


@pytest.mark.parametrize("name", list(HOST))
def test_cuda_shear_source_matches_ref(host_shear, name):
    """The kernel's group source, built with g++, equals the plain version
    at every slot bucket, chosen from Wh and forced, and in the memory
    frame of bands wider than the widest bucket, with the frame's edge
    cases and pairs stopping on a zero row maximum, on z-drop and after
    their last row; routed as the kernel routes them (every pair here
    fits 16 bits, so the register buckets run the 16-bit body)."""
    Wh, scoring, forced, C, d, want = host_case(name)
    got, used, stops, route = run_host(host_shear, d, Wh, scoring,
                                       C=forced % 1000, wide=forced > 1000)
    assert used == C
    np.testing.assert_array_equal(got, want)
    assert {0, 2} <= set(stops)
    assert (stops == 1).sum() >= (5 if scoring is ZDROP10 else 0)
    assert (route == (0 if forced > 1000 or Wh > 206 else 1)).all()


REG_HOST = [n for n, (Wh, _, forced, _) in HOST.items()
            if forced < 1000 and Wh <= 206]


def mixed_case(name):
    """HOST case `name` with every third pair's h0 raised by 32,700, past
    the 16-bit body, the pairs in the dispatch's order (DeviceBSW.
    long_order: the 16-bit ones first); (pairs, how many fit, the plain
    version's output), computed once per module."""
    Wh, scoring, _, _, d, _ = host_case(name)
    key = (name, "mixed")
    if key not in _REF:
        d = list(d)
        d[8] = d[8] + np.where(np.arange(len(d[8])) % 3 == 0, 32700, 0
                               ).astype(np.int32)
        fit = fit16(d, Wh, scoring)
        order, _ = DeviceBSW.long_order(d[4], d[7], Wh, fit)
        d = d[:2] + [x[order] for x in d[2:]]
        _REF[key] = d, int(fit.sum()), run_ref(d, Wh, scoring)
    return _REF[key]


@pytest.mark.parametrize("route", ["int32", "16bit_shuffled",
                                   "mixed_shuffled"])
@pytest.mark.parametrize("name", REG_HOST)
def test_cuda_shear_routes_match_ref(host_shear, name, route):
    """Each body of the register buckets equals the plain version on the
    same pairs: every pair in the int32 body; every pair in the 16-bit
    body, the pairs run in a shuffled order (stops on a zero row maximum
    and on z-drop in both); and a call of both, a third of its pairs past
    16 bits, as the dispatch orders and routes them, run shuffled."""
    Wh, scoring, forced, C, d, want = host_case(name)
    P = len(d[1])
    perm = np.random.default_rng(Wh).permutation(P)
    if route == "mixed_shuffled":
        d, n16, want = mixed_case(name)
        got, used, _, routes = run_host(host_shear, d, Wh, scoring, C=forced,
                                        perm=perm)
        assert 0 < n16 < P
        np.testing.assert_array_equal(routes, np.arange(P) < n16)
    else:
        n16 = {"int32": 0, "16bit_shuffled": P}[route]
        got, used, stops, routes = run_host(
            host_shear, d, Wh, scoring, C=forced, n16=n16,
            perm=perm if n16 else None)
        assert {0, 2} <= set(stops)
        assert (stops == 1).sum() >= (5 if scoring is ZDROP10 else 0)
        assert (routes == int(n16 > 0)).all()
    assert used == C
    np.testing.assert_array_equal(got, want)


# the split form's bucket (100 K + C) for a band radius
def blk_bucket(K, Wh):
    return 100 * K + (4 if Wh <= 110 else 7)


@pytest.mark.parametrize("name", REG_HOST)
def test_cuda_shear_split_matches_ref(host_shear, name, K=2):
    """The split-band form (shear_pair_blk, K = 2 warps a pair) equals the
    plain version on every register case, its pairs run in a shuffled
    order: stops on a zero row maximum, on z-drop (the -d 10 case) and
    after the last row; and on the mixed call, a third of its pairs past
    16 bits, which the form runs in one launch."""
    Wh, scoring, _, _, d, want = host_case(name)
    P = len(d[1])
    perm = np.random.default_rng(Wh + K).permutation(P)
    got, used, stops, route = run_host(host_shear, d, Wh, scoring,
                                       perm=perm, split=K)
    assert used == blk_bucket(K, Wh)
    np.testing.assert_array_equal(got, want)
    assert {0, 2} <= set(stops)
    assert (stops == 1).sum() >= (5 if scoring is ZDROP10 else 0)
    assert (route == 2).all()
    d, _, want = mixed_case(name)
    got, *_ = run_host(host_shear, d, Wh, scoring, perm=perm, split=K)
    np.testing.assert_array_equal(got, want)


def make_gapped(seed, P, qr=(500, 800)):
    """P pairs whose queries copy the target but for one long insertion
    (30-95 random bases) and one long deletion (30-95 target bases
    skipped), with few other errors: under cheap gaps (-x pacbio's) the
    best path runs long horizontal and vertical gaps, so F carries across
    many lanes and, in the split-band form, across warps.  Same tuple as
    make_long."""
    d = list(make_long(seed, P, qr, err=0.01))
    rng = np.random.default_rng(seed)
    ref, enc = d[0], d[1].copy()
    for p in range(P):
        ql, qd = int(d[4][p]), int(d[3][p])
        row = enc[p, :ql] if qd > 0 else enc[p, :ql][::-1]
        q = row.copy()
        a = ql // 3
        g1, g2 = int(rng.integers(30, 96)), int(rng.integers(30, 96))
        q = np.concatenate([q[:a], rng.integers(0, 4, g1).astype(np.int8),
                            q[a:2 * a], q[2 * a + g2:]])[:ql]
        q = np.concatenate([q, rng.integers(0, 4, ql - len(q)).astype(
            np.int8)])
        enc[p, :ql] = q if qd > 0 else q[::-1]
    d[1] = enc
    return tuple(d)


def test_cuda_shear_split_long_gaps(host_shear, K=2):
    """The split-band form and the one-warp int32 body on pairs whose best
    paths run long insertions and deletions (make_gapped): F's scan
    crosses lanes and warps and the band shrink meets E-only slots."""
    d = make_gapped(67, 16)
    want = run_ref(d, 100, PACBIO)
    assert (want[:, 0] > 300).sum() >= 8          # the gapped paths score
    got, used, stops, route = run_host(host_shear, d, 100, PACBIO, split=K)
    assert used == blk_bucket(K, 100) and (route == 2).all()
    np.testing.assert_array_equal(got, want)
    got, *_ = run_host(host_shear, d, 100, PACBIO, n16=0)
    np.testing.assert_array_equal(got, want)


def test_cuda_shear_source_packed_ref(host_shear, monkeypatch):
    """The kernel's 2-bit packed genome path against the plain version's,
    in each body."""
    d = make_long(23, 16, (257, 700))
    monkeypatch.setattr(DeviceFMIndex, "REF_PACK_MIN", 16)
    dfm = DeviceFMIndex.from_genome(d[0], "cpu")
    assert dfm.ref_packed
    want = run_ref(d, 100, PACBIO, ref=dfm.ref, packed=True)
    np.testing.assert_array_equal(want, run_ref(d, 100, PACBIO))
    for n16 in (None, 0):
        got, _, _, route = run_host(host_shear, d, 100, PACBIO,
                                    ref=dfm.ref.numpy(), packed=True,
                                    n16=n16)
        np.testing.assert_array_equal(got, want)
        assert (route == int(n16 is None)).all()


def test_cuda_shear_source_zero_row_and_row_cap(host_shear):
    """A target of all-N after a few bases ends the pair on a zero row
    maximum; a row cap Tmax below tlen stops the rest after Tmax rows,
    as the plain version does; in each body."""
    d = list(make_long(29, 12, (300, 600)))
    ref = d[0].copy()
    # pairs 0-3: h0 1 against a random target, so every score reaches 0
    d[8] = d[8].copy()
    d[8][:4] = 1
    d[5] = d[5].copy()
    d[5][:4] = np.arange(4) * 3000 + 12000
    want = run_ref(d, 100, DEFAULT)
    t = [torch.from_numpy(np.ascontiguousarray(x)) for x in d]
    want_cap = bsw_shear_desc_ref(*t, 100, 150, *DEFAULT, 1).numpy()
    for n16 in (None, 0):
        got, _, stops, _ = run_host(host_shear, d, 100, DEFAULT, ref=ref,
                                    n16=n16)
        np.testing.assert_array_equal(got, want)
        assert (stops[:4] == 0).all()
        got, _, _, _ = run_host(host_shear, d, 100, DEFAULT, Tmax=150,
                                n16=n16)
        np.testing.assert_array_equal(got, want_cap)


# a b o_del e_del o_ins e_ins zdrop end_bonus, with a large match score
A4 = (4, 4, 6, 1, 6, 1, 100, 5)


@pytest.mark.parametrize("scoring", [DEFAULT, A4], ids=["a1", "a4"])
def test_cuda_shear_16bit_edge(host_shear, scoring):
    """Pairs at the 16-bit body's edge: exact queries (so H climbs by
    max_sc a column) with h0 + (qlen + 1) * max_sc at 32766 and 32767 (the
    16-bit body) and at 32768 and 32769 (the int32 body); h0 + qlen *
    max_sc = 32767 and 32768 among them.  The dispatch's order and routes
    (fits16), every pair in the int32 body and every pair in the
    split-band form equal the plain version."""
    a = scoring[0]
    d = list(make_long(41, 8, (600, 1200), err=0.0))
    qlen = d[4]
    edge = 32767 - (qlen.astype(np.int64) + 1) * a
    d[8] = (edge + np.array([-1, 0, 1, 2, -1, 0, 1, 2])).astype(np.int32)
    fit = fit16(d, 100, scoring)
    np.testing.assert_array_equal(fit, [1, 1, 0, 0, 1, 1, 0, 0])
    assert not fit16(d, 207, scoring).any()          # no 16-bit frame
    order, _ = DeviceBSW.long_order(d[4], d[7], 100, fit)
    d = d[:2] + [x[order] for x in d[2:]]
    want = run_ref(d, 100, scoring)
    assert (want[:, 0] >= d[8] + d[4] * a // 2).sum() >= 4   # H climbed
    for n16 in (None, 0):
        got, _, _, route = run_host(host_shear, d, 100, scoring, n16=n16)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(
            route, np.arange(8) < (4 if n16 is None else 0))
    got, _, _, route = run_host(host_shear, d, 100, scoring, split=2)
    np.testing.assert_array_equal(got, want)       # the split-band form
    assert (route == 2).all()


def test_long_order_puts_16bit_pairs_first():
    """DeviceBSW.long_order: the pairs that fit 16 bits first, each part
    by descending rows min(tlen, qlen + w + 2), ties in descriptor order;
    with none fitting, every pair by descending rows."""
    qls = np.array([300, 5000, 300, 2000, 4000, 300], np.int32)
    tls = np.array([9000, 5000, 400, 9000, 100, 9000], np.int32)
    fit = np.array([1, 0, 1, 1, 0, 1], bool)
    idxs, rows = DeviceBSW.long_order(qls, tls, 100, fit)
    np.testing.assert_array_equal(idxs, [3, 0, 5, 2, 1, 4])
    np.testing.assert_array_equal(rows, [2102, 402, 402, 400, 5000, 100])
    idxs, rows = DeviceBSW.long_order(qls, tls, 100, np.zeros(6, bool))
    np.testing.assert_array_equal(idxs, [1, 3, 0, 5, 2, 4])
    assert (np.diff(rows) <= 0).all()


@pytest.mark.parametrize("Wh", [100, 207])
def test_tile_long_order_on_tensors_matches_host(Wh):
    """bsw_shear_tiles' order and 16-bit test on tensors (ops/bsw.py:
    tile_long_order over BswShear.fits16_t, which stay on the card there)
    equal the host's BswShear.fits16 and DeviceBSW.long_order, on CPU
    tensors: pairs on both sides of the 16-bit edge, equal row counts
    (ties in index order), tlen below and above qlen + Wh + 2, and at Wh
    207 no pair in 16 bits."""
    from bwamem2_tpu_torch.ops.bsw import tile_long_order
    rng = np.random.default_rng(61)
    P = 300
    qlen = rng.integers(1, 3000, P).astype(np.int32)
    tlen = rng.integers(1, 3500, P).astype(np.int32)
    tlen[::7] = tlen[0]                 # ties
    qlen[::7] = qlen[0]
    edge = 32767 - (qlen.astype(np.int64) + 1)
    h0 = np.where(rng.random(P) < 0.5, edge + rng.integers(-2, 3, P),
                  rng.integers(0, 200, P)).astype(np.int32)
    h0[:3] = -1                         # a negative h0 never fits
    sc = (*DEFAULT[:6], 1)
    fit = bsw_shear_cuda.BswShear.fits16(qlen, h0, Wh, *sc)
    assert 0 < fit.sum() < P if Wh <= 206 else not fit.any()
    got = bsw_shear_cuda.BswShear.fits16_t(torch.from_numpy(qlen),
                                           torch.from_numpy(h0), Wh, *sc)
    np.testing.assert_array_equal(got.numpy(), fit)
    want, _ = DeviceBSW.long_order(qlen, tlen, Wh, fit)
    order, n16 = tile_long_order(torch.from_numpy(qlen),
                                 torch.from_numpy(tlen),
                                 torch.from_numpy(h0), Wh, *sc)
    np.testing.assert_array_equal(order.numpy(), want)
    assert n16.dtype == torch.int32 and n16.tolist() == [int(fit.sum())]


def test_long_classes_cover_every_pair():
    """eff = min(tlen, qlen + w + 2) past the static ladder (a huge -w)
    lands in one dynamic top rung; every pair is in exactly one rung whose
    row cap T holds it."""
    qls = np.array([32000, 150, 8000, 300], np.int32)
    tls = np.array([40000, 700, 8100, 5000], np.int32)
    for w in (100, 2000):
        out = long_classes(qls, tls, np.arange(4), w)
        assert sorted(int(i) for _, s in out for i in s) == [0, 1, 2, 3]
        for T, sel in out:
            eff = np.minimum(tls[sel], qls[sel] + w + 2)
            assert (eff <= T).all()


def _pending(seed, fm_ref, n_reads=6, L=1500):
    """A read grid of n_reads long reads and their extension pairs as
    extend_chains makes them (left: qdir -1 from qbeg-1; right: qdir +1
    from the seed's end), sequences materialized, both in-cap and long."""
    rng = np.random.default_rng(seed)
    n_ref = len(fm_ref)
    grid = np.full((n_reads, L), 4, np.int8)
    lens = np.zeros(n_reads, np.int32)
    reads = []
    for r in range(n_reads):
        ln = int(rng.integers(L // 2, L))
        s = int(rng.integers(1000, n_ref - 3 * L))
        q = _mutate(rng, fm_ref[s:s + 2 * L], 0.08)[:ln].astype(np.int8)
        grid[r, :ln] = q
        lens[r] = ln
        reads.append((s, q))
    pend = []
    for r, (s, q) in enumerate(reads):
        ln = len(q)
        for _ in range(4):
            qb = int(rng.integers(1, ln - 30))
            sl = int(rng.integers(15, 30))
            rb = s + qb + int(rng.integers(-3, 4))
            # left: the query before the seed against the target before it
            tl = min(rb, int(rng.integers(qb // 2, qb + 700)))
            pend.append(("L", _Pair(
                ref=fm_ref[rb - tl:rb][::-1].copy(),
                qer=q[:qb][::-1].astype(np.uint8).copy(), h0=sl, regid=0,
                seqid=r, qoff=qb - 1, qdir=-1, toff=rb - 1, tdir=-1,
                qlen=qb, tlen=tl)))
            qe = qb + sl
            if qe < ln:
                re = rb + sl
                tl = int(rng.integers((ln - qe) // 2, ln - qe + 700))
                pend.append(("R", _Pair(
                    ref=fm_ref[re:re + tl].copy(),
                    qer=q[qe:].astype(np.uint8).copy(), h0=sl + 20,
                    regid=0, seqid=r, qoff=qe, qdir=1, toff=re, tdir=1,
                    qlen=ln - qe, tlen=tl)))
    return grid, lens, pend


def test_object_path_dispatch_matches_jax_run():
    """DeviceBSW.left_kernel / right_kernel on the CPU (bsw_extend's and
    bsw_shear's plain versions) equal the JAX package's DeviceBSW._run on
    the same pending pairs and read grid, in-cap and long pairs mixed; a
    read off the grid (an empty row) sends its pairs, and only those, to
    the host kernel."""
    import jax.numpy as jnp
    from bwamem2_tpu.align.extend import _Pair as JPair
    from bwamem2_tpu.ops.bsw import DeviceBSW as JDeviceBSW
    from bwamem2_tpu.options import MemOptions as JOpt

    rng = np.random.default_rng(61)
    genome = rng.integers(0, 4, 40000).astype(np.uint8)
    grid, lens, pend = _pending(63, genome)
    qls = np.array([p.qlen for _, p in pend])
    tls = np.array([p.tlen for _, p in pend])
    fits = (qls <= QCAP) & (tls <= TCAP)
    assert fits.sum() >= 3 and (~fits).sum() >= 10
    assert ((qls <= QCAP) & (tls > TCAP)).any()   # long by tlen alone
    for preset in ("pacbio", None):
        opt = MemOptions().finalize(preset)
        jopt = JOpt().finalize(preset)
        dfm = DeviceFMIndex(ref=torch.from_numpy(genome), ref_packed=False,
                            device=torch.device("cpu"))
        bsw = DeviceBSW(dfm, opt)
        bsw.encj = torch.from_numpy(grid)
        bsw.lens = lens
        # JAX's DeviceBSW reads only the genome from its index
        jbsw = JDeviceBSW(SimpleNamespace(ref=jnp.asarray(genome),
                                          ref_packed=False), jopt)
        jbsw.encj = jnp.asarray(grid)
        for side, kern in (("L", "left_kernel"), ("R", "right_kernel")):
            sub = [p for s, p in pend if s == side]
            jsub = [JPair(**{k: getattr(p, k) for k in p.__slots__})
                    for p in sub]
            n_ext, n_sh = bsw_extend.plain_calls, \
                bsw_shear_cuda.bsw_shear.plain_calls
            PROF.c.pop("overflow.bsw_host_tail", None)
            got = getattr(bsw, kern)(sub, opt.w, opt)
            assert PROF.c["overflow.bsw_host_tail"] == 0
            assert bsw_shear_cuda.bsw_shear.plain_calls > n_sh
            assert bsw_extend.plain_calls > n_ext
            want = getattr(jbsw, kern)(jsub, jopt.w, jopt)
            np.testing.assert_array_equal(got, want)
    # read 2 off the grid: its pairs (materialized) run on the host kernel
    opt = MemOptions().finalize("pacbio")
    off = lens.copy()
    off[2] = 0
    bsw.lens = off
    sub = [p for s, p in pend if s == "R"]
    PROF.c.pop("overflow.bsw_host_tail", None)
    got = bsw.right_kernel(sub, opt.w, opt)
    assert PROF.c["overflow.bsw_host_tail"] == sum(p.seqid == 2 for p in sub)
    bsw.lens = lens
    np.testing.assert_array_equal(got, bsw.right_kernel(sub, opt.w, opt))


def test_long_dispatch_one_launch_equals_rungs(monkeypatch):
    """DeviceBSW._run gives a call's long pairs to bsw_shear once (the
    pairs that fit 16 bits first, n16 of them, each part by descending row
    count, the row cap of the longest), and that equals the JAX package's
    per-rung dispatch (one call per long_classes rung at its T) through
    the plain version, pair for pair; a quarter of the long pairs have an
    h0 past 16 bits."""
    rng = np.random.default_rng(67)
    genome = rng.integers(0, 4, 40000).astype(np.uint8)
    grid, lens, pend = _pending(69, genome)
    opt = MemOptions().finalize("pacbio")
    dfm = DeviceFMIndex(ref=torch.from_numpy(genome), ref_packed=False,
                        device=torch.device("cpu"))
    bsw = DeviceBSW(dfm, opt)
    bsw.encj = torch.from_numpy(grid)
    bsw.lens = lens
    sub = [p for s, p in pend if s == "L"]
    qls = np.array([p.qlen for p in sub], np.int32)
    tls = np.array([p.tlen for p in sub], np.int32)
    long_idx = np.nonzero((qls > QCAP) | (tls > TCAP))[0]
    for k in long_idx[::4]:
        sub[k].h0 += 32700
    rungs = long_classes(qls, tls, long_idx, opt.w)
    assert len(long_idx) >= 8 and len(rungs) >= 2
    shear = bsw_shear_cuda.bsw_shear
    seen = []
    call = bsw_shear_cuda.BswShear.__call__

    def spy(self, *args, **kw):
        seen.append((args, kw))
        return call(self, *args, **kw)

    monkeypatch.setattr(bsw_shear_cuda.BswShear, "__call__", spy)
    n = shear.plain_calls
    got = bsw.left_kernel(sub, opt.w, opt)
    assert shear.plain_calls == n + 1            # one call, all rungs
    (args, kw), = seen
    fit = bsw_shear_cuda.BswShear.fits16(
        args[4].numpy(), args[8].numpy(), opt.w, *opt.mat_scores(),
        opt.o_del, opt.e_del, opt.o_ins, opt.e_ins, bsw.max_sc)
    n16 = kw["n16"]
    assert 0 < n16 < len(long_idx) and fit[:n16].all() and not fit[n16:].any()
    rows = np.minimum(args[7].numpy(), args[4].numpy() + opt.w + 2)
    assert (np.diff(rows[:n16]) <= 0).all() and (np.diff(rows[n16:]) <= 0).all()
    assert args[11] == rows.max()
    desc = {k: np.array([getattr(p, k) for p in sub]) for k in
            ("seqid", "qoff", "qdir", "qlen", "toff", "tdir", "tlen", "h0")}
    for T, idxs in rungs:
        res = bsw_shear_desc_ref(
            dfm.ref, bsw.encj, *bsw._put(desc, idxs),
            torch.full((len(idxs),), opt.w, dtype=torch.int32), opt.w, T,
            *opt.mat_scores(), opt.o_del, opt.e_del, opt.o_ins, opt.e_ins,
            opt.zdrop, opt.pen_clip5, bsw.max_sc)
        np.testing.assert_array_equal(got[idxs], res.numpy())


def test_wrapper_dispatch():
    """CPU tensors run the plain version (counted as plain calls, never as
    launches); a tensor on any other device goes to the kernel path, which
    refuses anything but CUDA and never reaches bsw_shear_desc_ref."""
    d = make_long(31, 6, (300, 500))
    t = [torch.from_numpy(np.ascontiguousarray(x)) for x in d]
    k = bsw_shear_cuda.BswShear()
    out = k(*t, 100, 900, *PACBIO, 1)
    assert (k.plain_calls, k.launches) == (1, 0)
    np.testing.assert_array_equal(out.numpy(), run_ref(d, 100, PACBIO))
    meta = [x.to("meta") for x in t]
    with pytest.raises(ValueError, match="CUDA"):
        k(*meta, 100, 900, *PACBIO, 1)
    assert (k.plain_calls, k.launches) == (1, 0)

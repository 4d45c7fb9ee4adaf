"""Port extension kernel vs the JAX package and the scalar host kernel.

bwamem2_tpu_torch.ops.bsw.bsw_desc_ref (the plain PyTorch version of the
CUDA kernel) must equal, exactly (int32, tolerance 0: the DP is integer):
  * bwamem2_tpu's XLA kernel bsw_desc_kernel, on both of its tiers;
  * bwamem2_tpu's Pallas kernel bsw_desc_pallas in interpret mode;
  * the port's scalar native kernel (the analog of
    tests/test_device_kernels.py::test_device_bsw_matches_native);
  * the CUDA kernel's own lane-group body (csrc/bsw_group.cuh) compiled
    as host C++, each group an int[G] lane vector stepped in lockstep —
    the exact source the card runs, minus the launch and the warp
    intrinsics: every (G, C) bucket, chosen and forced, the three
    scorings, queries at the bucket edges, tlen 1 and Tmax, pairs that
    stop on a zero row maximum, on z-drop and after their last row, the
    packed genome, and row maxima tied across lanes;
  * DeviceBSW's longest-first launch order against descriptor order.
Inputs are random descriptors over a random doubled genome and read grid,
made with numpy from fixed seeds, covering both qdir and both tdir.
"""

import ctypes
import subprocess

import numpy as np
import pytest
import torch

from bwamem2_tpu.ops.bsw import bsw_desc_kernel
from bwamem2_tpu_torch import native as tnative
from bwamem2_tpu_torch.ops import bsw_cuda
from bwamem2_tpu_torch.ops.bsw import DeviceBSW, bsw_desc_ref
from bwamem2_tpu_torch.ops.device_index import DeviceFMIndex
from bwamem2_tpu_torch.options import MemOptions

# one intra-op thread: the suite runs several xdist workers side by side,
# each with XLA's thread pools, and torch's OpenMP regions oversubscribed
# that way run 100x slower than on one thread
torch.set_num_threads(1)

DEFAULT = (1, 4, 6, 1, 6, 1, 100, 5)      # a b o_del e_del o_ins e_ins zdrop eb
ZDROP_OFF = (1, 4, 6, 1, 6, 1, 0, 5)
INTRACTG = (2, 9, 16, 1, 16, 1, 200, 5)   # int32 tier (large h0)


def make_desc(seed, P, Qmax, Tmax, h0max=120, n_ref=6000, N=48, qedge=()):
    """Random descriptors: pair p reads row p % N of an int8[N, L] grid of
    2%-mutated genome slices (with a few N bases); same-direction pairs
    extend along their source slice, mixed-direction pairs hit unrelated
    targets; a few targets run off the genome's ends (clamped).  With
    qedge, the first pairs take those query lengths, tlen is 1 and Tmax in
    the next two, and every fourth grid row turns random a third of the way
    in, so that the extensions reading it leave their target there (z-drop
    with the narrower bands)."""
    rng = np.random.default_rng(seed)
    L = Qmax + 24
    ref = rng.integers(0, 4, n_ref).astype(np.uint8)
    src = rng.integers(Tmax + 8, n_ref - L - Tmax - 8, N)
    enc = ref[src[:, None] + np.arange(L)[None, :]].astype(np.int8)
    mut = rng.random((N, L)) < 0.02
    enc[mut] = rng.integers(0, 4, int(mut.sum()))
    enc[rng.random((N, L)) < 0.003] = 4
    qlen = rng.integers(1, Qmax + 1, P).astype(np.int32)
    tlen = rng.integers(1, Tmax + 1, P).astype(np.int32)
    if qedge:
        k = len(qedge)
        qlen[:k] = qedge
        tlen[k:k + 2] = (1, Tmax)
        enc[::4, L // 3:] = rng.integers(0, 4, (len(enc[::4]), L - L // 3))
    row = np.arange(P) % N
    c = rng.integers(0, L - Qmax + 1, P)
    qdir = rng.choice([-1, 1], P).astype(np.int32)
    tdir = rng.choice([-1, 1], P).astype(np.int32)
    start = np.where(qdir > 0, c, c + qlen - 1)
    qoff = (row * L + start).astype(np.int32)
    toff = (src[row] + start + rng.choice([0, 0, 0, 1, -2], P)).astype(
        np.int64)
    mixed = qdir != tdir
    toff[mixed] = rng.integers(0, n_ref, int(mixed.sum()))
    edge = rng.random(P) < 0.03
    toff[edge] = rng.choice([0, n_ref - 1], int(edge.sum()))
    h0 = rng.integers(1, h0max, P).astype(np.int32)
    w = rng.choice([20, 50, 100], P).astype(np.int32)
    return ref, enc, qoff, qdir, qlen, toff, tdir, tlen, h0, w


def run_ref(d, Qmax, Tmax, scoring, packed=False, ref=None):
    t = [torch.from_numpy(np.ascontiguousarray(x)) for x in d]
    if ref is not None:
        t[0] = ref
    a, b, od, ed, oi, ei, zd, eb = scoring
    return bsw_desc_ref(*t, Qmax, Tmax, a, b, od, ed, oi, ei, zd, eb,
                        max(a, 1), packed).numpy()


@pytest.mark.parametrize("scoring,h0max,h0cap", [
    (DEFAULT, 120, 256),            # JAX int16 tier
    (ZDROP_OFF, 120, 256),
    (INTRACTG, 2000, 1 << 30),      # JAX int32 tier
], ids=["default", "zdrop_off", "intractg"])
def test_ref_matches_jax_xla_kernel(scoring, h0max, h0cap):
    P, Qmax, Tmax = 128, 127, 96
    d = make_desc(3, P, Qmax, Tmax, h0max)
    a, b, od, ed, oi, ei, zd, eb = scoring
    want = np.asarray(bsw_desc_kernel(*d, Qmax, Tmax, a, b, od, ed, oi, ei,
                                      zd, eb, max(a, 1), False, h0cap))
    np.testing.assert_array_equal(run_ref(d, Qmax, Tmax, scoring), want)


def test_ref_matches_jax_pallas_interpret(monkeypatch):
    monkeypatch.setenv("BWAMEM2_TPU_PALLAS_INTERPRET", "1")
    from bwamem2_tpu.ops.bsw_pallas import bsw_desc_pallas
    P, Qmax, Tmax = 128, 127, 96
    d = make_desc(5, P, Qmax, Tmax)
    want = np.asarray(bsw_desc_pallas(*d, Qmax, Tmax, *DEFAULT, 1, False))
    np.testing.assert_array_equal(run_ref(d, Qmax, Tmax, DEFAULT), want)


def test_device_bsw_matches_native():
    """DeviceBSW.run_arrays on the CPU (rung split + bsw_desc_ref) vs the
    port's scalar native kernel on the materialized sequences."""
    rng = np.random.default_rng(11)
    opt = MemOptions().finalize()
    n_ref, N, L = 4000, 40, 136
    ref = rng.integers(0, 4, n_ref).astype(np.uint8)
    src = rng.integers(300, n_ref - 700, N)
    enc = ref[src[:, None] + np.arange(L)[None, :]].astype(np.int8)
    enc[rng.random((N, L)) < 0.04] = rng.integers(0, 4)
    n = 90
    seqid = rng.integers(0, N, n).astype(np.int32)
    qlen = rng.integers(1, 128, n).astype(np.int32)
    tlen = rng.integers(1, 250, n).astype(np.int32)
    qdir = rng.choice([-1, 1], n).astype(np.int32)
    tdir = qdir.copy()
    qoff = np.where(qdir > 0, 0, qlen - 1).astype(np.int64)
    toff = (src[seqid] + qoff).astype(np.int64)
    toff[::3] = rng.integers(300, n_ref - 300, len(toff[::3]))
    h0 = rng.integers(10, 90, n).astype(np.int32)
    desc = dict(qoff=qoff, qdir=qdir, qlen=qlen, toff=toff, tdir=tdir,
                tlen=tlen, h0=h0, seqid=seqid)
    q = [enc[seqid[i], qoff[i] + qdir[i] * np.arange(qlen[i])]
         .astype(np.uint8) for i in range(n)]
    t = [ref[toff[i] + tdir[i] * np.arange(tlen[i])] for i in range(n)]
    off = lambda xs: np.concatenate([[0], np.cumsum([len(x) for x in xs])
                                     ])[:-1]
    dfm = DeviceFMIndex(ref=torch.from_numpy(ref), ref_packed=False,
                        device=torch.device("cpu"))
    bsw = DeviceBSW(dfm, opt)
    bsw.encj = torch.from_numpy(enc)
    for w in (100, 200):
        want = tnative.bsw_extend_batch(
            np.concatenate(t), off(t), tlen, np.concatenate(q), off(q),
            qlen, h0, w, np.array(opt.mat, np.int8), opt.o_del, opt.e_del,
            opt.o_ins, opt.e_ins, opt.zdrop, opt.pen_clip5)
        got = bsw.run_arrays(desc, w, opt, opt.pen_clip5)
        np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def host_dp(tmp_path_factory):
    """csrc/bsw_group.cuh built as host C++: each lane group is an int[G]
    lane vector stepped in lockstep, and a per-pair loop stands in for the
    CUDA launch.  bsw_host runs the (G, C) bucket the launch would choose
    for Qmax, or the one given, returns it as G * 100 + C, and records per
    pair why its row loop ended (0 zero row maximum, 1 z-drop, 2 ran every
    row)."""
    d = tmp_path_factory.mktemp("bsw_group")
    shim = d / "shim.cpp"
    shim.write_text(r"""
static int *bsw_stops;
#define BSW_STOP_HOOK(p, why) (bsw_stops[p] = (why))
#include "bsw_group.cuh"
template <int G, int C> static void run_all(const BswBatch &b) {
  const BswGroup<G> g;
  for (int p = 0; p < b.P; ++p) bsw_group_pair<C>(g, b, p);
}
extern "C" int bsw_host(const int8_t *enc, int64_t n_enc, const uint8_t *ref,
    int64_t n_ref, int packed, const int *qoff, const int *qdir,
    const int *qlen, const int64_t *toff, const int *tdir, const int *tlen,
    const int *h0, const int *w, int P, int Qmax, const int *sc, int G,
    int C, int *out, int *stops) {
  const BswBatch b{enc, n_enc, ref, n_ref, packed, qoff, qdir, qlen, toff,
                   tdir, tlen, h0, w, P,
                   {sc[0], sc[1], sc[2], sc[3], sc[4], sc[5], sc[6], sc[7],
                    sc[8]}, out};
  if (!G && !bsw_bucket(Qmax, &G, &C)) return 0;
  bsw_stops = stops;
  for (int p = 0; p < P; ++p) stops[p] = 2;
#define BSW_HOST_CASE(g_, c_) \
  if (G == g_ && C == c_) { run_all<g_, c_>(b); return G * 100 + C; }
  BSW_BUCKETS(BSW_HOST_CASE)
  return 0;
}
""")
    so = d / "bsw_group.so"
    subprocess.run(["g++", "-O2", "-std=c++17", "-shared", "-fPIC",
                    "-I", bsw_cuda.CSRC, str(shim), "-o", str(so)],
                   check=True, capture_output=True)
    return ctypes.CDLL(str(so))


def run_host_dp(lib, d, Qmax, scoring, ref=None, packed=False, bucket=None):
    """(out int32[P, 6], bucket G * 100 + C, stop reason per pair)."""
    ref_a, enc, qoff, qdir, qlen, toff, tdir, tlen, h0, w = (
        np.ascontiguousarray(x) for x in d)
    if ref is not None:
        ref_a = np.ascontiguousarray(ref)
    P = len(qoff)
    sc = np.array(list(scoring) + [max(scoring[0], 1)], np.int32)
    out = np.zeros((P, 6), np.int32)
    stops = np.zeros(P, np.int32)
    G, C = bucket or (0, 0)
    ptr = lambda x: ctypes.c_void_p(x.ctypes.data)  # noqa: E731
    got = lib.bsw_host(ptr(enc), ctypes.c_int64(enc.size), ptr(ref_a),
                       ctypes.c_int64(ref_a.size), ctypes.c_int(int(packed)),
                       ptr(qoff), ptr(qdir), ptr(qlen), ptr(toff), ptr(tdir),
                       ptr(tlen), ptr(h0), ptr(w), ctypes.c_int(P),
                       ctypes.c_int(Qmax), ptr(sc), ctypes.c_int(G),
                       ctypes.c_int(C), ptr(out), ptr(stops))
    return out, got, stops


# name: (Qmax, Tmax, scoring, qlen at the bucket edges, forced (G, C) or
# None for the launch's choice, expected (G, C), whether some pair stops on
# z-drop)
HOST_DP = {
    "q31_t96": (31, 96, DEFAULT, (31, 30), None, (8, 4), False),
    "q63_t160_intractg": (63, 160, INTRACTG, (63, 32), None, (8, 8), False),
    "q95_t448_intractg": (95, 448, INTRACTG, (95, 64), None, (16, 6), True),
    "q127_t96": (127, 96, DEFAULT, (127, 96), None, (16, 8), False),
    "q127_t160_intractg": (127, 160, INTRACTG, (127, 126), None, (16, 8),
                           True),
    "q128_t160": (128, 160, DEFAULT, (128, 127), None, (32, 5), False),
    "q159_t320_zdrop_off": (159, 320, ZDROP_OFF, (159, 158), None, (32, 5),
                            False),
    "q160_t224_intractg": (160, 224, INTRACTG, (160, 159), None, (32, 6),
                           True),
    "q255_t224_zdrop_off": (255, 224, ZDROP_OFF, (255, 192), None, (32, 8),
                            False),
    "q256_t448": (256, 448, DEFAULT, (256, 255), None, (32, 10), True),
    "q320_t608": (320, 608, DEFAULT, (320, 319), None, (32, 12), True),
    "q383_t608_intractg": (383, 608, INTRACTG, (383, 256), None, (32, 12),
                           True),
    "q63_forced_16x8": (63, 224, DEFAULT, (63,), (16, 8), (16, 8), False),
    "q127_forced_32x5": (127, 160, INTRACTG, (127,), (32, 5), (32, 5), True),
    "q127_forced_32x8": (127, 96, ZDROP_OFF, (127,), (32, 8), (32, 8), False),
    "q159_forced_32x12": (159, 448, DEFAULT, (159,), (32, 12), (32, 12),
                          False),
    "q255_forced_32x12": (255, 320, DEFAULT, (255,), (32, 12), (32, 12),
                          True),
}


@pytest.mark.parametrize("name", list(HOST_DP))
def test_cuda_dp_source_matches_ref(host_dp, name):
    """The kernel's group source, built with g++, equals the plain version
    array for array at every (G, C) bucket, chosen from Qmax and forced,
    under the three scorings, with queries at the bucket edges, tlen 1 and
    tlen = Tmax, both walk directions, and pairs that stop on a zero row
    maximum, on z-drop and after their last row."""
    Qmax, Tmax, scoring, edges, forced, bucket, zdrops = HOST_DP[name]
    d = make_desc(17 + Qmax, 96, Qmax, Tmax,
                  2000 if scoring is INTRACTG else 120, qedge=edges)
    got, used, stops = run_host_dp(host_dp, d, Qmax, scoring, bucket=forced)
    assert used == bucket[0] * 100 + bucket[1]
    np.testing.assert_array_equal(got, run_ref(d, Qmax, Tmax, scoring))
    assert set(d[4][:len(edges)]) == set(edges)
    assert {1, Tmax} <= set(d[7])
    assert (stops == 0).any() and (stops == 2).any()
    assert (stops == 1).any() == zdrops


def test_cuda_dp_source_packed_ref(host_dp, monkeypatch):
    """The kernel's 2-bit packed genome path against the reference's."""
    d = make_desc(23, 96, 127, 160)
    monkeypatch.setattr(DeviceFMIndex, "REF_PACK_MIN", 16)
    dfm = DeviceFMIndex.from_genome(d[0], "cpu")
    assert dfm.ref_packed
    got, _, _ = run_host_dp(host_dp, d, 127, DEFAULT, ref=dfm.ref.numpy(),
                            packed=True)
    want_packed = run_ref(d, 127, 160, DEFAULT, packed=True, ref=dfm.ref)
    np.testing.assert_array_equal(got, want_packed)
    np.testing.assert_array_equal(got, run_ref(d, 127, 160, DEFAULT))


def tie_desc(n=24, seed=83):
    """Pairs whose row maxima tie at two columns four apart: the target is
    a period-4 sequence and the query four bases Z (two of them mismatching
    the target's first four) followed by the target.  Row i scores
    h0 + i + 1 - 10 on the diagonal (two mismatches) and at column i + 4 (a
    4-base insertion at the start); the maximum rises every row, so the
    rightmost-tie rule decides max_j and with it qle.  In half the rows
    the two columns fall in different lanes.  Half the pairs walk
    backwards."""
    rng = np.random.default_rng(seed)
    L, seg = 400, 300
    ref = rng.integers(0, 4, 200 + n * seg).astype(np.uint8)
    enc = rng.integers(0, 4, (n, L)).astype(np.int8)
    qoff, qdir, qlen, tdir, tlen = (np.zeros(n, np.int32) for _ in range(5))
    toff = np.zeros(n, np.int64)
    for i in range(n):
        unit = rng.integers(0, 4, 4)
        tl = int(rng.integers(40, 240))
        ql = int(rng.integers(tl + 5, min(tl + 120, seg) + 1))
        t = np.tile(unit, seg // 4)[:seg]
        z = unit.copy()
        for k in rng.choice(4, 2, replace=False):
            z[k] = (z[k] + rng.integers(1, 4)) % 4
        q = np.concatenate([z, t])[:ql].astype(np.int8)
        s = 100 + i * seg
        rev = i % 2 == 1
        ref[s:s + seg] = t[::-1] if rev else t
        enc[i, :ql] = q[::-1] if rev else q
        qoff[i] = i * L + (ql - 1 if rev else 0)
        toff[i] = s + seg - 1 if rev else s
        qdir[i] = tdir[i] = -1 if rev else 1
        qlen[i], tlen[i] = ql, tl
    h0 = rng.integers(20, 60, n).astype(np.int32)
    w = np.full(n, 100, np.int32)
    return ref, enc, qoff, qdir, qlen, toff, tdir, tlen, h0, w


@pytest.mark.parametrize("bucket", [(32, 12), (32, 8)],
                         ids=["32x12", "32x8"])
def test_cuda_dp_source_row_max_ties(host_dp, bucket):
    """Row maxima tied across lanes go to the rightmost column, as in the
    plain version: every pair's qle is the insertion path's column."""
    d = tie_desc()
    Qmax = int(d[4].max())
    if bucket[0] * bucket[1] <= Qmax:
        d = [x[d[4] < bucket[0] * bucket[1]] if i > 1 else x
             for i, x in enumerate(d)]
        Qmax = int(d[4].max())
    got, _, stops = run_host_dp(host_dp, d, Qmax, DEFAULT, bucket=bucket)
    want = run_ref(d, Qmax, int(d[7].max()), DEFAULT)
    np.testing.assert_array_equal(got, want)
    # nearly every pair's best row is its last, with its maximum at the
    # insertion path's column tlen + 3
    assert (stops == 2).all()
    assert (want[:, 2] == d[7]).mean() > 0.9
    assert (want[:, 1] == d[7] + 4).mean() > 0.9


def test_launch_order_keeps_output(monkeypatch):
    """DeviceBSW launches each rung group longest first, by descending
    (tlen, qlen) with ties in descriptor order, sizes each launch by its
    longest query, and returns the results in descriptor order."""
    n = 700
    d = make_desc(37, n, 255, 600)
    ref, enc, qoff, qdir, qlen, toff, tdir, tlen, h0, w = d
    N, L = enc.shape
    seqid = (qoff // L).astype(np.int32)
    desc = dict(qoff=(qoff - seqid * L).astype(np.int32), qdir=qdir,
                qlen=qlen, toff=toff, tdir=tdir, tlen=tlen, h0=h0,
                seqid=seqid)
    calls = []

    def record(*args):
        calls.append(args)
        return bsw_desc_ref(*args)

    monkeypatch.setattr(bsw_cuda, "bsw_extend", record)
    opt = MemOptions().finalize()
    dfm = DeviceFMIndex(ref=torch.from_numpy(ref), ref_packed=False,
                        device=torch.device("cpu"))
    bsw = DeviceBSW(dfm, opt)
    bsw.encj = torch.from_numpy(enc)
    got = bsw.run_arrays(desc, 100, opt, opt.pen_clip5)
    order = DeviceBSW.launch_order(qlen, tlen)
    assert len(calls) == len(order) > 1
    seen = []
    for args, (Q, T, idx) in zip(calls, order):
        key = list(zip(tlen[idx], qlen[idx]))
        assert key == sorted(key, reverse=True)
        ties = [k for k in set(key) if key.count(k) > 1]
        for k in ties:          # stable: ties keep descriptor order
            run = [i for i, kk in zip(idx, key) if kk == k]
            assert run == sorted(run)
        assert (np.diff(idx) < 0).any()          # really reordered
        assert args[10] == Q == int(qlen[idx].max())
        assert args[11] == T
        np.testing.assert_array_equal(args[7].numpy(), tlen[idx])
        seen.extend(idx)
    assert sorted(seen) == list(range(n))
    want = bsw_desc_ref(*[torch.from_numpy(np.ascontiguousarray(x))
                          for x in d[:-1]],
                        torch.full((n,), 100, dtype=torch.int32), 255, 600,
                        opt.a, opt.b, opt.o_del, opt.e_del, opt.o_ins,
                        opt.e_ins, opt.zdrop, opt.pen_clip5, max(opt.a, 1))
    np.testing.assert_array_equal(got, want.numpy())


def test_wrapper_dispatch():
    """CPU tensors run the plain version (counted as plain calls, never as
    launches); a tensor on any other device goes to the kernel path, which
    refuses anything but CUDA and never reaches bsw_desc_ref."""
    d = make_desc(29, 8, 127, 96)
    t = [torch.from_numpy(np.ascontiguousarray(x)) for x in d]
    k = bsw_cuda.BswExtend()
    out = k(*t, 127, 96, *DEFAULT, 1)
    assert (k.plain_calls, k.launches) == (1, 0)
    np.testing.assert_array_equal(out.numpy(), run_ref(d, 127, 96, DEFAULT))
    meta = [x.to("meta") for x in t]
    with pytest.raises(ValueError, match="CUDA"):
        k(*meta, 127, 96, *DEFAULT, 1)
    assert (k.plain_calls, k.launches) == (1, 0)


@pytest.mark.cuda
def test_cuda_kernel_matches_ref_on_card():
    """On a machine with a GPU: the built kernel against bsw_desc_ref on
    the card at the three Q rungs (chip_smoke.py covers every rung)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for Qmax, Tmax, scoring in ((127, 96, DEFAULT), (255, 224, ZDROP_OFF),
                                (383, 608, INTRACTG)):
        d = make_desc(31 + Qmax, 512, Qmax, Tmax,
                      2000 if scoring is INTRACTG else 120)
        t = [torch.from_numpy(np.ascontiguousarray(x)).cuda() for x in d]
        a = scoring[0]
        args = (*t, Qmax, Tmax, *scoring, max(a, 1), False)
        n = bsw_cuda.bsw_extend.launches
        got = bsw_cuda.bsw_extend(*args)
        torch.cuda.synchronize()
        assert bsw_cuda.bsw_extend.launches == n + 1
        np.testing.assert_array_equal(got.cpu().numpy(),
                                      bsw_desc_ref(*args).cpu().numpy())

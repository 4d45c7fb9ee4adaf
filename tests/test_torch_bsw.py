"""Port extension kernel vs the JAX package and the scalar host kernel.

bwamem2_tpu_torch.ops.bsw.bsw_desc_ref (the plain PyTorch version of the
CUDA kernel) must equal, exactly (int32, tolerance 0: the DP is integer):
  * bwamem2_tpu's XLA kernel bsw_desc_kernel, on both of its tiers;
  * bwamem2_tpu's Pallas kernel bsw_desc_pallas in interpret mode;
  * the port's scalar native kernel (the analog of
    tests/test_device_kernels.py::test_device_bsw_matches_native);
  * the CUDA kernel's own per-pair DP (csrc/bsw_extend_dp.cuh) compiled
    as host C++ — the exact code the card runs, minus the launch.
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


def make_desc(seed, P, Qmax, Tmax, h0max=120, n_ref=6000, N=48):
    """Random descriptors: pair p reads row p % N of an int8[N, L] grid of
    2%-mutated genome slices (with a few N bases); same-direction pairs
    extend along their source slice, mixed-direction pairs hit unrelated
    targets; a few targets run off the genome's ends (clamped)."""
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
    """csrc/bsw_extend_dp.cuh built as host C++ with a per-pair loop in
    place of the CUDA launch (same scratch layout and strides)."""
    d = tmp_path_factory.mktemp("dp")
    shim = d / "shim.cpp"
    shim.write_text(r'''
#define BSW_HD static inline
#include "bsw_extend_dp.cuh"
extern "C" void bsw_host(const int8_t *enc, int64_t n_enc, const uint8_t *ref,
    int64_t n_ref, int packed, const int *qoff, const int *qdir,
    const int *qlen, const int64_t *toff, const int *tdir, const int *tlen,
    const int *h0, const int *w, int P, int Qmax, const int *sc,
    int *scratch, int *out) {
  BswParams sp{sc[0], sc[1], sc[2], sc[3], sc[4], sc[5], sc[6], sc[7], sc[8]};
  for (int p = 0; p < P; ++p)
    bsw_pair(enc, n_enc, ref, n_ref, packed, qoff[p], qdir[p], qlen[p],
             toff[p], tdir[p], tlen[p], h0[p], w[p], sp, scratch + p,
             scratch + (int64_t)(Qmax + 1) * P + p, P, out + 6 * p);
}
''')
    so = d / "dp.so"
    subprocess.run(["g++", "-O2", "-std=c++17", "-shared", "-fPIC",
                    "-I", bsw_cuda.CSRC, str(shim), "-o", str(so)],
                   check=True, capture_output=True)
    return ctypes.CDLL(str(so))


def run_host_dp(lib, d, Qmax, scoring, ref=None, packed=False):
    ref_a, enc, qoff, qdir, qlen, toff, tdir, tlen, h0, w = (
        np.ascontiguousarray(x) for x in d)
    if ref is not None:
        ref_a = np.ascontiguousarray(ref)
    P = len(qoff)
    a = scoring[0]
    sc = np.array(list(scoring) + [max(a, 1)], np.int32)
    scratch = np.zeros(2 * (Qmax + 1) * P, np.int32)
    out = np.zeros((P, 6), np.int32)
    ptr = lambda x: ctypes.c_void_p(x.ctypes.data)
    lib.bsw_host(ptr(enc), ctypes.c_int64(enc.size), ptr(ref_a),
                 ctypes.c_int64(ref_a.size), ctypes.c_int(int(packed)),
                 ptr(qoff), ptr(qdir), ptr(qlen), ptr(toff), ptr(tdir),
                 ptr(tlen), ptr(h0), ptr(w), ctypes.c_int(P),
                 ctypes.c_int(Qmax), ptr(sc), ptr(scratch), ptr(out))
    return out


@pytest.mark.parametrize("Qmax,Tmax,scoring", [
    (127, 96, DEFAULT), (255, 224, ZDROP_OFF), (383, 608, INTRACTG),
], ids=["q127_t96", "q255_t224_zdrop_off", "q383_t608_intractg"])
def test_cuda_dp_source_matches_ref(host_dp, Qmax, Tmax, scoring):
    d = make_desc(17 + Qmax, 96, Qmax, Tmax,
                  2000 if scoring is INTRACTG else 120)
    np.testing.assert_array_equal(run_host_dp(host_dp, d, Qmax, scoring),
                                  run_ref(d, Qmax, Tmax, scoring))


def test_cuda_dp_source_packed_ref(host_dp, monkeypatch):
    """The kernel's 2-bit packed genome path against the reference's."""
    d = make_desc(23, 96, 127, 160)
    monkeypatch.setattr(DeviceFMIndex, "REF_PACK_MIN", 16)
    dfm = DeviceFMIndex.from_genome(d[0], "cpu")
    assert dfm.ref_packed
    got = run_host_dp(host_dp, d, 127, DEFAULT, ref=dfm.ref.numpy(),
                      packed=True)
    want_packed = run_ref(d, 127, 160, DEFAULT, packed=True, ref=dfm.ref)
    np.testing.assert_array_equal(got, want_packed)
    np.testing.assert_array_equal(got, run_ref(d, 127, 160, DEFAULT))


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

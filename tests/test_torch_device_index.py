"""Port device FM-index vs the JAX package's, exact (tolerance 0: integer).

* DeviceFMIndex.from_host carries the same leaves as the JAX from_host,
  array for array.
* The plain primitives (occ_one, occ_all4, backward_ext_full, bwt_char_occ,
  bwt_char) equal the JAX ones on random positions of the fixture index,
  including the sentinel's block and both table ends.
* The has_hi plane (counts above 2^32, a hi byte >= 128 making the packed
  word negative) on the synthetic index of
  tests/test_device_kernels.py::test_occ_hi_plane_above_2gbp, rebuilt
  here, against brute force and the JAX primitives.
* csrc/fm_occ.cuh compiled as host C++ — the code the kernels run, minus
  the launch — equals the plain primitives on both indexes.  The same
  host build carries csrc/smem_group.cuh, which tests/test_torch_seed.py
  holds against smem_collect_ref.
"""

import ctypes
import os
import subprocess
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bwamem2_tpu.index.fmindex import FMIndex as JaxFMIndex
from bwamem2_tpu.ops import device_index as jdi
from bwamem2_tpu_torch.index.fmindex import FMIndex
from bwamem2_tpu_torch.ops import device_index as tdi
from bwamem2_tpu_torch.ops.cuda_build import CSRC

from conftest import FIXTURES

# one intra-op thread: the suite runs several xdist workers side by side,
# each with XLA's thread pools (see tests/test_torch_bsw.py)
torch.set_num_threads(1)

PREFIX = os.path.join(FIXTURES, "ref_small.fa")

# host build of the kernels' shared device code: the primitives of
# fm_occ.cuh, the lane-group seeding body of smem_group.cuh (G lanes
# stepped in lockstep) and the SA walk-and-refill loop of sa_group.cuh (a
# warp of 32 lanes in lockstep over a host ticket counter), each behind a
# loop over the batch in place of the launch; the group body's event counts
# land in smem_stats, the SA loop's row reads in sa_rows
SHIM = r'''
#include <vector>
static long long smem_stats[2];
#define SMEM_STAT_HOOK(what, n) (smem_stats[what] += (n))
static long long sa_rows;
#define SA_ROW_HOOK() (sa_rows += 1)
#include "smem_group.cuh"
#include "sa_group.cuh"
#define FMARGS const int32_t *occp, const int32_t *occ_hi, int has_hi, \
    const int64_t *counts, int64_t sent
static FmView mk(FMARGS) {
  return FmView{occp, occ_hi, {counts[0], counts[1], counts[2], counts[3],
                               counts[4]}, sent, has_hi};
}
extern "C" void h_occ4(FMARGS, const int64_t *pos, int64_t n, int64_t *out) {
  FmView f = mk(occp, occ_hi, has_hi, counts, sent);
  for (int64_t i = 0; i < n; ++i) fm_occ4(f, pos[i], out + 4 * i);
}
extern "C" void h_occ_one(FMARGS, const int64_t *pos, const int32_t *c,
                          int64_t n, int64_t *out) {
  FmView f = mk(occp, occ_hi, has_hi, counts, sent);
  for (int64_t i = 0; i < n; ++i) out[i] = fm_occ_one(f, pos[i], c[i]);
}
extern "C" void h_bwd_ext(FMARGS, const int64_t *k, const int64_t *l,
                          const int64_t *s, const int32_t *a, int64_t n,
                          int64_t *ko, int64_t *lo, int64_t *so) {
  FmView f = mk(occp, occ_hi, has_hi, counts, sent);
  for (int64_t i = 0; i < n; ++i)
    fm_backward_ext(f, k[i], l[i], s[i], a[i], ko + i, lo + i, so + i);
}
extern "C" void h_bwt_char_occ(FMARGS, const int64_t *pos, int64_t n,
                               int32_t *ch, int64_t *occ) {
  FmView f = mk(occp, occ_hi, has_hi, counts, sent);
  for (int64_t i = 0; i < n; ++i) {
    uint32_t r[8];
    fm_row(f, pos[i] >> 6, r);
    ch[i] = fm_char_occ_row(f, r, has_hi ? fm_hi(f, pos[i] >> 6) : 0u,
                            pos[i], occ + i);
  }
}
extern "C" long long h_sa_group(FMARGS, const int8_t *ms,
                                const uint32_t *ls, const int64_t *pos,
                                int64_t n, int W, const int64_t *perm,
                                int64_t *out) {
  const SaBatch b{mk(occp, occ_hi, has_hi, counts, sent), ms, ls, pos, n,
                  out};
  SaWarp g;
  g.perm = perm;
  sa_rows = 0;
  if (W == 1) sa_group_run<1>(g, b);
  else if (W == 2) sa_group_run<2>(g, b);
  else if (W == 4) sa_group_run<4>(g, b);
  else return -1;
  return sa_rows;
}
template <int G>
static void group_reads(const SmemBatch &b, int lcap) {
  std::vector<int64_t> mem(smem_group_bytes(lcap) / 8 + 1);
  const SmemGroup<G> g;
  for (int r = 0; r < b.N; ++r)
    smem_group_run(g, b, lcap, r, reinterpret_cast<unsigned char *>(mem.data()));
}
extern "C" int h_smem_group(FMARGS, const int8_t *enc, const int32_t *lens,
    const int64_t *slot_off, int N, int L, int msl, int split_len,
    int64_t split_width, int64_t max_mem_intv, int G, int lcap, int32_t *om,
    int32_t *on, int64_t *ok, int64_t *os, int32_t *ocnt, int64_t *onbwd,
    int64_t *stats) {
  SmemBatch b{mk(occp, occ_hi, has_hi, counts, sent), enc, lens, nullptr,
              slot_off, N, L, SmemParams{msl, split_len, split_width,
                                         max_mem_intv},
              om, on, ok, os, ocnt, onbwd};
  smem_stats[0] = smem_stats[1] = 0;
  if (G == 16) group_reads<16>(b, lcap);
  else if (G == 32) group_reads<32>(b, lcap);
  else return 1;
  stats[0] = smem_stats[0];
  stats[1] = smem_stats[1];
  return 0;
}
'''


def build_host_shim(d) -> ctypes.CDLL:
    src = os.path.join(d, "fm_shim.cpp")
    with open(src, "w") as f:
        f.write(SHIM)
    so = os.path.join(d, "fm_shim.so")
    subprocess.run(["g++", "-O2", "-std=c++17", "-shared", "-fPIC",
                    "-I", CSRC, src, "-o", so], check=True,
                   capture_output=True)
    return ctypes.CDLL(so)


class HostFm:
    """numpy-facing calls into the host shim for one DeviceFMIndex (CPU)."""

    def __init__(self, lib, dfm):
        self.lib = lib
        self.keep = [np.ascontiguousarray(dfm.occp.numpy()),
                     np.ascontiguousarray(dfm.occ_hi.numpy()),
                     np.ascontiguousarray(dfm.counts.numpy())]
        self.fm = [self._p(self.keep[0]), self._p(self.keep[1]),
                   ctypes.c_int(int(dfm.has_hi)), self._p(self.keep[2]),
                   ctypes.c_int64(int(dfm.sentinel))]
        self.ms = np.ascontiguousarray(dfm.sa_ms.numpy()) \
            if dfm.sa_ms is not None else None
        self.ls = np.ascontiguousarray(dfm.sa_ls.numpy()) \
            if dfm.sa_ls is not None else None

    @staticmethod
    def _p(a):
        return ctypes.c_void_p(a.ctypes.data)

    def call(self, name, *arrays_and_scalars):
        args = [self._p(a) if isinstance(a, np.ndarray) else a
                for a in arrays_and_scalars]
        getattr(self.lib, name)(*self.fm, *args)

    def occ4(self, pos):
        pos = np.ascontiguousarray(pos, np.int64)
        out = np.zeros((len(pos), 4), np.int64)
        self.call("h_occ4", pos, ctypes.c_int64(len(pos)), out)
        return out

    def occ_one(self, pos, c):
        pos = np.ascontiguousarray(pos, np.int64)
        c = np.ascontiguousarray(c, np.int32)
        out = np.zeros(len(pos), np.int64)
        self.call("h_occ_one", pos, c, ctypes.c_int64(len(pos)), out)
        return out

    def bwd_ext(self, k, l, s, a):
        k, l, s = (np.ascontiguousarray(x, np.int64) for x in (k, l, s))
        a = np.ascontiguousarray(a, np.int32)
        o = [np.zeros(len(k), np.int64) for _ in range(3)]
        self.call("h_bwd_ext", k, l, s, a, ctypes.c_int64(len(k)), *o)
        return o

    def bwt_char_occ(self, pos):
        pos = np.ascontiguousarray(pos, np.int64)
        ch = np.zeros(len(pos), np.int32)
        occ = np.zeros(len(pos), np.int64)
        self.call("h_bwt_char_occ", pos, ctypes.c_int64(len(pos)), ch, occ)
        return ch, occ

    def sa_group(self, pos, W=1, perm=None):
        """sa_group.cuh's loop at W walks per lane over `pos`, tickets
        resolved in the order `perm` (input order when None): (coordinates,
        occ-row reads)."""
        pos = np.ascontiguousarray(pos, np.int64)
        out = np.zeros(len(pos), np.int64)
        if perm is not None:
            perm = np.ascontiguousarray(perm, np.int64)
        fn = self.lib.h_sa_group
        fn.restype = ctypes.c_longlong
        rows = fn(*self.fm, self._p(self.ms), self._p(self.ls),
                  self._p(pos), ctypes.c_int64(len(pos)), ctypes.c_int(W),
                  None if perm is None else self._p(perm), self._p(out))
        assert rows >= 0
        return out, rows

    def smem_group(self, enc, lens, msl, split_len, split_width,
                   max_mem_intv, lcap, slot_off, G):
        """smem_group.cuh's body with G lanes over every read: (m, n, k, s
        flat slots, cnt, nbwd, {"passes", "ties"})."""
        enc = np.ascontiguousarray(enc, np.int8)
        lens = np.ascontiguousarray(lens, np.int32)
        slot_off = np.ascontiguousarray(slot_off, np.int64)
        N, L = enc.shape
        S = int(slot_off[-1])
        m, n = np.zeros(S, np.int32), np.zeros(S, np.int32)
        k, s = np.zeros(S, np.int64), np.zeros(S, np.int64)
        cnt, nbwd = np.zeros(N, np.int32), np.zeros(N, np.int64)
        stats = np.zeros(2, np.int64)
        I = ctypes.c_int
        fn = self.lib.h_smem_group
        fn.restype = ctypes.c_int
        args = [self._p(a) if isinstance(a, np.ndarray) else a for a in (
            enc, lens, slot_off, I(N), I(L), I(msl), I(split_len),
            ctypes.c_int64(split_width), ctypes.c_int64(max_mem_intv), I(G),
            I(lcap), m, n, k, s, cnt, nbwd, stats)]
        assert fn(*self.fm, *args) == 0, G
        return m, n, k, s, cnt, nbwd, dict(passes=int(stats[0]),
                                           ties=int(stats[1]))


@pytest.fixture(scope="session")
def host_shim(tmp_path_factory):
    return build_host_shim(str(tmp_path_factory.mktemp("fm_shim")))


@pytest.fixture(scope="module")
def pair():
    """(JAX DeviceFMIndex, port DeviceFMIndex on the CPU, port FMIndex)."""
    tfm = FMIndex.load(PREFIX)
    return (jdi.DeviceFMIndex.from_host(JaxFMIndex.load(PREFIX)),
            tdi.DeviceFMIndex.from_host(tfm, "cpu"), tfm)


def synthetic_hi():
    """The has_hi synthetic index of test_device_kernels.py:352-399: 300
    BWT chars (5 blocks, the last partial), sentinel at 137, checkpoint
    bases above 2^32 with hi bytes 131 and 144 (the latter in bits 24..31
    of occ_hi, so the packed word is negative).  Returns (bwt, base, sent,
    JAX index, port index)."""
    rng = np.random.default_rng(42)
    n, sent = 300, 137
    bwt = rng.integers(0, 4, n).astype(np.int64)
    base = np.array([(3 << 32) | 5, (131 << 32) | 7,
                     (1 << 32) | 11, (144 << 32) | 13], np.int64)
    nb = (n + 63) // 64
    one_hot = np.zeros((nb, 4), np.uint64)
    cp = np.zeros((nb, 4), np.int64)
    run = base.copy()
    for b in range(nb):
        cp[b] = run
        for p in range(64 * b, min(64 * b + 64, n)):
            if p == sent:
                continue
            one_hot[b, bwt[p]] |= np.uint64(1) << np.uint64(63 - (p & 63))
            run[bwt[p]] += 1
    occp, occ_hi = jdi.pack_occ_rows(cp, one_hot)
    t_occp, t_hi = tdi.pack_occ_rows(cp, one_hot)
    np.testing.assert_array_equal(occp, t_occp)
    np.testing.assert_array_equal(occ_hi, t_hi)
    assert (occ_hi < 0).any()
    dummy64 = jnp.zeros(1, jnp.int64)
    jd = jdi.DeviceFMIndex(
        occp=jnp.asarray(occp), occ_hi=jnp.asarray(occ_hi),
        counts=jnp.zeros(5, jnp.int64), sa_ms=jnp.zeros(1, jnp.int8),
        sa_ls=jnp.zeros(1, jnp.uint32), sentinel=jnp.int64(sent),
        ref=jnp.zeros(1, jnp.uint8), lut_k=dummy64, lut_s=dummy64,
        has_hi=True)
    td = tdi.DeviceFMIndex(
        ref=torch.zeros(1, dtype=torch.uint8), ref_packed=False,
        device=torch.device("cpu"), occp=torch.from_numpy(occp),
        occ_hi=torch.from_numpy(occ_hi),
        counts=torch.zeros(5, dtype=torch.int64),
        sentinel=torch.tensor(sent, dtype=torch.int64), has_hi=True)
    return bwt, base, sent, jd, td


def test_from_host_leaves_match_jax(pair):
    jd, td, _ = pair
    assert td.has_hi == jd.has_hi is False
    assert td.ref_packed == jd.ref_packed
    for name in ("occp", "occ_hi", "counts", "sa_ms", "sentinel", "ref"):
        j, t = np.asarray(getattr(jd, name)), getattr(td, name).numpy()
        assert t.dtype == j.dtype, name
        np.testing.assert_array_equal(t, j, err_msg=name)
    # sa_ls: uint32 values carried as int32 bits
    assert td.sa_ls.dtype == torch.int32
    np.testing.assert_array_equal(td.sa_ls.numpy().view(np.uint32),
                                  np.asarray(jd.sa_ls))


def _positions(n, sent, seed):
    """Random positions over [0, n] plus both ends and the sentinel's
    block (every offset of it)."""
    rng = np.random.default_rng(seed)
    blk0 = (sent >> 6) << 6
    extra = np.arange(blk0, min(blk0 + 65, n + 1))
    return np.concatenate([rng.integers(0, n + 1, 1500), [0, 1, n - 1, n],
                           extra]).astype(np.int64)


def test_plain_primitives_match_jax(pair):
    jd, td, tfm = pair
    n = tfm.ref_seq_len - 1
    sent = int(tfm.sentinel_index)
    pos = _positions(n, sent, 7)
    rng = np.random.default_rng(8)
    c = rng.integers(0, 4, len(pos)).astype(np.int32)
    tp = torch.from_numpy(pos)
    np.testing.assert_array_equal(
        tdi.occ_all4(td, tp).numpy(), np.asarray(jdi.occ_all4(jd, pos)))
    np.testing.assert_array_equal(
        tdi.occ_one(td, tp, torch.from_numpy(c)).numpy(),
        np.asarray(jdi.occ_one(jd, pos, jnp.asarray(c))))
    p1 = pos[pos < n]
    for t, j in zip(tdi.bwt_char_occ(td, torch.from_numpy(p1)),
                    jdi.bwt_char_occ(jd, p1)):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    np.testing.assert_array_equal(tdi.bwt_char(td, torch.from_numpy(p1)),
                                  np.asarray(jdi.bwt_char(jd, p1)))
    # backward_ext on real intervals: [k, k+s) inside the BWT
    k = rng.integers(0, n, 1500).astype(np.int64)
    s = np.minimum(rng.integers(0, 400, 1500), n - k).astype(np.int64)
    k = np.concatenate([k, [0, sent, sent - 3, n - 1]])
    s = np.concatenate([s, [n, 1, 5, 1]])
    l = rng.integers(0, n, len(k)).astype(np.int64)
    a = rng.integers(0, 4, len(k)).astype(np.int32)
    got = tdi.backward_ext_full(td, *(torch.from_numpy(x)
                                      for x in (k, l, s, a)))
    want = jdi.backward_ext_full(jd, k, l, s, jnp.asarray(a))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_plain_primitives_has_hi_plane():
    bwt, base, sent, jd, td = synthetic_hi()
    n = len(bwt)

    def brute(p, c):
        return int(base[c]) + sum(1 for q in range(p)
                                  if q != sent and bwt[q] == c)

    pos = np.arange(0, n + 1, dtype=np.int64)
    got4 = tdi.occ_all4(td, torch.from_numpy(pos)).numpy()
    np.testing.assert_array_equal(got4, np.asarray(jdi.occ_all4(jd, pos)))
    for c in range(4):
        np.testing.assert_array_equal(got4[:, c],
                                      [brute(int(p), c) for p in pos])
        np.testing.assert_array_equal(
            tdi.occ_one(td, torch.from_numpy(pos), c).numpy(), got4[:, c])
    ch, occ = tdi.bwt_char_occ(td, torch.from_numpy(pos[:-1]))
    jch, jocc = jdi.bwt_char_occ(jd, pos[:-1])
    np.testing.assert_array_equal(ch.numpy(), np.asarray(jch))
    np.testing.assert_array_equal(occ.numpy(), np.asarray(jocc))
    np.testing.assert_array_equal(ch.numpy(),
                                  np.where(pos[:-1] == sent, 4, bwt))


@pytest.mark.parametrize("which", ["fixture", "has_hi"])
def test_fm_occ_header_matches_plain(host_shim, pair, which):
    """csrc/fm_occ.cuh (host build) == the plain primitives."""
    if which == "fixture":
        _, td, tfm = pair
        n, sent = tfm.ref_seq_len - 1, int(tfm.sentinel_index)
    else:
        bwt, _, sent, _, td = synthetic_hi()
        n = len(bwt)
    h = HostFm(host_shim, td)
    pos = _positions(n, sent, 9)
    tp = torch.from_numpy(pos)
    np.testing.assert_array_equal(h.occ4(pos), tdi.occ_all4(td, tp).numpy())
    c = np.random.default_rng(10).integers(0, 4, len(pos)).astype(np.int32)
    np.testing.assert_array_equal(
        h.occ_one(pos, c), tdi.occ_one(td, tp, torch.from_numpy(c)).numpy())
    p1 = pos[pos < n]
    hc, ho = h.bwt_char_occ(p1)
    tc, to = tdi.bwt_char_occ(td, torch.from_numpy(p1))
    np.testing.assert_array_equal(hc, tc.numpy())
    np.testing.assert_array_equal(ho, to.numpy())
    rng = np.random.default_rng(11)
    k = rng.integers(0, n, 1000).astype(np.int64)
    s = np.minimum(rng.integers(0, 300, 1000), n - k).astype(np.int64)
    l = rng.integers(0, n, 1000).astype(np.int64)
    a = rng.integers(0, 4, 1000).astype(np.int32)
    got = h.bwd_ext(k, l, s, a)
    want = tdi.backward_ext_full(td, *(torch.from_numpy(x)
                                       for x in (k, l, s, a)))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w.numpy())

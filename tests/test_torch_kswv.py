"""Port mate-rescue SW vs the JAX package and the scalar host kernel.

bwamem2_tpu_torch.ops.kswv must equal, exactly (int32, tolerance 0: the DP
is integer):
  * kswv_two_phase_ref (the plain PyTorch version of the CUDA kernel) vs
    bwamem2_tpu's XLA kswv_two_phase, both phases array for array, on the
    random windows of tests/test_device_kernels.py (u8 class, seed 23; i16
    class, seed 31) under three scorings, and on i16-length problems in the
    u8 class, whose lanes saturate;
  * DeviceKswv.align_batch on the CPU vs the port's native ksw_align per
    problem, both classes, also on problems longer than the JAX package's
    device caps (qlen > 512, tlen > 2048);
  * the CUDA kernel's own lane-group body (csrc/kswv_group.cuh) compiled
    as host C++, each group an int[NL] lane vector stepped in lockstep —
    the exact source the card runs, minus the launch and the warp
    intrinsics — vs the plain version: both classes, every register bucket
    and the shared-memory stripes, saturating lanes, rows that need several
    lazy-F sweeps, qe decided by its tie rule (tie_windows) and the 2-bit
    packed genome;
  * DeviceKswv's length-sorted launch order against descriptor order;
  * the i16 problems whose scores can pass 16 bits, where the plain
    version and the kernel's group source saturate at 32767 as the native
    ksw_align does, against it (and the JAX package, which sends qlen >
    512 to the native kernel; below that its int32 emulation does not
    saturate, so it is not the reference there);
  * the real rescue descriptors of the reads_r1/r2.fq chunk, from
    hostrt.rescue_pre_batch, through the port's and JAX's DeviceKswv.
Inputs are made with numpy from fixed seeds.
"""

import ctypes
import functools
import os
import subprocess
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bwamem2_tpu.ops.kswv import DeviceKswv as JaxDeviceKswv
from bwamem2_tpu.ops.kswv import kswv_two_phase
from bwamem2_tpu_torch.align.pipeline import Aligner
from bwamem2_tpu_torch.align.seeding import encode_reads
from bwamem2_tpu_torch.benchdata import rescue_batch, rescue_windows
from bwamem2_tpu_torch.index.fmindex import FMIndex
from bwamem2_tpu_torch.io.fastq import FastxReader, read_chunk
from bwamem2_tpu_torch.native import hostrt, ksw_align_desc
from bwamem2_tpu_torch.ops import kswv_cuda
from bwamem2_tpu_torch.ops.backend import _pad_reads
from bwamem2_tpu_torch.ops.cuda_build import CSRC
from bwamem2_tpu_torch.ops.device_index import DeviceFMIndex
from bwamem2_tpu_torch.ops.kswv import DeviceKswv, kswv_two_phase_ref
from bwamem2_tpu_torch.options import MEM_F_PE, MemOptions

from conftest import DATA, FIXTURES

# one intra-op thread: the suite runs several xdist workers side by side,
# each with XLA's thread pools, and torch's OpenMP regions oversubscribed
# that way run 100x slower than on one thread
torch.set_num_threads(1)

PREFIX = os.path.join(FIXTURES, "ref_small.fa")
DEFAULT = (1, 4, 6, 1, 6, 1)          # a b o_del e_del o_ins e_ins
GAPS = (1, 4, 5, 2, 4, 1)             # -O5,4 -E2,1
B2 = (1, 2, 6, 1, 6, 1)               # -B2
A120 = (120, 4, 6, 1, 6, 1)           # -A120: i16 scores pass 32767
MIN_SEED_LEN = 19


def cli_scoring(a: int) -> tuple:
    """The rescue scoring of `mem -A a` as DeviceKswv gives it to the
    kernel: update_a scales the other scores by a (-B to 4a), and a and b
    are read from the int8 score matrix, as the native ksw_align scores
    (at -A52: b = 208 raw, a + max(b, 1) = 260, a mismatch of +48 in the
    matrix)."""
    opt = MemOptions()
    opt.set("a", a)
    opt.finalize()
    return (opt.mat[0], -opt.mat[1], opt.o_del, opt.e_del, opt.o_ins,
            opt.e_ins)


A52 = cli_scoring(52)


@functools.lru_cache(maxsize=None)
def genome() -> np.ndarray:
    return FMIndex.load(PREFIX).ref_string


# (windows, Qmax, Tmax): the JAX tests' u8 and i16 sets at their ladder rungs
WINDOWS = {
    "u8": (dict(seed=23, n=80, L=128, qr=(20, 102), tr=(30, 600), nmut=3,
                n_every=7, plant=5), 128, 608),
    "i16": (dict(seed=31, n=40, L=512, qr=(250, 513), tr=(300, 2049),
                 nmut=12, n_every=5, plant=11), 512, 2048),
    # the kernel's other stripe buckets: the main path's 2x150 rescues
    # (u8, slen <= 10), u8 queries to 256 columns, i16 ones to 128, and
    # short queries (slen 1-3) whose F must cross many stripe boundaries
    "main": (dict(seed=51, n=24, L=160, qr=(100, 161), tr=(150, 700),
                  nmut=3, n_every=5, plant=7), 160, 700),
    "long": (dict(seed=53, n=24, L=256, qr=(193, 257), tr=(200, 600),
                  nmut=4, n_every=5, plant=7), 256, 600),
    "short": (dict(seed=57, n=48, L=128, qr=(40, 129), tr=(60, 400),
                   nmut=2, n_every=5, plant=5), 128, 400),
    "tiny": (dict(seed=59, n=48, L=48, qr=(6, 48), tr=(20, 200), nmut=1,
                  n_every=7, plant=3), 48, 200),
    "ties": (None, 64, 160),        # tie_windows()
    # i16 queries of 280-400 bases: at -A120 the planted ones saturate
    "wide": (dict(seed=37, n=24, L=400, qr=(280, 401), tr=(300, 800),
                  nmut=3, n_every=5, plant=11), 400, 800),
}
CASES = {   # name: (windows, u8 class, scoring)
    "u8_default": ("u8", True, DEFAULT),
    "u8_O5_4_E2_1": ("u8", True, GAPS),
    "u8_B2": ("u8", True, B2),
    "i16_default": ("i16", False, DEFAULT),
    "i16_O5_4_E2_1": ("i16", False, GAPS),
    "i16_B2": ("i16", False, B2),
    "u8_saturating": ("i16", True, DEFAULT),
    "u8_main": ("main", True, DEFAULT),
    "u8_long": ("long", True, B2),
    "i16_short": ("short", False, GAPS),
    "u8_short_gaps": ("tiny", True, GAPS),
    "u8_ties": ("ties", True, DEFAULT),
    "i16_ties": ("ties", False, DEFAULT),
    "i16_wide": ("wide", False, A120),
    "i16_A52": ("i16", False, A52),
    "i16_A52_short": ("short", False, A52),
    "u8_A52": ("u8", True, A52),
}
# JAX's kswv_two_phase emulates the i16 class in int32 without saturating,
# so it is the reference only where no score reaches 32767
JAX_CASES = [c for c in CASES if c != "i16_wide"]


@functools.lru_cache(maxsize=None)
def windows(name):
    """The windows of tests/test_device_kernels.py (same numpy draws), or
    tie_windows()."""
    if name == "ties":
        return tie_windows()
    return rescue_windows(genome(), **WINDOWS[name][0])


def tie_windows(n: int = 24, L: int = 64):
    """Queries whose best row reaches its maximum at several columns, so
    the qe tie rule (least column) decides qe: homopolymers (20-63 bases)
    against windows around the genome's longest single-base runs (ties in
    neighbouring columns, within one lane's), and a genome slice X of
    20-31 bases doubled, X+X, against a window holding X (ties a slice
    apart, in two lanes; these score over minsc, so phase 1 runs).  Every
    other problem is reverse-complemented."""
    g = genome()[:len(genome()) // 2]
    starts = np.r_[0, np.flatnonzero(np.diff(g) != 0) + 1]
    lens = np.diff(np.r_[starts, len(g)]) * (g[starts] < 4)
    top = np.argsort(-lens, kind="stable")[:8]
    rng = np.random.default_rng(71)
    enc = np.full((n, L), 4, np.int8)
    qoff, qdir, qlen, tlen = (np.zeros(n, np.int32) for _ in range(4))
    qcomp = np.zeros(n, bool)
    toff = np.zeros(n, np.int64)
    for i in range(n):
        if i % 4 < 2:
            r = top[i // 4 % len(top)]
            q = np.full(int(rng.integers(20, L)), g[starts[r]], np.int8)
            t0, tl = starts[r] - int(rng.integers(0, 40)), int(lens[r])
        else:
            x = int(rng.integers(20, L // 2))
            t0 = int(rng.integers(1000, len(g) - 1000))
            q = np.tile(g[t0:t0 + x].astype(np.int8), 2)
            tl = x
            t0 -= int(rng.integers(0, 40))
        rev = i % 2 == 1
        enc[i, :len(q)] = (3 - q)[::-1] if rev else q
        qoff[i] = i * L + (len(q) - 1 if rev else 0)
        qdir[i] = -1 if rev else 1
        qcomp[i] = rev
        qlen[i] = len(q)
        toff[i] = t0
        tlen[i] = min(tl + 40 + int(rng.integers(10, 60)), 160)
    return enc, qoff, qdir, qcomp, qlen, toff, tlen


@functools.lru_cache(maxsize=None)
def plain(case, packed=False):
    """kswv_two_phase_ref on a case, as numpy (r0, r1)."""
    win, u8, sc = CASES[case]
    _, Qmax, Tmax = WINDOWS[win]
    ref = torch.from_numpy(genome())
    if packed:
        ref = torch.from_numpy(packed_genome())
    t = [torch.from_numpy(x) for x in windows(win)]
    r0, r1 = kswv_two_phase_ref(ref, *t, Qmax, Tmax, MIN_SEED_LEN * sc[0],
                                *sc, packed, u8)
    return r0.numpy(), r1.numpy()


def packed_genome() -> np.ndarray:
    old = DeviceFMIndex.REF_PACK_MIN
    DeviceFMIndex.REF_PACK_MIN = 16
    try:
        dfm = DeviceFMIndex.from_genome(genome(), "cpu")
    finally:
        DeviceFMIndex.REF_PACK_MIN = old
    assert dfm.ref_packed
    return dfm.ref.numpy()


@pytest.mark.parametrize("case", JAX_CASES)
def test_ref_matches_jax_two_phase(case):
    win, u8, sc = CASES[case]
    _, Qmax, Tmax = WINDOWS[win]
    w = windows(win)
    j = [jnp.asarray(x) for x in w]
    want = kswv_two_phase(jnp.asarray(genome()), *j,
                          jnp.ones(len(w[1]), bool), Qmax, Tmax,
                          MIN_SEED_LEN * sc[0], *sc, False, u8)
    got = plain(case)
    for g, x in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(x))
    if case == "u8_saturating":
        assert got[0][:, 5].sum() > 0          # some lanes saturated
        assert (got[1][got[0][:, 5] > 0, 0] == 0).all()   # no phase 1


def test_device_kswv_matches_native():
    """One align_batch on the CPU over u8 windows, i16 windows and longer
    problems (qlen > 512 in the i16 class, tlen > 2048 in the u8 class: the
    JAX package sends these to the host, the port to the kernel) equals
    the native ksw_align per problem."""
    enc, desc = rescue_batch(genome(), [
        dict(WINDOWS["u8"][0], u8=True), dict(WINDOWS["i16"][0], u8=False),
        dict(seed=41, n=4, qr=(513, 600), tr=(300, 1000), nmut=20,
             n_every=2, plant=7, u8=False),
        dict(seed=43, n=2, qr=(60, 100), tr=(2049, 2400), nmut=3, n_every=2,
             plant=5, u8=True)])
    assert int(((desc["qlen"] > 512) | (desc["tlen"] > 2048)).sum()) == 6
    opt = MemOptions().finalize()
    dfm = DeviceFMIndex.from_genome(genome(), "cpu")
    n0 = kswv_cuda.kswv.plain_calls
    got = DeviceKswv(dfm, opt).align_batch(torch.from_numpy(enc), desc)
    assert kswv_cuda.kswv.plain_calls == n0 + 2       # one per class
    np.testing.assert_array_equal(got, ksw_align_desc(enc, genome(), desc,
                                                      opt))


def test_i16_beyond_16_bits_takes_native_kernel():
    """A 528-base perfect match at a = 64 (the other scores at their
    defaults): round_up(qlen, 16) * a > 32767, so the native ksw_align
    saturates its i16 score at 32767 where an int32 emulation would give
    33,792.  TorchBackend(device="cpu").rescue_batch runs it, and a
    300-base i16 problem beside it, in one call of the kernel's plain
    version, which saturates as the native kernel does (counted as
    rescue.i16_wide), and equals the native ksw_align and the JAX
    package's rescue (which sends every qlen > 512 to the native
    kernel)."""
    from bwamem2_tpu_torch.ops.backend import TorchBackend
    from bwamem2_tpu_torch.utils.profiling import PROF
    g = genome()
    opt = MemOptions()
    opt.a = 64
    opt.finalize()
    L = 528
    enc = np.full((2, L), 4, np.int8)
    enc[0] = g[5007:5007 + L]
    enc[1, :300] = g[20011:20311]
    desc = dict(qoff=np.array([0, L], np.int32),
                qdir=np.array([1, 1], np.int32),
                qcomp=np.zeros(2, bool), qlen=np.array([L, 300], np.int32),
                toff=np.array([5000, 20000], np.int64),
                tlen=np.array([700, 400], np.int32), u8=np.zeros(2, bool))
    want = ksw_align_desc(enc, g, desc, opt)
    assert want[0, 0] == 32767 and want[1, 0] == 300 * 64
    be = TorchBackend(FMIndex.load(PREFIX), opt, device="cpu")
    be._bsw.encj = torch.from_numpy(enc)
    PROF.c.pop("rescue.i16_wide", None)
    n0 = kswv_cuda.kswv.plain_calls
    got = be.rescue_batch(desc)
    assert PROF.c["rescue.i16_wide"] == 1
    assert kswv_cuda.kswv.plain_calls == n0 + 1
    np.testing.assert_array_equal(got, want)
    jdfm = SimpleNamespace(ref=jnp.asarray(g), ref_packed=False)
    jdesc = dict(desc, enc_host=lambda i, ql: enc[i, :ql].astype(np.uint8),
                 ref_host=lambda i, tl: g[desc["toff"][i]:
                                          desc["toff"][i] + tl])
    np.testing.assert_array_equal(
        got, JaxDeviceKswv(jdfm, opt).align_batch(jnp.asarray(enc), jdesc))


def test_i16_saturation_matches_native():
    """At -A120 the i16 windows of 280-400 bases saturate (scores up to
    48,000 in int32): DeviceKswv.align_batch on the CPU equals the native
    ksw_align per problem.  JAX's kswv_two_phase, which keeps these
    problems (qlen <= 512) in its int32 emulation, does not saturate and
    differs from both (a caveat on the reference side)."""
    enc, *w = windows("wide")
    desc = dict(zip(("qoff", "qdir", "qcomp", "qlen", "toff", "tlen"), w),
                u8=np.zeros(len(w[0]), bool))
    opt = MemOptions()
    opt.a = 120
    opt.finalize()
    dk = DeviceKswv(DeviceFMIndex.from_genome(genome(), "cpu"), opt)
    assert int(dk.wide(desc).sum()) == len(w[0])
    got = dk.align_batch(torch.from_numpy(enc), desc)
    want = ksw_align_desc(enc, genome(), desc, opt)
    assert (want[:, 0] == 32767).sum() >= 4
    np.testing.assert_array_equal(got, want)
    _, Qmax, Tmax = WINDOWS["wide"]
    jax0 = kswv_two_phase(jnp.asarray(genome()),
                          *[jnp.asarray(x) for x in windows("wide")],
                          jnp.ones(len(w[0]), bool), Qmax, Tmax,
                          MIN_SEED_LEN * 120, *A120, False, False)[0]
    assert int(np.asarray(jax0)[:, 0].max()) > 32767


def test_device_kswv_launch_order_keeps_output():
    """align_batch launches each class longest first, by descending (tlen,
    qlen); its output equals the plain version run on each class in
    descriptor order, and the native ksw_align."""
    enc, desc = rescue_batch(genome(), [
        dict(seed=61, n=24, qr=(60, 152), tr=(100, 700), nmut=3, n_every=5,
             plant=7, u8=True),
        dict(seed=67, n=8, qr=(250, 300), tr=(300, 600), nmut=8, n_every=3,
             plant=7, u8=False)])
    opt = MemOptions().finalize()
    dk = DeviceKswv(DeviceFMIndex.from_genome(genome(), "cpu"), opt)
    encj = torch.from_numpy(enc)
    order = dk.launch_order(desc)
    assert [u8 for u8, _ in order] == [True, False]
    for u8, idx in order:
        assert (desc["u8"][idx] == u8).all()
        assert sorted(idx) == list(np.nonzero(desc["u8"] == u8)[0])
        key = list(zip(desc["tlen"][idx], desc["qlen"][idx]))
        assert key == sorted(key, reverse=True)
        assert (np.diff(idx) < 0).any()         # really reordered
    got = dk.align_batch(encj, desc)
    want = np.zeros_like(got)
    for u8 in (True, False):
        idx = np.nonzero(desc["u8"] == u8)[0]
        r0, r1 = kswv_two_phase_ref(*dk.kswv_args(encj, desc, idx, u8))
        want[idx] = dk._finish(r0.numpy(), r1.numpy())
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, ksw_align_desc(enc, genome(), desc,
                                                      opt))


@pytest.fixture(scope="module")
def host_dp(tmp_path_factory):
    """csrc/kswv_group.cuh built as host C++: its lane groups are int[NL]
    lane vectors stepped in lockstep, and a per-problem loop stands in for
    the CUDA launch.  kswv_host picks the stripes as the launch does
    (kswv_bucket: registers or pointer stripes), or pointer stripes when
    force_ptr is set, and reports the bucket and the most lazy-F sweeps any
    row ran."""
    d = tmp_path_factory.mktemp("kswv_group")
    shim = d / "shim.cpp"
    shim.write_text(r'''
#include <vector>
#define BSW_HD static inline
static int kswv_sweeps_max;
#define KSWV_SWEEP_HOOK(k) \
  (kswv_sweeps_max = (k) > kswv_sweeps_max ? (k) : kswv_sweeps_max)
#include "kswv_group.cuh"
template <bool U8, int SMAX, int S = 1>
static void run_all(const KswvBatch &b) {
  std::vector<int16_t> stripes(kswv_group_bytes(b.Qmax) / 2);
  const KswvGroup<U8 ? 16 : 8, S> g;
  for (int p = 0; p < b.P; ++p) kswv_run<U8, SMAX>(g, b, p, stripes.data());
}
extern "C" void kswv_host(const int8_t *enc, int64_t n_enc, const uint8_t *ref,
    int64_t n_ref, int packed, const int *qoff, const int *qdir,
    const uint8_t *qcomp, const int *qlen, const int64_t *toff,
    const int *tlen, int P, int Qmax, int Tmax, int Tpad, int u8, int minsc,
    const int *sc, int force_ptr, int split, int16_t *rowmax, int *out,
    int *info) {
  const KswvBatch b{enc, n_enc, ref, n_ref, packed, qoff, qdir, qcomp, qlen,
                    toff, tlen, P, Qmax, Tmax, Tpad, minsc,
                    {sc[0], sc[1], sc[2], sc[3], sc[4], sc[5]}, rowmax, out};
  // the split form: S sub-threads a lane, 8 register segments a
  // sub-thread, as kswv.cu:kswv_plan gives them
  const int smax = split > 1 ? 8 : force_ptr ? 0 : kswv_bucket(u8, Qmax);
  kswv_sweeps_max = 0;
#define KSWV_HOST_CASE(U, S) \
  if (split <= 1 && !!u8 == U && smax == S) run_all<U, S>(b);
  KSWV_BUCKETS(KSWV_HOST_CASE)
#define KSWV_SPLIT_CASE(U, S, N) \
  if (split == N && !!u8 == U && smax == S) run_all<U, S, N>(b);
  KSWV_SPLIT_CASE(true, 8, 2) KSWV_SPLIT_CASE(true, 8, 4)
  KSWV_SPLIT_CASE(true, 8, 8) KSWV_SPLIT_CASE(false, 8, 2)
  KSWV_SPLIT_CASE(false, 8, 4) KSWV_SPLIT_CASE(false, 8, 8)
  info[0] = smax;
  info[1] = kswv_sweeps_max;
}
''')
    so = d / "kswv_group.so"
    subprocess.run(["g++", "-O2", "-std=c++17", "-shared", "-fPIC",
                    "-I", CSRC, str(shim), "-o", str(so)],
                   check=True, capture_output=True)
    return ctypes.CDLL(str(so))


def run_host_dp(lib, case, packed=False, force_ptr=False, split=1):
    """(out int32[2, P, 6], stripe bucket, most lazy-F sweeps in a row);
    split > 1 runs the split form at S = split."""
    win, u8, sc = CASES[case]
    _, Qmax, Tmax = WINDOWS[win]
    enc, qoff, qdir, qcomp, qlen, toff, tlen = windows(win)
    ref = packed_genome() if packed else genome()
    P = len(qoff)
    keep = [np.ascontiguousarray(x) for x in (
        enc, ref, qoff, qdir, qcomp.astype(np.uint8), qlen, toff, tlen,
        np.array(sc, np.int32))]
    Tpad = -(-Tmax // 8) * 8
    rowmax = np.zeros(Tpad * P, np.int16)
    out = np.zeros((2, P, 6), np.int32)
    info = np.zeros(2, np.int32)
    ptr = lambda x: ctypes.c_void_p(x.ctypes.data)  # noqa: E731
    e, r, *rest, scv = keep
    lib.kswv_host(ptr(e), ctypes.c_int64(e.size), ptr(r),
                  ctypes.c_int64(r.size), ctypes.c_int(int(packed)),
                  *[ptr(x) for x in rest], ctypes.c_int(P),
                  ctypes.c_int(Qmax), ctypes.c_int(Tmax), ctypes.c_int(Tpad),
                  ctypes.c_int(u8), ctypes.c_int(MIN_SEED_LEN * sc[0]),
                  ptr(scv), ctypes.c_int(int(force_ptr)),
                  ctypes.c_int(split), ptr(rowmax), ptr(out), ptr(info))
    return out, int(info[0]), int(info[1])


# (case, packed genome, force pointer stripes, expected stripe bucket[,
# S: the split form])
HOST_DP = {
    "u8": ("u8_default", False, False, 8),
    "i16": ("i16_default", False, False, 0),
    "u8_saturating": ("u8_saturating", False, False, 0),
    "u8_packed_ref": ("u8_default", True, False, 8),
    "u8_main_shape": ("u8_main", False, False, 12),
    "u8_bucket16": ("u8_long", False, False, 16),
    "u8_shared": ("u8_long", False, True, 0),
    "i16_registers": ("i16_short", False, False, 16),
    "i16_shared": ("i16_short", False, True, 0),
    "u8_lazy_f_sweeps": ("u8_short_gaps", False, False, 8),
    "u8_lazy_f_sweeps_shared": ("u8_short_gaps", False, True, 0),
    "u8_qe_ties": ("u8_ties", False, False, 8),
    "i16_qe_ties": ("i16_ties", False, False, 16),
    "i16_qe_ties_shared": ("i16_ties", False, True, 0),
    "i16_saturating": ("i16_wide", False, False, 0),
    "i16_A52": ("i16_A52", False, False, 0),
    "i16_A52_registers": ("i16_A52_short", False, False, 16),
    "u8_A52": ("u8_A52", False, False, 8),
    # the split form (kswv_phase_split), S sub-threads a lane: ragged runs
    # (slen not a multiple of S), runs that hold no segment, 8 register
    # segments a sub-thread
    "u8_split2": ("u8_default", False, False, 8, 2),
    "u8_split4_main_shape": ("u8_main", False, False, 8, 4),
    "u8_split8_saturating": ("u8_saturating", False, False, 8, 8),
    "u8_split2_long": ("u8_long", False, False, 8, 2),
    "u8_split4_saturating": ("u8_saturating", False, False, 8, 4),
    "u8_split2_lazy_f_sweeps": ("u8_short_gaps", False, False, 8, 2),
    "u8_split8_lazy_f_sweeps": ("u8_short_gaps", False, False, 8, 8),
    "u8_split4_qe_ties": ("u8_ties", False, False, 8, 4),
    "u8_split8_A52": ("u8_A52", False, False, 8, 8),
    "i16_split2": ("i16_short", False, False, 8, 2),
    "i16_split4_qe_ties": ("i16_ties", False, False, 8, 4),
    "i16_split8_ties_packed": ("i16_ties", True, False, 8, 8),
    "i16_split8_saturating": ("i16_wide", False, False, 8, 8),
    "i16_split8_A52": ("i16_A52", False, False, 8, 8),
    "i16_split4_A52_short": ("i16_A52_short", False, False, 8, 4),
}


@pytest.mark.parametrize("name", list(HOST_DP))
def test_cuda_dp_source_matches_ref(host_dp, name):
    """The kernel's group source, built with g++, equals the plain version
    array for array: u8 and i16, registers and pointer stripes (the
    launch's own choice, and pointer stripes forced), saturating u8 and
    i16 lanes, the packed genome, rows that need several lazy-F sweeps and qe decided
    by the tie rule; and the split form at S = 2, 4 and 8 on the same
    cases, whose lazy-F sweeps must also number as many as the one-thread
    lanes' (the hook's count)."""
    case, packed, force_ptr, bucket, *split = HOST_DP[name]
    got, smax, sweeps = run_host_dp(host_dp, case, packed, force_ptr,
                                    *split)
    assert smax == bucket
    want = plain(case, packed)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    if packed:      # the packed genome changes nothing
        np.testing.assert_array_equal(got[0], plain(case)[0])
    if case == "u8_short_gaps":     # F crossed several stripe boundaries
        assert sweeps >= 3
    if split:   # the split form stops its lazy-F where the lanes do
        assert sweeps == run_host_dp(host_dp, case, packed, force_ptr)[2]
    if case == "i16_wide":
        assert (want[0][:, 0] == 32767).any()
    if CASES[case][2] == A52:
        # -A52 as the CLI sets it: also the native ksw_align, per problem
        win, u8, _ = CASES[case]
        enc, *w = windows(win)
        desc = dict(zip(("qoff", "qdir", "qcomp", "qlen", "toff", "tlen"),
                        w), u8=np.full(len(w[0]), u8))
        opt = MemOptions()
        opt.set("a", 52)
        opt.finalize()
        dk = DeviceKswv(None, opt)
        np.testing.assert_array_equal(
            dk._finish(got[0], got[1]),
            ksw_align_desc(enc, genome(), desc, opt))
    assert 1 <= sweeps <= 16


def test_wrapper_dispatch():
    """CPU tensors run the plain version (counted as plain calls, never as
    launches); a tensor on any other device goes to the kernel path, which
    refuses anything but CUDA and never reaches the plain version."""
    w = windows("u8")
    t = [torch.from_numpy(x[:8].copy() if i else x) for i, x in
         enumerate(w)]
    ref = torch.from_numpy(genome())
    k = kswv_cuda.Kswv()
    args = (128, 608, MIN_SEED_LEN, *DEFAULT, False, True)
    r0, r1 = k(ref, *t, *args)
    assert (k.plain_calls, k.launches) == (1, 0)
    np.testing.assert_array_equal(r0.numpy(), plain("u8_default")[0][:8])
    with pytest.raises(ValueError, match="CUDA"):
        k(ref.to("meta"), *[x.to("meta") for x in t], *args)
    assert (k.plain_calls, k.launches) == (1, 0)


@pytest.fixture(scope="module")
def chunk_rescue():
    """The reads_r1/r2.fq chunk's rescue descriptors as the pipeline makes
    them: the port's host-native run, with hostrt.rescue_pre_batch called on
    the chunk's flat regions and pestat exactly where the device pipeline
    calls it, against the chunk's padded read grid."""
    fm = FMIndex.load(PREFIX)
    opt = MemOptions().finalize()
    opt.flag |= MEM_F_PE
    reads = read_chunk(FastxReader(os.path.join(DATA, "reads_r1.fq")),
                       FastxReader(os.path.join(DATA, "reads_r2.fq")), 10**9)
    enc, _ = _pad_reads(encode_reads([r.seq for r in reads]))
    seen = []
    orig = hostrt.sam_pe_batch

    def spy(fm_, opt_, reads_, fr, pes6, *a, **k):
        seen.append(hostrt.rescue_pre_batch(fm_, opt_, reads_, fr, pes6,
                                            enc.shape[1]))
        return orig(fm_, opt_, reads_, fr, pes6, *a, **k)

    hostrt.sam_pe_batch = spy
    try:
        Aligner(fm, opt, backend=None, verbose=0).process(reads, 0)
    finally:
        hostrt.sam_pe_batch = orig
    (desc, keys), = seen
    return fm, opt, enc, desc


def test_real_descriptors_port_equals_jax(chunk_rescue):
    fm, opt, enc, desc = chunk_rescue
    assert desc is not None and len(desc["qoff"]) > 0
    got = DeviceKswv(DeviceFMIndex.from_genome(fm.ref_string, "cpu"),
                     opt).align_batch(torch.from_numpy(enc), desc)
    jdfm = SimpleNamespace(ref=jnp.asarray(fm.ref_string), ref_packed=False)
    want = JaxDeviceKswv(jdfm, opt).align_batch(jnp.asarray(enc), desc)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, ksw_align_desc(enc, fm.ref_string,
                                                      desc, opt))

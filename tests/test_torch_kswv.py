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
  * the CUDA kernel's own per-problem body (csrc/kswv_dp.cuh) compiled as
    host C++ — the exact code the card runs, minus the launch — vs the
    plain version, both classes and the 2-bit packed genome;
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
MIN_SEED_LEN = 19


@functools.lru_cache(maxsize=None)
def genome() -> np.ndarray:
    return FMIndex.load(PREFIX).ref_string


# (windows, Qmax, Tmax): the JAX tests' u8 and i16 sets at their ladder rungs
WINDOWS = {
    "u8": (dict(seed=23, n=80, L=128, qr=(20, 102), tr=(30, 600), nmut=3,
                n_every=7, plant=5), 128, 608),
    "i16": (dict(seed=31, n=40, L=512, qr=(250, 513), tr=(300, 2049),
                 nmut=12, n_every=5, plant=11), 512, 2048),
}
CASES = {   # name: (windows, u8 class, scoring)
    "u8_default": ("u8", True, DEFAULT),
    "u8_O5_4_E2_1": ("u8", True, GAPS),
    "u8_B2": ("u8", True, B2),
    "i16_default": ("i16", False, DEFAULT),
    "i16_O5_4_E2_1": ("i16", False, GAPS),
    "i16_B2": ("i16", False, B2),
    "u8_saturating": ("i16", True, DEFAULT),
}


@functools.lru_cache(maxsize=None)
def windows(name):
    """The windows of tests/test_device_kernels.py (same numpy draws)."""
    return rescue_windows(genome(), **WINDOWS[name][0])


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


@pytest.mark.parametrize("case", list(CASES))
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


@pytest.fixture(scope="module")
def host_dp(tmp_path_factory):
    """csrc/kswv_dp.cuh built as host C++ with a per-problem loop in place
    of the CUDA launch (same scratch layout and strides)."""
    d = tmp_path_factory.mktemp("kswv_dp")
    shim = d / "shim.cpp"
    shim.write_text(r'''
#define BSW_HD static inline
#include "kswv_dp.cuh"
extern "C" void kswv_host(const int8_t *enc, int64_t n_enc, const uint8_t *ref,
    int64_t n_ref, int packed, const int *qoff, const int *qdir,
    const uint8_t *qcomp, const int *qlen, const int64_t *toff,
    const int *tlen, int P, int Qmax, int Tmax, int u8, int minsc,
    const int *sc, int *scratch, int16_t *rowmax, int *out) {
  const KswvParams sp{sc[0], sc[1], sc[2], sc[3], sc[4], sc[5]};
  const int64_t plane = (int64_t)Qmax * P;
  for (int p = 0; p < P; ++p) {
    KswvScratch s{scratch + p, scratch + plane + p, scratch + 2 * plane + p,
                  scratch + 3 * plane + p, rowmax + p, P};
    int *o0 = out + 6 * p, *o1 = out + 6 * ((int64_t)P + p);
    if (u8)
      kswv_problem<16, true>(enc, n_enc, ref, n_ref, packed, qoff[p],
          qdir[p], qcomp[p], qlen[p], toff[p], tlen[p], minsc, sp, Qmax,
          Tmax, s, o0, o1);
    else
      kswv_problem<8, false>(enc, n_enc, ref, n_ref, packed, qoff[p],
          qdir[p], qcomp[p], qlen[p], toff[p], tlen[p], minsc, sp, Qmax,
          Tmax, s, o0, o1);
  }
}
''')
    so = d / "kswv_dp.so"
    subprocess.run(["g++", "-O2", "-std=c++17", "-shared", "-fPIC",
                    "-I", CSRC, str(shim), "-o", str(so)],
                   check=True, capture_output=True)
    return ctypes.CDLL(str(so))


def run_host_dp(lib, case, packed=False):
    win, u8, sc = CASES[case]
    _, Qmax, Tmax = WINDOWS[win]
    enc, qoff, qdir, qcomp, qlen, toff, tlen = windows(win)
    ref = packed_genome() if packed else genome()
    P = len(qoff)
    keep = [np.ascontiguousarray(x) for x in (
        enc, ref, qoff, qdir, qcomp.astype(np.uint8), qlen, toff, tlen,
        np.array(sc, np.int32))]
    scratch = np.zeros(4 * Qmax * P, np.int32)
    rowmax = np.zeros(Tmax * P, np.int16)
    out = np.zeros((2, P, 6), np.int32)
    ptr = lambda x: ctypes.c_void_p(x.ctypes.data)  # noqa: E731
    e, r, *rest, scv = keep
    lib.kswv_host(ptr(e), ctypes.c_int64(e.size), ptr(r),
                  ctypes.c_int64(r.size), ctypes.c_int(int(packed)),
                  *[ptr(x) for x in rest], ctypes.c_int(P),
                  ctypes.c_int(Qmax), ctypes.c_int(Tmax), ctypes.c_int(u8),
                  ctypes.c_int(MIN_SEED_LEN * sc[0]), ptr(scv),
                  ptr(scratch), ptr(rowmax), ptr(out))
    return out


@pytest.mark.parametrize("case,packed", [
    ("u8_default", False), ("i16_default", False), ("u8_saturating", False),
    ("u8_default", True),
], ids=["u8", "i16", "u8_saturating", "u8_packed_ref"])
def test_cuda_dp_source_matches_ref(host_dp, case, packed):
    got = run_host_dp(host_dp, case, packed)
    want = plain(case, packed)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    if packed:      # the packed genome changes nothing
        np.testing.assert_array_equal(got[0], plain(case)[0])


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

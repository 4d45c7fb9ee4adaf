"""Port fused seeding (ops/seed.py) vs the JAX package's, exact.

* TorchBackend(device="cpu").collect_chunk — smem_collect_ref, compaction,
  max_occ position sampling and sa_resolve_ref — returns the same six
  arrays (smem_off, m, n, s, occ_off, coords) as the JAX
  DeviceBackend.collect_chunk, on the inputs of tests/test_seedall.py
  (80 reads of reads_se.fq, plus mutated genome slices with N bases,
  short reads, an all-N read and a read below min_seed_len) in one chunk.
  The JAX side runs once per module.
* A forced small slot cap sends reads through _patch_chunk (the exact host
  oracle) and still gives identical arrays.
* Every chunk takes the device route: reads of 600 and 1,000 bp equal the
  host oracle's arrays, and chunks without bases give empty arrays.
* csrc/smem_collect_dp.cuh compiled as host C++ equals smem_collect_ref,
  slots, counts, overflow flags and backward_ext counts.
* sa_resolve_ref equals JAX sa_lookup_kernel (and the host-built
  fm_sa_entry, and the native rt_sa_entries) on every BWT position.
Tolerance 0 throughout: everything is integer.
"""

import os

import numpy as np
import pytest
import torch

from bwamem2_tpu.align.seeding import encode_reads
from bwamem2_tpu.index.fmindex import FMIndex as JaxFMIndex
from bwamem2_tpu.io.fastq import FastxReader, read_chunk
from bwamem2_tpu.options import MemOptions as JaxMemOptions
from bwamem2_tpu.ops.backend import DeviceBackend
from bwamem2_tpu.ops.salookup import sa_lookup_kernel
from bwamem2_tpu_torch.align.chain import sa_positions_batch
from bwamem2_tpu_torch.index.fmindex import FMIndex
from bwamem2_tpu_torch.native import hostrt
from bwamem2_tpu_torch.ops import seed as tseed
from bwamem2_tpu_torch.ops.backend import TorchBackend, _pad_reads
from bwamem2_tpu_torch.ops.device_index import DeviceFMIndex
from bwamem2_tpu_torch.options import MemOptions
from bwamem2_tpu_torch.utils.profiling import PROF

from conftest import DATA, FIXTURES
from test_torch_device_index import HostFm, build_host_shim

torch.set_num_threads(1)

PREFIX = os.path.join(FIXTURES, "ref_small.fa")
NAMES = ("smem_off", "m", "n", "s", "occ_off", "coords")


def seedall_inputs():
    """tests/test_seedall.py's two read sets, as one list of sequences."""
    reads = read_chunk(FastxReader(os.path.join(DATA, "reads_se.fq")),
                       None, 10**9)[:80]
    seqs = [r.seq for r in reads]
    rng = np.random.default_rng(11)
    ref = open(os.path.join(DATA, "ref_small.fa")).read().splitlines()
    genome = "".join(ln for ln in ref if not ln.startswith(">"))
    for _ in range(40):
        p = int(rng.integers(0, len(genome) - 130))
        s = list(genome[p:p + int(rng.integers(24, 130))])
        for _ in range(int(rng.integers(0, 5))):
            s[int(rng.integers(0, len(s)))] = "ACGTN"[int(
                rng.integers(0, 5))]
        seqs.append("".join(s))
    seqs.append("N" * 40)          # all-N read
    seqs.append("ACGT" * 5)        # below min_seed_len
    return seqs


@pytest.fixture(scope="module")
def encs():
    return encode_reads(seedall_inputs())


@pytest.fixture(scope="module")
def fm():
    return FMIndex.load(PREFIX)


@pytest.fixture(scope="module")
def jax_arrays(encs):
    """The JAX fused seeding's six arrays (computed once: one XLA
    compile)."""
    opt = JaxMemOptions().finalize()
    out = DeviceBackend(JaxFMIndex.load(PREFIX), opt).collect_chunk(encs,
                                                                     opt)
    assert out is not None
    return [np.asarray(a) for a in out]


def check_equal(got, want):
    for nm, x, y in zip(NAMES, got, want):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype, (nm, x.dtype, y.dtype)
        np.testing.assert_array_equal(x, y, err_msg=nm)


def test_collect_chunk_matches_jax(fm, encs, jax_arrays):
    opt = MemOptions().finalize()
    be = TorchBackend(fm, opt, device="cpu")
    n0 = (tseed.smem_collect.plain_calls, tseed.sa_resolve.plain_calls)
    PROF.c.pop("overflow.fused_read", None)
    got = be.collect_chunk(encs, opt)
    assert (tseed.smem_collect.plain_calls, tseed.sa_resolve.plain_calls) \
        == (n0[0] + 1, n0[1] + 1)
    assert PROF.c["overflow.fused_read"] == 0
    assert be.read_grid_width() > 0
    check_equal(got, jax_arrays)


def test_small_cap_patch_path_matches_jax(fm, encs, jax_arrays,
                                         monkeypatch):
    """cap 4: most reads outrun their slots and are re-seeded by the host
    oracle in _patch_chunk; the arrays do not change."""
    opt = MemOptions().finalize()
    be = TorchBackend(fm, opt, device="cpu")
    monkeypatch.setattr(tseed, "smem_cap", lambda L: 4)
    PROF.c.pop("overflow.fused_read", None)
    got = be.collect_chunk(encs, opt)
    n_bad = PROF.c["overflow.fused_read"]
    assert 0 < n_bad < len(encs)
    check_equal(got, jax_arrays)


def host_route(fm, encs, opt):
    """The host oracle's six arrays: rt_collect_smems_reads, the max_occ
    sampling of sa_positions_batch, rt_sa_entries."""
    sub = hostrt.collect_smems_reads(fm, encs, opt)
    pos, smem_off, m, n, s, occ_off = sa_positions_batch(opt, sub)
    return smem_off, m, n, s, occ_off, hostrt.sa_entries_host(fm, pos)


def long_reads():
    """Mutated genome slices of 600 and 1,000 bp (an N base in one) beside
    two 150 bp reads: a grid wider than any TPU limit."""
    rng = np.random.default_rng(5)
    ref = open(os.path.join(DATA, "ref_small.fa")).read().splitlines()
    genome = "".join(ln for ln in ref if not ln.startswith(">"))
    seqs = []
    for ln in (600, 1000, 150, 150):
        p = int(rng.integers(0, len(genome) - ln))
        s = list(genome[p:p + ln])
        for _ in range(ln // 100):
            s[int(rng.integers(0, ln))] = "ACGT"[int(rng.integers(0, 4))]
        seqs.append("".join(s))
    seqs[1] = seqs[1][:500] + "N" + seqs[1][501:]
    return encode_reads(seqs)


@pytest.mark.parametrize("case", ["long_reads", "no_reads", "no_bases"])
def test_collect_chunk_takes_every_chunk(fm, case):
    """No chunk is refused: long reads seed on the device route and equal
    the host oracle; chunks without bases give empty arrays."""
    opt = MemOptions().finalize()
    be = TorchBackend(fm, opt, device="cpu")
    encs = {"long_reads": long_reads, "no_reads": list,
            "no_bases": lambda: [np.zeros(0, np.uint8)] * 3}[case]()
    n0 = tseed.smem_collect.plain_calls
    got = be.collect_chunk(encs, opt)
    want = host_route(fm, encs, opt)
    assert len(got[0]) == len(encs) + 1
    for nm, x, y in zip(NAMES, got, want):
        np.testing.assert_array_equal(x, np.asarray(y), err_msg=nm)
    if case == "long_reads":
        assert be.read_grid_width() == 1000
        assert tseed.smem_collect.plain_calls == n0 + 1
        assert len(got[5]) > 0


@pytest.mark.parametrize("cap", [64, 5], ids=["cap64", "cap5"])
def test_smem_collect_dp_header_matches_ref(tmp_path, fm, encs, cap):
    """csrc/smem_collect_dp.cuh (host build, one loop iteration per read in
    place of one thread per read) == smem_collect_ref, including the
    overflow flags of a small cap."""
    lib = build_host_shim(str(tmp_path))
    dfm = DeviceFMIndex.from_host(fm, "cpu")
    opt = MemOptions().finalize()
    enc, lens = _pad_reads(encs)
    split_len = int(opt.min_seed_len * opt.split_factor + 0.499)
    args = (opt.min_seed_len, split_len, opt.split_width, opt.max_mem_intv,
            cap)
    hm, hn, hk, hs, hcnt, hnb = HostFm(lib, dfm).smem_collect(enc, lens,
                                                              *args)
    rm, rn, rk, rs, rcnt, rnb = (t.numpy() for t in tseed.smem_collect_ref(
        dfm, torch.from_numpy(enc), torch.from_numpy(lens), *args))
    np.testing.assert_array_equal(hcnt, rcnt)
    np.testing.assert_array_equal(hnb, rnb)
    assert (rnb > 0).any() and (cap == 64) == (rcnt >= 0).all()
    slot = np.arange(cap)[None, :] < np.maximum(rcnt, 0)[:, None]
    for h, r in ((hm, rm), (hn, rn), (hk, rk), (hs, rs)):
        np.testing.assert_array_equal(h[slot], r[slot])


def test_sa_resolve_matches_jax(fm):
    """Every BWT position: sa_resolve_ref == JAX sa_lookup_kernel ==
    fm_sa_entry (host build) == rt_sa_entries; the walks that end at the
    sentinel are among them."""
    jfm = JaxFMIndex.load(PREFIX)
    from bwamem2_tpu.ops.device_index import DeviceFMIndex as JaxDFM
    jd = JaxDFM.from_host(jfm)
    dfm = DeviceFMIndex.from_host(fm, "cpu")
    pos = np.arange(fm.ref_seq_len, dtype=np.int64)
    reads = []
    got = tseed.sa_resolve_ref(dfm, torch.from_numpy(pos), reads).numpy()
    np.testing.assert_array_equal(got, np.asarray(sa_lookup_kernel(jd, pos)))
    np.testing.assert_array_equal(got, hostrt.sa_entries_host(fm, pos))
    assert reads[0] > len(pos)
    # the suffix array is a permutation of [0, n)
    assert np.array_equal(np.sort(got), np.arange(len(pos)))


def test_fm_sa_entry_header_matches_ref(tmp_path, fm):
    lib = build_host_shim(str(tmp_path))
    dfm = DeviceFMIndex.from_host(fm, "cpu")
    pos = np.random.default_rng(3).integers(0, fm.ref_seq_len, 5000)
    pos = np.concatenate([pos, [int(fm.sentinel_index)]]).astype(np.int64)
    np.testing.assert_array_equal(
        HostFm(lib, dfm).sa_entry(pos),
        tseed.sa_resolve_ref(dfm, torch.from_numpy(pos)).numpy())


def test_wrapper_dispatch(fm):
    """CPU tensors run the plain versions (counted as plain calls, never
    as launches); tensors on any other device go to the kernel path, which
    refuses anything but CUDA."""
    dfm = DeviceFMIndex.from_host(fm, "cpu")
    enc, lens = _pad_reads(encode_reads(["ACGTACGTACGTACGTACGTACGT"]))
    for k in (tseed.smem_collect, tseed.sa_resolve):
        k.reset()
    out = tseed.smem_collect(dfm, torch.from_numpy(enc),
                             torch.from_numpy(lens), 19, 29, 10, 20, 64)
    assert len(out) == 6
    tseed.sa_resolve(dfm, torch.arange(16))
    for k in (tseed.smem_collect, tseed.sa_resolve):
        assert (k.plain_calls, k.launches) == (1, 0)
    with pytest.raises(ValueError, match="CUDA"):
        tseed.smem_collect(dfm, torch.from_numpy(enc).to("meta"),
                           torch.from_numpy(lens), 19, 29, 10, 20, 64)
    with pytest.raises(ValueError, match="CUDA"):
        tseed.sa_resolve(dfm, torch.arange(16).to("meta"))
    for k in (tseed.smem_collect, tseed.sa_resolve):
        assert (k.plain_calls, k.launches) == (1, 0)

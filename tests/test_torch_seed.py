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
* csrc/smem_group.cuh compiled as host C++ (each lane group stepped in
  lockstep) equals smem_collect_ref, slots, counts, overflow flags and
  backward_ext counts, at every lane width and on both overflow routes
  (slots, candidate list); on a chunk with a 12 kb read it equals the host
  oracle.  The wrapper's buffers are linear in the chunk's bases
  (plan_bytes), and a chunk with a read over 32,000 bp seeds on the host
  oracle, its SAM equal to the host-native run's.
* sa_resolve_ref equals JAX sa_lookup_kernel and the native
  rt_sa_entries on every BWT position, and the SA kernel's walk-and-refill
  loop (csrc/sa_group.cuh, host build) equals sa_resolve_ref there, with
  its tickets in input and in shuffled order and as many row reads.
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
from bwamem2_tpu_torch import benchdata
from bwamem2_tpu_torch.align.chain import sa_positions_batch
from bwamem2_tpu_torch.index.build import build_index
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


def four_slots(lens):
    off = torch.zeros(lens.shape[0] + 1, dtype=torch.int64)
    off[1:] = torch.arange(1, lens.shape[0] + 1) * 4
    return off


def test_small_cap_patch_path_matches_jax(fm, encs, jax_arrays,
                                         monkeypatch):
    """4 slots per read: most reads outrun their slots and are re-seeded by
    the host oracle in _patch_chunk; the arrays do not change."""
    opt = MemOptions().finalize()
    be = TorchBackend(fm, opt, device="cpu")
    monkeypatch.setattr(tseed, "slot_offsets", four_slots)
    PROF.c.pop("overflow.fused_read", None)
    got = be.collect_chunk(encs, opt)
    n_bad = PROF.c["overflow.fused_read"]
    assert 0 < n_bad < len(encs)
    check_equal(got, jax_arrays)


def test_small_list_patch_path_matches_jax(fm, encs, jax_arrays,
                                          monkeypatch):
    """A candidate list of 10 entries: reads whose forward walks push more
    are re-seeded by the host oracle; the arrays do not change."""
    opt = MemOptions().finalize()
    be = TorchBackend(fm, opt, device="cpu")
    monkeypatch.setattr(tseed, "list_cap", lambda L: 10)
    PROF.c.pop("overflow.fused_read", None)
    got = be.collect_chunk(encs, opt)
    assert 0 < PROF.c["overflow.fused_read"] < len(encs)
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


# (lanes G, list capacity, slots per read or None for slot_offsets' rule)
GROUP_CASES = {"cap64": (16, 160, 64), "cap5": (16, 160, 5),
               "G16": (16, 160, None), "G32": (32, 160, None),
               "G32_list10": (32, 10, None), "G16_list10": (16, 10, None),
               "G32_cap5": (32, 160, 5)}


@pytest.mark.parametrize("case", list(GROUP_CASES))
def test_smem_collect_dp_header_matches_ref(tmp_path, fm, encs, case):
    """csrc/smem_group.cuh (host build: the G lanes of one group stepped in
    lockstep, one read after another in place of the persistent grid) ==
    smem_collect_ref, slots, counts, overflow flags and backward_ext
    counts: at both lane widths, with equal-s survivors dropped as ties,
    and on the overflow routes of a small slot count (cap5) and a small
    list (list10).  The inputs hold N
    runs, reads below min_seed_len and an all-N read."""
    G, lcap, per = GROUP_CASES[case]
    seqs = seedall_inputs()
    assert "N" * 40 in seqs and "ACGT" * 5 in seqs
    assert any("N" in x and set(x) != {"N"} for x in seqs)
    lib = build_host_shim(str(tmp_path))
    dfm = DeviceFMIndex.from_host(fm, "cpu")
    opt = MemOptions().finalize()
    enc, lens = _pad_reads(encs)
    split_len = int(opt.min_seed_len * opt.split_factor + 0.499)
    lt = torch.from_numpy(lens)
    off = tseed.slot_offsets(lt)
    if per is not None:
        off = torch.arange(len(lens) + 1, dtype=torch.int64) * per
    args = (opt.min_seed_len, split_len, opt.split_width, opt.max_mem_intv,
            lcap)
    *h, stats = HostFm(lib, dfm).smem_group(enc, lens, *args, off.numpy(),
                                            G)
    r = [t.numpy() for t in tseed.smem_collect_ref(
        dfm, torch.from_numpy(enc), lt, *args, off)]
    np.testing.assert_array_equal(h[4], r[4])
    np.testing.assert_array_equal(h[5], r[5])
    overflow = int((r[4] < 0).sum())
    assert (r[5] > 0).any()
    assert (overflow > 0) == (per == 5 or lcap == 10)
    assert overflow < len(lens)
    assert stats["ties"] > 0
    o = off.numpy()
    rid = np.repeat(np.arange(len(lens)), np.diff(o))
    slot = (np.arange(o[-1]) - o[rid]) < np.maximum(r[4], 0)[rid]
    for a, b in zip(h[:4], r[:4]):
        np.testing.assert_array_equal(a[slot], b[slot])


@pytest.fixture(scope="module")
def repeat_genome(tmp_path_factory):
    """benchdata's genome at scale 0.01 (467 kb: ~155 copies of a 300 bp
    repeat at 2 % divergence), indexed, and 200 of its 2x150 reads: a
    forward walk inside a repeat copy sheds the other copies a few at a
    time, so candidate lists grow past 32 entries."""
    d = str(tmp_path_factory.mktemp("repeat_genome"))
    fa = os.path.join(d, "genome.fa")
    benchdata.make_genome(fa, 0.01)
    build_index(fa, fa)
    benchdata.sample_reads_pe(fa, fa + "_1.fq", fa + "_2.fq", 100)
    reads = read_chunk(FastxReader(fa + "_1.fq"), FastxReader(fa + "_2.fq"),
                       10**9)
    return FMIndex.load(fa), encode_reads([r.seq for r in reads])


@pytest.mark.parametrize("G", [16, 32])
def test_smem_group_long_lists_match_ref(tmp_path, repeat_genome, G):
    """Lists longer than the lane group (reads from a repeat-rich genome):
    the backward steps run in several lane-strided passes, and the host
    build of smem_group.cuh still equals smem_collect_ref, slots, counts
    and backward_ext counts."""
    fm, encs = repeat_genome
    dfm = DeviceFMIndex.from_host(fm, "cpu")
    opt = MemOptions().finalize()
    enc, lens = _pad_reads(encs)
    split_len = int(opt.min_seed_len * opt.split_factor + 0.499)
    off = tseed.slot_offsets(torch.from_numpy(lens))
    args = (opt.min_seed_len, split_len, opt.split_width, opt.max_mem_intv,
            tseed.list_cap(enc.shape[1]))
    *h, stats = HostFm(build_host_shim(str(tmp_path)), dfm).smem_group(
        enc, lens, *args, off.numpy(), G)
    r = [t.numpy() for t in tseed.smem_collect_ref(
        dfm, torch.from_numpy(enc), torch.from_numpy(lens), *args, off)]
    assert stats["passes"] > 0              # lists longer than the group
    assert (r[4] >= 0).all()
    np.testing.assert_array_equal(h[4], r[4])
    np.testing.assert_array_equal(h[5], r[5])
    o = off.numpy()
    rid = np.repeat(np.arange(len(lens)), np.diff(o))
    slot = (np.arange(o[-1]) - o[rid]) < r[4][rid]
    for a, b in zip(h[:4], r[:4]):
        np.testing.assert_array_equal(a[slot], b[slot])


def genome_reads(lengths, seed):
    """Mutated slices of the fixture genome's first contig (1 substitution
    per 200 bases), one per length."""
    with open(os.path.join(DATA, "ref_small.fa")) as f:
        g0 = "".join(f.read().split(">")[1].splitlines()[1:])
    rng = np.random.default_rng(seed)
    out = []
    for ln in lengths:
        p = int(rng.integers(0, len(g0) - ln))
        s = list(g0[p:p + ln])
        for _ in range(ln // 200):
            s[int(rng.integers(0, ln))] = "ACGT"[int(rng.integers(0, 4))]
        out.append("".join(s))
    return out


def test_plan_bytes_linear_in_bases():
    """The seeding wrapper's buffers for a default-size chunk (66,668 reads
    of 150 bp) plus one 20 kb read stay under 2 GB, and the long read adds
    its own slots only: nothing scales with N x L."""
    from bwamem2_tpu_torch.ops.seed_cuda import SmemCollect
    N = 66_668
    short = SmemCollect.plan_bytes(N, [150] * N)
    both = SmemCollect.plan_bytes(N + 1, [150] * N + [20_000])
    assert both < 2 * 10**9
    assert both - short < 200_000


def test_long_read_chunk_matches_host_oracle(tmp_path, fm):
    """A chunk of 2x150 reads and one 12 kb read: the group body
    (smem_group.cuh, host build, at the grid's list capacity and the
    per-read slot rule) gives the host oracle's SMEMs read for read; the
    wrapper's buffers for it are linear in its bases."""
    from bwamem2_tpu_torch.ops.seed_cuda import SmemCollect
    reads = read_chunk(FastxReader(os.path.join(DATA, "reads_r1.fq")),
                       FastxReader(os.path.join(DATA, "reads_r2.fq")),
                       10**9)[:60]
    encs = encode_reads([r.seq for r in reads] + genome_reads([12_000], 9))
    enc, lens = _pad_reads(encs)
    assert SmemCollect.plan_bytes(len(lens), lens) < 10**6
    opt = MemOptions().finalize()
    split_len = int(opt.min_seed_len * opt.split_factor + 0.499)
    off = tseed.slot_offsets(torch.from_numpy(lens)).numpy()
    lcap = tseed.list_cap(enc.shape[1])
    assert lcap == tseed.LIST_CAPS[1]
    m, n, k, s, cnt, nbwd, _ = HostFm(
        build_host_shim(str(tmp_path)), DeviceFMIndex.from_host(fm, "cpu")
    ).smem_group(enc, lens, opt.min_seed_len, split_len, opt.split_width,
                 opt.max_mem_intv, lcap, off, 16)
    assert (cnt >= 0).all() and cnt[-1] > 100
    _, smem_off, hm, hn, hs, _ = sa_positions_batch(
        opt, hostrt.collect_smems_reads(fm, encs, opt))
    np.testing.assert_array_equal(np.diff(smem_off), cnt)
    rid = np.repeat(np.arange(len(lens)), np.diff(off))
    slot = (np.arange(off[-1]) - off[rid]) < cnt[rid]
    for got, want in ((m, hm), (n, hn), (s, hs)):
        np.testing.assert_array_equal(got[slot], want)


def test_over_32kb_chunk_seeds_on_host(fm):
    """A chunk with a read over 32,000 bp: that read alone is seeded on the
    host oracle (counted as overflow.long_read) and has an empty row in
    the read grid; the chunk's other reads go through the seeding kernel's
    plain version and keep their read grid.  The SAM equals the
    host-native run's."""
    from bwamem2_tpu_torch.align.pipeline import Aligner
    from bwamem2_tpu_torch.io.fastq import Read
    seqs = genome_reads([33_000, 150, 150], 13)
    opt = MemOptions().finalize()
    sams = []
    for backend in (TorchBackend(fm, opt, device="cpu"), None):
        reads = [Read(name=f"r{i}", comment=None, seq=x, qual="I" * len(x))
                 for i, x in enumerate(seqs)]
        PROF.c.pop("overflow.long_read", None)
        n0 = tseed.smem_collect.plain_calls
        Aligner(fm, opt, backend=backend, verbose=0).process(reads, 0)
        sams.append([r.sam for r in reads])
        if backend is not None:
            assert PROF.c["overflow.long_read"] == 1
            assert tseed.smem_collect.plain_calls == n0 + 1
            assert backend.read_grid_width() == 152
    assert sams[0] == sams[1]
    assert all(x.count("\t") > 10 for x in sams[0])


def test_grid_read_cap_keeps_int32_offsets():
    """The read grid never passes the int32 flat offsets: at the default
    task size (66,668 reads) it takes reads up to 32,000 bp, at four times
    as many reads less, always N x L < 2^31."""
    cap = TorchBackend.grid_read_cap
    assert cap(66_668) == 32_000 and cap(3) == 32_000
    for N in (66_668, 266_672, 10**7):
        assert cap(N) % 8 == 0 and N * cap(N) < 2**31
    assert cap(266_672) < 32_000


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
    """The kernel's SA walk (sa_group.cuh, host build, one walk per lane)
    on random positions and the sentinel == sa_resolve_ref."""
    lib = build_host_shim(str(tmp_path))
    dfm = DeviceFMIndex.from_host(fm, "cpu")
    pos = np.random.default_rng(3).integers(0, fm.ref_seq_len, 5000)
    pos = np.concatenate([pos, [int(fm.sentinel_index)]]).astype(np.int64)
    np.testing.assert_array_equal(
        HostFm(lib, dfm).sa_group(pos)[0],
        tseed.sa_resolve_ref(dfm, torch.from_numpy(pos)).numpy())


@pytest.fixture(scope="module")
def sa_host(tmp_path_factory, fm):
    """(host build of the shim, DeviceFMIndex on the CPU, every BWT
    position, sa_resolve_ref's coordinates of them and its row reads)."""
    lib = build_host_shim(str(tmp_path_factory.mktemp("sa_group")))
    dfm = DeviceFMIndex.from_host(fm, "cpu")
    pos = np.arange(fm.ref_seq_len, dtype=np.int64)
    reads = []
    want = tseed.sa_resolve_ref(dfm, torch.from_numpy(pos), reads).numpy()
    return HostFm(lib, dfm), pos, want, reads[0]


@pytest.mark.parametrize("shuffled", [False, True],
                         ids=["input_order", "shuffled"])
@pytest.mark.parametrize("W", tseed.sa_resolve.WALKS)
def test_sa_group_matches_ref(sa_host, fm, W, shuffled):
    """sa_group.cuh's walk-and-refill loop (host build: 32 lanes in
    lockstep, W walks each) on every BWT position of the test index ==
    sa_resolve_ref, with as many occ-row reads (counted through
    SA_ROW_HOOK) as sa_resolve_ref's row_reads; the sentinel's walk ends
    there at once (its coordinate is 0).  Tickets resolved in a shuffled
    order give the same coordinates and row reads: the order in which
    lanes are refilled changes nothing."""
    host, pos, want, rows = sa_host
    sent = int(fm.sentinel_index)
    assert sent & 7 and want[sent] == 0
    perm = np.random.default_rng(5 + W).permutation(len(pos)) \
        if shuffled else None
    got, n = host.sa_group(pos, W, perm)
    np.testing.assert_array_equal(got, want)
    assert n == rows


def test_wrapper_dispatch(fm):
    """CPU tensors run the plain versions (counted as plain calls, never
    as launches); tensors on any other device go to the kernel path, which
    refuses anything but CUDA."""
    dfm = DeviceFMIndex.from_host(fm, "cpu")
    enc, lens = _pad_reads(encode_reads(["ACGTACGTACGTACGTACGTACGT"]))
    for k in (tseed.smem_collect, tseed.sa_resolve):
        k.reset()
    lt = torch.from_numpy(lens)
    out = tseed.smem_collect(dfm, torch.from_numpy(enc), lt, 19, 29, 10, 20,
                             160, tseed.slot_offsets(lt))
    assert len(out) == 6
    tseed.sa_resolve(dfm, torch.arange(16))
    for k in (tseed.smem_collect, tseed.sa_resolve):
        assert (k.plain_calls, k.launches) == (1, 0)
    with pytest.raises(ValueError, match="CUDA"):
        tseed.smem_collect(dfm, torch.from_numpy(enc).to("meta"), lt, 19,
                           29, 10, 20, 160, tseed.slot_offsets(lt))
    with pytest.raises(ValueError, match="CUDA"):
        tseed.sa_resolve(dfm, torch.arange(16).to("meta"))
    for k in (tseed.smem_collect, tseed.sa_resolve):
        assert (k.plain_calls, k.launches) == (1, 0)

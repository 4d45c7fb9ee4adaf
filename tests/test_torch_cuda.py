"""The port's seeding, extension (in-cap and long pairs), rescue and
gather kernels against their plain versions (or the native host kernels)
on the card (marker `cuda`; they skip without a GPU).

This file imports only the port, numpy and torch — no JAX — so that it
runs on a machine with a GPU and no JAX:

    pytest -m cuda tests/test_torch_cuda.py

The plain versions are held against the JAX package on the CPU by
tests/test_torch_seed.py, tests/test_torch_bsw.py,
tests/test_torch_bsw_shear.py, tests/test_torch_kswv.py,
tests/test_torch_round1_compact.py and tests/test_torch_gather.py;
chip_smoke.py
repeats these checks at the main path's sizes.  Tolerance 0 (integer).
"""

import os

import numpy as np
import pytest
import torch

from bwamem2_tpu_torch.align.seeding import encode_reads
from bwamem2_tpu_torch.benchdata import rescue_batch, rescue_windows
from bwamem2_tpu_torch.index.fmindex import FMIndex
from bwamem2_tpu_torch.io.fastq import FastxReader, read_chunk
from bwamem2_tpu_torch.native import ksw_align_desc
from bwamem2_tpu_torch.ops import seed as tseed
from bwamem2_tpu_torch.ops.backend import _pad_reads
from bwamem2_tpu_torch.ops.bsw import bsw_desc_ref, bsw_shear_desc_ref
from bwamem2_tpu_torch.ops.bsw_cuda import bsw_extend
from bwamem2_tpu_torch.ops.bsw_shear_cuda import bsw_shear
from bwamem2_tpu_torch.ops.device_index import DeviceFMIndex
from bwamem2_tpu_torch.ops.kswv import DeviceKswv, kswv_two_phase_ref
from bwamem2_tpu_torch.ops.kswv_cuda import kswv
from bwamem2_tpu_torch.ops.row_gather import row_gather, row_gather_ref
from bwamem2_tpu_torch.options import MemOptions

from conftest import DATA, FIXTURES
from test_torch_bsw_shear import DEFAULT, PACBIO, ZDROP10, make_long

PREFIX = os.path.join(FIXTURES, "ref_small.fa")


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def flat_equal(got, want, slot_off):
    """smem_collect outputs equal: counts, backward_ext counts and every
    read's first cnt slots (the rest is unspecified)."""
    got = [t.cpu().numpy() for t in got]
    want = [t.cpu().numpy() for t in want]
    np.testing.assert_array_equal(got[4], want[4])
    np.testing.assert_array_equal(got[5], want[5])
    off = slot_off.cpu().numpy()
    rid = np.repeat(np.arange(len(off) - 1), np.diff(off))
    slot = (np.arange(off[-1]) - off[rid]) < np.maximum(want[4], 0)[rid]
    for g, w in zip(got[:4], want[:4]):
        np.testing.assert_array_equal(g[slot], w[slot])
    return want[4]


@pytest.mark.cuda
def test_seeding_kernels_match_ref_on_card(card, monkeypatch):
    """smem_collect at each lane width, with the default route rules and
    with 5 slots per read (most reads overflow), and sa_resolve at each
    walk count per lane (every BWT position, in order and shuffled)
    against their plain versions on the card."""
    fm = FMIndex.load(PREFIX)
    dfm = DeviceFMIndex.from_host(fm, card)
    reads = read_chunk(FastxReader(os.path.join(DATA, "reads_r1.fq")),
                       FastxReader(os.path.join(DATA, "reads_r2.fq")),
                       10**9)
    enc, lens = _pad_reads(encode_reads([r.seq for r in reads]))
    e, ln = torch.from_numpy(enc).to(card), torch.from_numpy(lens).to(card)
    opt = MemOptions().finalize()
    rule = tseed.slot_offsets(ln)
    five = torch.arange(len(lens) + 1, device=card, dtype=torch.int64) * 5
    for lanes in tseed.smem_collect.LANES:
        # the width lanes_for would pick for another read count
        monkeypatch.setattr(tseed.smem_collect, "lanes_for",
                            lambda N, G=lanes: G)
        lcap = tseed.list_cap(enc.shape[1])
        for off in (rule, five):
            args = (dfm, e, ln, opt.min_seed_len, 29, opt.split_width,
                    opt.max_mem_intv, lcap, off)
            n = tseed.smem_collect.launches
            got = tseed.smem_collect(*args)
            torch.cuda.synchronize()
            assert tseed.smem_collect.launches == n + 1
            cnt = flat_equal(got, tseed.smem_collect_ref(*args), off)
            assert ((cnt < 0).any()) == (off is five)
    monkeypatch.undo()
    # sa_resolve at every walk count per lane, on every BWT position in
    # order and in a random order
    pos = torch.arange(fm.ref_seq_len, device=card)
    shuffled = torch.from_numpy(np.random.default_rng(7).permutation(
        fm.ref_seq_len)).to(card)
    for W in tseed.sa_resolve.WALKS:
        monkeypatch.setattr(tseed.sa_resolve, "shape_for",
                            lambda P, W=W: (W, 256))
        for p in (pos, shuffled):
            n = tseed.sa_resolve.launches
            got = tseed.sa_resolve(dfm, p)
            torch.cuda.synchronize()
            assert tseed.sa_resolve.launches == n + 1
            np.testing.assert_array_equal(
                got.cpu().numpy(), tseed.sa_resolve_ref(dfm, p).cpu().numpy())


@pytest.mark.cuda
def test_smem_collect_long_reads_on_card(card):
    """Mixed read lengths: 256 reads of 300-1,000 bp (mutated genome
    slices, some with N bases) against smem_collect_ref, and a chunk of
    2x150 reads with one 12 kb read against the host oracle (the plain
    version takes minutes on a 12 kb read): each read's slots are its own,
    so any read length takes the kernel."""
    from bwamem2_tpu_torch.align.chain import sa_positions_batch
    from bwamem2_tpu_torch.native import hostrt
    fm = FMIndex.load(PREFIX)
    dfm = DeviceFMIndex.from_host(fm, card)
    with open(os.path.join(DATA, "ref_small.fa")) as f:
        genome = "".join(ln.strip() for ln in f if not ln.startswith(">"))
    rng = np.random.default_rng(7)

    def sliced(ln, alphabet="ACGTN", every=80):
        p = int(rng.integers(0, len(genome) - ln))
        s = list(genome[p:p + ln])
        for _ in range(ln // every):
            s[int(rng.integers(0, ln))] = alphabet[int(rng.integers(
                0, len(alphabet)))]
        return "".join(s)

    opt = MemOptions().finalize()
    seqs = [sliced(int(rng.integers(300, 1001))) for _ in range(256)]
    reads = read_chunk(FastxReader(os.path.join(DATA, "reads_r1.fq")),
                       FastxReader(os.path.join(DATA, "reads_r2.fq")),
                       10**9)[:200]
    for encs, oracle in ((encode_reads(seqs), False),
                         (encode_reads([r.seq for r in reads]
                                       + [sliced(12_000, "ACGT", 200)]),
                          True)):
        enc, lens = _pad_reads(encs)
        e = torch.from_numpy(enc).to(card)
        ln = torch.from_numpy(lens).to(card)
        off = tseed.slot_offsets(ln)
        args = (dfm, e, ln, opt.min_seed_len, 29, opt.split_width,
                opt.max_mem_intv, tseed.list_cap(enc.shape[1]), off)
        got = tseed.smem_collect(*args)
        if not oracle:
            assert (flat_equal(got, tseed.smem_collect_ref(*args), off)
                    > 0).all()
            continue
        m, n, _, s, cnt, _ = (t.cpu().numpy() for t in got)
        assert (cnt >= 0).all() and cnt[-1] > 100
        _, smem_off, hm, hn, hs, _ = sa_positions_batch(
            opt, hostrt.collect_smems_reads(fm, encs, opt))
        np.testing.assert_array_equal(np.diff(smem_off), cnt)
        o = off.cpu().numpy()
        rid = np.repeat(np.arange(len(lens)), np.diff(o))
        slot = (np.arange(o[-1]) - o[rid]) < cnt[rid]
        for g, w in ((m, hm), (n, hn), (s, hs)):
            np.testing.assert_array_equal(g[slot], w)


@pytest.mark.cuda
def test_row_gather_kernel_matches_ref_on_card(card):
    for nblocks, W in ((1 << 16, 16), (1 << 12, 8)):
        rng = np.random.default_rng(W)
        tab = torch.from_numpy(rng.integers(-2**31, 2**31, (nblocks, W))
                               .astype(np.int32)).to(card)
        idx = torch.from_numpy(rng.integers(0, nblocks, 32768)
                               .astype(np.int32)).to(card)
        n = row_gather.launches
        got = row_gather(tab, idx)
        torch.cuda.synchronize()
        assert row_gather.launches == n + 1
        assert torch.equal(got, row_gather_ref(tab, idx))


@pytest.mark.cuda
def test_kswv_kernel_matches_ref_on_card(card):
    """kswv, both precision classes (u8 on 2x150-like problems, i16 on
    qlen 250-512 with windows up to 2,048), against kswv_two_phase_ref on
    the card, both phases; then mixed-length batches through both classes
    and both stripe placements."""
    fm = FMIndex.load(PREFIX)
    dfm = DeviceFMIndex.from_host(fm, card)
    opt = MemOptions().finalize()
    sc = (opt.min_seed_len * opt.a, opt.a, opt.b, opt.o_del, opt.e_del,
          opt.o_ins, opt.e_ins, dfm.ref_packed)
    for u8, seed, n, L, qr, tr, Qmax in (
            (True, 3, 512, 160, (60, 152), (150, 800), 160),
            (False, 5, 128, 512, (250, 513), (300, 2049), 512)):
        w = rescue_windows(fm.ref_string, seed, n, L, qr, tr, nmut=4,
                           n_every=5, plant=7)
        t = [torch.from_numpy(np.ascontiguousarray(x)).to(card) for x in w]
        Tmax = int(w[-1].max())
        n0 = kswv.launches
        got = kswv(dfm.ref, *t, Qmax, Tmax, *sc, u8)
        torch.cuda.synchronize()
        assert kswv.launches == n0 + 1
        want = kswv_two_phase_ref(dfm.ref, *t, Qmax, Tmax, *sc, u8)
        for g, x in zip(got, want):
            assert torch.equal(g, x)
        assert int((want[1][:, 0] > 0).sum()) > 0     # phase 1 ran
    # mixed-length batches of a prime count of problems, so that P is no
    # multiple of the groups per block: per class the short part alone
    # (stripes in registers) and short and long together (shared memory),
    # in DeviceKswv's launch order
    dk = DeviceKswv(dfm, opt)
    for u8, short, long_ in (
            (True, dict(n=2203, qr=(20, 257), tr=(40, 900)),
             dict(n=300, qr=(257, 400), tr=(300, 900))),
            (False, dict(n=1103, qr=(40, 129), tr=(60, 1500)),
             dict(n=200, qr=(129, 700), tr=(300, 1500)))):
        enc, desc = rescue_batch(fm.ref_string, [
            dict(seed=13, nmut=4, n_every=5, plant=7, u8=u8, **short),
            dict(seed=17, nmut=9, n_every=5, plant=7, u8=u8, **long_)])
        encj = torch.from_numpy(enc).to(card)
        (_, idx), = dk.launch_order(desc)
        for part, placement in ((idx[idx < short["n"]], "registers"),
                                (idx, "shared")):
            args = dk.kswv_args(encj, desc, part, u8)
            smax, gpb, _, _ = kswv.plan(len(part), args[8], u8, card)
            assert (smax > 0) == (placement == "registers")
            assert gpb > 1 and len(part) % gpb
            got = kswv(*args)
            want = kswv_two_phase_ref(*args)
            for g, x in zip(got, want):
                assert torch.equal(g, x), (u8, placement)


@pytest.mark.cuda
def test_device_kswv_long_problems_on_card(card):
    """DeviceKswv.align_batch on the card, on problems longer than the JAX
    package's device caps (qlen 513-1,200 in the i16 class, windows of
    2,049-4,000 bases in the u8 class), equals the native ksw_align: every
    problem runs in the kernel, whatever its length."""
    fm = FMIndex.load(PREFIX)
    dfm = DeviceFMIndex.from_host(fm, card)
    opt = MemOptions().finalize()
    enc, desc = rescue_batch(fm.ref_string, [
        dict(seed=9, n=48, qr=(513, 1201), tr=(600, 3000), nmut=30,
             n_every=5, plant=7, u8=False),
        dict(seed=11, n=48, qr=(60, 120), tr=(2049, 4001), nmut=3,
             n_every=5, plant=7, u8=True)])
    n0 = kswv.launches
    got = DeviceKswv(dfm, opt).align_batch(torch.from_numpy(enc).to(card),
                                           desc)
    assert kswv.launches == n0 + 2                    # one per class
    np.testing.assert_array_equal(got, ksw_align_desc(enc, fm.ref_string,
                                                      desc, opt))
    assert (got[:, 6] >= 0).sum() > 0                 # some were rescued


@pytest.mark.cuda
def test_i16_beyond_16_bits_takes_native_kernel_on_card(card):
    """On the card, i16 problems whose scores pass 16 bits (513-560
    bases, a = 64) run in the kernel beside the others, in one launch,
    saturating at 32767 as the native ksw_align does; the batch equals the
    native ksw_align."""
    fm = FMIndex.load(PREFIX)
    dfm = DeviceFMIndex.from_host(fm, card)
    opt = MemOptions()
    opt.a = 64
    opt.finalize()
    enc, desc = rescue_batch(fm.ref_string, [
        dict(seed=21, n=4, qr=(513, 560), tr=(600, 900), nmut=0,
             n_every=99, plant=7, u8=False),
        dict(seed=23, n=32, qr=(100, 400), tr=(200, 900), nmut=3,
             n_every=5, plant=7, u8=False)])
    dk = DeviceKswv(dfm, opt)
    assert int(dk.wide(desc).sum()) == 4
    n0 = kswv.launches
    got = dk.align_batch(torch.from_numpy(enc).to(card), desc)
    assert kswv.launches == n0 + 1
    want = ksw_align_desc(enc, fm.ref_string, desc, opt)
    np.testing.assert_array_equal(got, want)
    assert (want[:4, 0] == 32767).any()


@pytest.mark.cuda
def test_i16_at_a52_on_card(card):
    """mem -A52 scoring (-B scaled to 208, a mismatch of +48 in the int8
    matrix the kernel is given): an i16 batch (qlen 250-512) in the
    registers and shared-memory buckets equals kswv_two_phase_ref and the
    native ksw_align."""
    fm = FMIndex.load(PREFIX)
    dfm = DeviceFMIndex.from_host(fm, card)
    opt = MemOptions()
    opt.set("a", 52)
    opt.finalize()
    enc, desc = rescue_batch(fm.ref_string, [
        dict(seed=25, n=48, qr=(250, 513), tr=(300, 1200), nmut=8,
             n_every=5, plant=7, u8=False),
        dict(seed=27, n=48, qr=(40, 129), tr=(60, 400), nmut=2,
             n_every=5, plant=7, u8=False)])
    encj = torch.from_numpy(enc).to(card)
    dk = DeviceKswv(dfm, opt)
    for lo, hi in ((0, 48), (48, 96)):      # shared stripes, registers
        idx = np.arange(lo, hi)
        args = dk.kswv_args(encj, desc, idx, False)
        n0 = kswv.launches
        got = kswv(*args)
        assert kswv.launches == n0 + 1
        want = kswv_two_phase_ref(*args)
        for g, x in zip(got, want):
            assert torch.equal(g, x)
    got = dk.align_batch(encj, desc)
    want = ksw_align_desc(enc, fm.ref_string, desc, opt)
    np.testing.assert_array_equal(got, want)
    assert (want[:, 6] >= 0).sum() > 0                # some were rescued


def extension_batch(genome: np.ndarray, seed: int, P: int, Qmax: int,
                    Tmax: int):
    """P extension descriptors of mixed lengths (qlen 1..Qmax, one pair at
    Qmax; tlen 1..Tmax) over 2%-mutated genome slices in an int8[P, Qmax+8]
    read grid: half walk right, half left, 1 in 8 against an unrelated
    target; h0 in [19, 100), w in {20, 50, 100}."""
    rng = np.random.default_rng(seed)
    L, n = Qmax + 8, len(genome)
    qlen = rng.integers(1, Qmax + 1, P).astype(np.int32)
    qlen[P // 2] = Qmax
    tlen = rng.integers(1, Tmax + 1, P).astype(np.int32)
    s = rng.integers(Tmax + 8, n - L - Tmax - 8, P).astype(np.int64)
    enc = genome[s[:, None] + np.arange(L)[None, :]].astype(np.int8)
    mut = rng.random((P, L)) < 0.02
    enc[mut] = rng.integers(0, 4, int(mut.sum()))
    left = rng.random(P) < 0.5
    toff = np.where(left, s + qlen - 1, s)
    far = rng.random(P) < 0.125
    toff[far] = rng.integers(Tmax, n - Tmax, int(far.sum()))
    qoff = np.arange(P) * L + np.where(left, qlen - 1, 0)
    d = np.where(left, -1, 1).astype(np.int32)
    h0 = rng.integers(19, 100, P).astype(np.int32)
    w = rng.choice([20, 50, 100], P).astype(np.int32)
    return enc, qoff.astype(np.int32), d, qlen, toff, d, tlen, h0, w


@pytest.mark.cuda
def test_bsw_extend_buckets_on_card(card):
    """bsw_extend against bsw_desc_ref on the card, one launch per call, on
    mixed-length batches of a prime number of pairs whose longest query
    picks each (lanes, columns) bucket in turn: a prime P is no multiple
    of the groups per block, and the pairs arrive unsorted."""
    fm = FMIndex.load(PREFIX)
    dfm = DeviceFMIndex.from_host(fm, card)
    opt = MemOptions().finalize()
    sc = (opt.a, opt.b, opt.o_del, opt.e_del, opt.o_ins, opt.e_ins,
          opt.zdrop, opt.pen_clip5, max(opt.a, 1), dfm.ref_packed)
    for Qmax, P, bucket in ((31, 2203, (8, 4)), (63, 3001, (8, 8)),
                            (95, 2003, (16, 6)), (127, 2203, (16, 8)),
                            (159, 2003, (32, 5)), (191, 1201, (32, 6)),
                            (255, 3001, (32, 8)), (319, 1301, (32, 10)),
                            (383, 1201, (32, 12))):
        x = extension_batch(fm.ref_string, Qmax, P, Qmax, 608)
        t = [torch.from_numpy(np.ascontiguousarray(a)).to(card) for a in x]
        assert bsw_extend.plan(P, Qmax, card)[:2] == bucket
        n = bsw_extend.launches
        got = bsw_extend(dfm.ref, *t, Qmax, 608, *sc)
        torch.cuda.synchronize()
        assert bsw_extend.launches == n + 1
        want = bsw_desc_ref(dfm.ref, *t, Qmax, 608, *sc)
        assert torch.equal(got, want), Qmax


# (Wh, scoring, packed, route): the register buckets as the dispatch
# routes a call (a third of its pairs with h0 past 16 bits: one launch of
# each body) and with every pair in the int32 body; the shared-memory
# frame (int32 only)
SHEAR_CARD = {
    "w100_pacbio": (100, PACBIO, False, "kernel"),
    "w100_pacbio_int32": (100, PACBIO, False, "int32"),
    "w200_default_packed": (200, DEFAULT, True, "kernel"),
    "w200_default_packed_int32": (200, DEFAULT, True, "int32"),
    "w50_zdrop10": (50, ZDROP10, False, "kernel"),
    "w50_zdrop10_int32": (50, ZDROP10, False, "int32"),
    "w300_pacbio": (300, PACBIO, False, "kernel"),
    "w400_default": (400, DEFAULT, False, "kernel"),
    "w600_memory_frame": (600, PACBIO, False, "kernel"),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(SHEAR_CARD))
def test_bsw_shear_matches_ref_on_card(card, monkeypatch, case):
    """bsw_shear against bsw_shear_desc_ref on long pairs (qlen 257-3,000,
    ~10 % error, the frame's edge cases), in the dispatch's order (the
    16-bit pairs first, each part by descending row count): at each
    register bucket (Wh 100 and 50: C 7, R 4; Wh 200: C 13, R 7) with a
    launch of each body, and every pair in the int32 body; and in the
    shared-memory frame (Wh 300, 400, 600: C = 19, 26, 38)."""
    from bwamem2_tpu_torch.ops.bsw import DeviceBSW
    Wh, scoring, packed, route = SHEAR_CARD[case]
    d = list(make_long(900 + Wh, 256, (257, 3000), n_ref=60000,
                       edges=True))
    d[8] = d[8] + np.where(np.arange(len(d[8])) % 3 == 0, 32700, 0
                           ).astype(np.int32)
    fit = bsw_shear.fits16(d[4], d[8], Wh, *scoring[:6], max(scoring[0], 1))
    order, rows = DeviceBSW.long_order(d[4], d[7], Wh, fit)
    d = d[:2] + [x[order] for x in d[2:]]
    n16 = int(fit.sum()) if route == "kernel" else 0
    assert (0 < n16 < len(rows)) == (route == "kernel" and Wh <= 206)
    if packed:
        monkeypatch.setattr(DeviceFMIndex, "REF_PACK_MIN", 16)
    dfm = DeviceFMIndex.from_genome(d[0], card)
    assert dfm.ref_packed == packed
    t = [torch.from_numpy(np.ascontiguousarray(x)).to(card) for x in d[1:]]
    t[8] = torch.full_like(t[8], Wh)
    args = (dfm.ref, *t, Wh, int(rows.max()), *scoring,
            max(scoring[0], 1), packed)
    n = bsw_shear.launches
    got = bsw_shear(*args, n16=n16)
    torch.cuda.synchronize()
    assert bsw_shear.launches == n + 1 + (0 < n16 < len(rows))
    assert (bsw_shear.plan(256, Wh, card)[4] > 0) == (Wh > 206)
    want = bsw_shear_desc_ref(*args)
    np.testing.assert_array_equal(got.cpu().numpy(), want.cpu().numpy())


def step_batch(fm, n, L, seed):
    """n reads of L bases cut from the genome with 3 substitutions each
    (__graft_entry__.py:_example_batch), the last ones with an N run, a
    short length and no bases."""
    rng = np.random.default_rng(seed)
    enc = np.full((n, L), 4, np.int8)
    lens = np.full((n,), L, np.int32)
    for i in range(n):
        p = int(rng.integers(0, fm.l_pac - L))
        enc[i] = fm.ref_string[p:p + L]
        mut = rng.integers(0, L, 3)
        enc[i, mut] = (enc[i, mut] + 1) % 4
    enc[-3, L // 3:L // 3 + 5] = 4
    lens[-2] = L // 4
    enc[-2, L // 4:] = 4
    lens[-1] = 0
    enc[-1] = 4
    return enc, lens


@pytest.mark.cuda
def test_round1_walk_matches_ref_on_card(card):
    """round1_walk's kernel against round1_walk_ref on the PE fixture's
    reads and on edge reads."""
    from bwamem2_tpu_torch.ops.smem import round1_walk, round1_walk_ref
    fm = FMIndex.load(PREFIX)
    dfm, dfm_h = (DeviceFMIndex.from_host(fm, d) for d in (card, "cpu"))
    reads = read_chunk(FastxReader(os.path.join(DATA, "reads_r1.fq")),
                       FastxReader(os.path.join(DATA, "reads_r2.fq")),
                       10**9)
    for enc, lens in (_pad_reads(encode_reads([r.seq for r in reads])),
                      step_batch(fm, 64, 152, 3)):
        e, ln = torch.from_numpy(enc), torch.from_numpy(lens)
        n = round1_walk.launches
        got = round1_walk(dfm, e.to(card), ln.to(card))
        torch.cuda.synchronize()
        assert round1_walk.launches == n + 1
        for g, w in zip(got, round1_walk_ref(dfm_h, e, ln)):
            np.testing.assert_array_equal(g.cpu().numpy(), w.numpy())


@pytest.mark.cuda
def test_round1_walk_has_hi_body_on_card(card):
    """round1_walk and round1_compact run a second body where the index has
    the count-hi plane (counts past 2^32, fm_occ.cuh:fm_round1_walk_lut):
    over the fixture index with an all-zero hi plane marked present, that
    body gives the plain versions' answers, replicated and over 2 shards
    on one card."""
    import dataclasses
    from bwamem2_tpu_torch.index.klut import build_klut
    from bwamem2_tpu_torch.ops.smem import (round1_compact, round1_compact_ref,
                                            round1_walk, round1_walk_ref)
    from bwamem2_tpu_torch.parallel.shard_index import shard_index
    fm = FMIndex.load(PREFIX)
    lut = build_klut(fm, 6)
    dfm, dfm_h = (DeviceFMIndex.from_host(fm, d, lut) for d in (card, "cpu"))
    hi = dataclasses.replace(dfm, has_hi=True, occ_hi=torch.zeros(
        dfm.occp.shape[0], dtype=torch.int32, device=card))
    enc, lens = step_batch(fm, 64, 152, 3)
    e, ln = torch.from_numpy(enc), torch.from_numpy(lens)
    want = round1_walk_ref(dfm_h, e, ln)
    for view in (hi, shard_index(hi, [card, card])[0]):
        got = round1_walk(view, e.to(card), ln.to(card))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.cpu().numpy(), w.numpy())
    for K in (0, 6):
        got = round1_compact(hi, e.to(card), ln.to(card), K, 19, 24)
        for g, w in zip(got, round1_compact_ref(dfm_h, e, ln, K, 19, 24)):
            np.testing.assert_array_equal(g.cpu().numpy(), w.numpy())


@pytest.mark.cuda
def test_bsw_tiles_match_ref_on_card(card):
    """bsw_tiles (bsw_extend) on the card against the same adapter on the
    CPU (bsw_desc_ref)."""
    from bwamem2_tpu_torch.ops.bsw import bsw_tiles
    rng = np.random.default_rng(11)
    Qmax, Tmax, P = 128, 256, 2048
    t = rng.integers(0, 4, (P, Tmax)).astype(np.int8)
    q = t[:, :Qmax].copy()
    mut = rng.random((P, Qmax)) < 0.05
    q[mut] = rng.integers(0, 4, int(mut.sum()))
    qlen = rng.integers(1, Qmax + 1, P).astype(np.int32)
    tlen = rng.integers(1, Tmax + 1, P).astype(np.int32)
    h0 = rng.integers(1, 60, P).astype(np.int32)
    w = rng.choice([20, 50, 100], P).astype(np.int32)
    args = [torch.from_numpy(x) for x in (q, t, qlen, tlen, h0, w)]
    sc = (1, 4, 6, 1, 6, 1, 100, 5, 1)
    got = bsw_tiles(*(a.to(card) for a in args), *sc)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(got.cpu().numpy(),
                                  bsw_tiles(*args, *sc).numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("K", [0, 6])
def test_round1_compact_matches_ref_on_card(card, K):
    """round1_compact (the legacy round 1) against round1_compact_ref on
    the PE fixture's reads and on edge reads, with the K-mer table (K = 6)
    and without it, at the backend's 24 slots and at 2 (reads
    overflow)."""
    from bwamem2_tpu_torch.index.klut import build_klut
    from bwamem2_tpu_torch.ops.smem import round1_compact, round1_compact_ref
    fm = FMIndex.load(PREFIX)
    lut = build_klut(fm, K) if K else None
    dfm, dfm_h = (DeviceFMIndex.from_host(fm, d, lut) for d in (card, "cpu"))
    reads = read_chunk(FastxReader(os.path.join(DATA, "reads_r1.fq")),
                       FastxReader(os.path.join(DATA, "reads_r2.fq")),
                       10**9)
    for enc, lens in (_pad_reads(encode_reads([r.seq for r in reads])),
                      step_batch(fm, 64, 152, 3)):
        e, ln = torch.from_numpy(enc), torch.from_numpy(lens)
        for cap, msl in ((24, 19), (2, 8)):
            n = round1_compact.launches
            got = round1_compact(dfm, e.to(card), ln.to(card), K, msl, cap)
            torch.cuda.synchronize()
            assert round1_compact.launches == n + 1
            for g, w in zip(got, round1_compact_ref(dfm_h, e, ln, K, msl,
                                                    cap)):
                np.testing.assert_array_equal(g.cpu().numpy(), w.numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("klut", [False, True], ids=["K0", "lut"])
def test_legacy_backend_golden_on_card(card, klut):
    """TorchBackend(pivot_seeding=False) on the card writes golden_pe.sam,
    round 1 on round1_compact."""
    from bwamem2_tpu_torch.align.pipeline import Aligner
    from bwamem2_tpu_torch.ops.backend import TorchBackend
    from bwamem2_tpu_torch.ops.smem import round1_compact
    from bwamem2_tpu_torch.options import MEM_F_PE
    fm = FMIndex.load(PREFIX)
    opt = MemOptions().finalize()
    opt.flag |= MEM_F_PE
    reads = read_chunk(FastxReader(os.path.join(DATA, "reads_r1.fq")),
                       FastxReader(os.path.join(DATA, "reads_r2.fq")),
                       10**9)
    n = round1_compact.launches
    be = TorchBackend(fm, opt, card, pivot_seeding=False, use_klut=klut)
    Aligner(fm, opt, backend=be, verbose=0).process(reads, 0)
    assert round1_compact.launches == n + 1
    with open(os.path.join(FIXTURES, "golden_pe.sam")) as f:
        golden = [ln for ln in f if not ln.startswith("@")]
    assert "".join(r.sam for r in reads).splitlines(keepends=True) == golden


@pytest.mark.cuda
@pytest.mark.parametrize("u8", [True, False], ids=["u8", "i16"])
def test_kswv_phase_matches_ref_on_card(card, u8):
    """kswv_phase (one phase, the caller's target directions, live flags
    and stop scores) against kswv_phase_ref on the card, at a small batch
    (the planner's split form) and a large one (one thread a lane), each
    also in the other form and at every S the query allows: one launch a
    call."""
    from bwamem2_tpu_torch.ops.kswv import NO_LIMIT, kswv_phase_ref
    from bwamem2_tpu_torch.ops.kswv_cuda import kswv_phase
    genome = FMIndex.load(PREFIX).ref_string
    L, qr, tr, Qmax, Tmax, sizes = ((160, (100, 161), (150, 700), 160, 700,
                                     (256, 12288)) if u8 else
                                    (512, (250, 513), (300, 2049), 512,
                                     2048, (64, 2048)))
    for n in sizes:
        enc, qoff, qdir, qcomp, qlen, toff, tlen = rescue_windows(
            genome, seed=61, n=n, L=L, qr=qr, tr=tr, nmut=3, n_every=5,
            plant=7)
        rng = np.random.default_rng(61)
        tdir = np.where(np.arange(n) % 3 == 1, -1, 1).astype(np.int32)
        toff = np.where(tdir < 0, toff + tlen - 1, toff).astype(np.int64)
        endsc = rng.choice(np.array([NO_LIMIT, 20, 35], np.int32), n)
        live = np.arange(n) % 5 != 2
        args = [torch.from_numpy(np.ascontiguousarray(a)) for a in (
            genome, enc, qoff, qdir, qcomp, qlen, toff, tdir, tlen, endsc,
            live)]
        rest = (Qmax, Tmax, 19, 1, 4, 6, 1, 6, 1, False, u8)
        on = [a.to(card) for a in args]
        want = kswv_phase_ref(*on, *rest).cpu().numpy()   # plain, on card
        seen = set()
        try:
            for split in (0, 1, 2, 4, 8):
                kswv_phase.split = split
                try:
                    S = kswv_phase.plan(n, Qmax, u8, torch.device(card))[3]
                except ValueError:
                    continue        # an S this Qmax does not allow
                seen.add(S)
                n0 = kswv_phase.launches
                got = kswv_phase(*on, *rest)
                torch.cuda.synchronize()
                assert kswv_phase.launches == n0 + 1
                np.testing.assert_array_equal(got.cpu().numpy(), want)
        finally:
            kswv_phase.split = 0
        assert 1 in seen and len(seen) >= 2


@pytest.mark.cuda
def test_bsw_shear_tiles_match_ref_on_card(card):
    """bsw_shear_tiles on the card (both bodies: some h0 past 16 bits)
    against the same adapter on the CPU (bsw_shear_desc_ref), at a small
    batch (the planner's split-band form: one launch) and a large one (one
    warp a pair: one launch per body, on two streams), each also in the
    other form."""
    from bwamem2_tpu_torch.ops.bsw import bsw_shear_tiles
    from bwamem2_tpu_torch.tools.kernel_micro import shear_tiles
    rng = np.random.default_rng(13)
    Wh = 100
    sc = (1, 4, 6, 1, 6, 1, 100, 5, 1)
    for P, qr in ((24, (600, 1500)), (640, (300, 700))):
        q, t, qlen, tlen = shear_tiles(rng, P, qr, "cpu")
        h0 = torch.from_numpy(np.where(np.arange(P) % 3 == 0,
                                       rng.integers(30000, 40000, P),
                                       rng.integers(20, 200, P))
                              .astype(np.int32))
        w = torch.full((P,), Wh, dtype=torch.int32)
        want = bsw_shear_tiles(q, t, qlen, tlen, h0, w, Wh, *sc).numpy()
        on = [a.to(card) for a in (q, t, qlen, tlen, h0, w)]
        seen = set()
        try:
            for split in (0, 1, 2):
                bsw_shear.split = split
                K = bsw_shear.plan(P, Wh, torch.device(card))[5]
                seen.add(K)
                n = bsw_shear.launches
                got = bsw_shear_tiles(*on, Wh, *sc)
                torch.cuda.synchronize()
                # one launch per body, or one split-band launch
                assert bsw_shear.launches == n + (2 if K == 1 else 1)
                np.testing.assert_array_equal(got.cpu().numpy(), want)
        finally:
            bsw_shear.split = 0
        assert seen == {1, 2}


@pytest.mark.cuda
def test_seed_extend_step_on_card(card):
    """seed_extend_step on the card equals the CPU path (plain versions),
    all five outputs, on the compile-check batch and at L = 152; and
    sharded_seed_extend over the visible cards equals the one-card step."""
    from bwamem2_tpu_torch.ops.entry import seed_extend_step
    from bwamem2_tpu_torch.parallel.mesh import (make_mesh,
                                                 sharded_seed_extend)
    for prefix, n, L in ((os.path.join(FIXTURES, "ref_tiny.fa"), 32, 128),
                         (PREFIX, 512, 152)):
        fm = FMIndex.load(prefix)
        dfm = DeviceFMIndex.from_host(fm, card)
        enc, lens = step_batch(fm, n, L, 0)
        got = [g.cpu().numpy() for g in seed_extend_step(dfm, enc, lens)]
        want = seed_extend_step(DeviceFMIndex.from_host(fm, "cpu"), enc,
                                lens)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w.numpy())
        for g, w in zip(sharded_seed_extend(make_mesh(), dfm, enc, lens),
                        got):
            np.testing.assert_array_equal(g, w)


@pytest.mark.cuda
def test_round_robin_over_every_card(card):
    """One TorchBackend per visible card through run_pipeline: SE equals
    golden_se.sam and every backend launches its chunks' kernels.  With
    one card it skips (chip_smoke.py drives two backends on one card)."""
    from bwamem2_tpu_torch.align.pipeline import Aligner
    from bwamem2_tpu_torch.ops import resolve_devices
    from bwamem2_tpu_torch.ops.backend import TorchBackend
    from bwamem2_tpu_torch.runtime import run_pipeline
    import io
    devs = resolve_devices("cuda")
    if len(devs) < 2:
        pytest.skip("one visible card")
    fm = FMIndex.load(PREFIX)
    opt = MemOptions().finalize()
    aligners = [Aligner(fm, opt, backend=TorchBackend(fm, opt, d),
                        verbose=0) for d in devs]
    out = io.StringIO()
    run_pipeline(aligners, FastxReader(os.path.join(DATA, "reads_se.fq")),
                 None, 3000, out, verbose=0, n_workers=len(devs))
    with open(os.path.join(FIXTURES, "golden_se.sam")) as f:
        assert out.getvalue() == "".join(ln for ln in f
                                         if not ln.startswith("@"))
    for a in aligners:
        assert a.backend.launches.get("smem_collect", 0) > 0, a.backend.device


NCCL_WORKER = """
import sys
sys.path.insert(0, {repo!r})
import torch
import torch.distributed as dist
from bwamem2_tpu_torch.align.pipeline import Aligner
from bwamem2_tpu_torch.index.fmindex import FMIndex
from bwamem2_tpu_torch.io.fastq import FastxReader
from bwamem2_tpu_torch.ops.backend import TorchBackend
from bwamem2_tpu_torch.options import MemOptions
from bwamem2_tpu_torch.parallel.multihost import init_distributed, run_sharded
rank, world = init_distributed()        # the default: card RANK
assert dist.get_backend() == "nccl" and world == {world}
assert torch.cuda.current_device() == rank
got = [torch.zeros(1, dtype=torch.int64, device="cuda") for _ in range(world)]
dist.all_gather(got, torch.tensor([rank + 1], device="cuda"))
assert [int(g) for g in got] == list(range(1, world + 1)), got
fm = FMIndex.load({prefix!r})
opt = MemOptions().finalize()
be = TorchBackend(fm, opt, torch.device("cuda", rank))
run_sharded(Aligner(fm, opt, backend=be, verbose=0), FastxReader({fq!r}),
            None, 3000, {outdir!r}, rank, world, verbose=0)
assert be.launches.get("smem_collect", 0) > 0, be.launches
dist.barrier()
dist.destroy_process_group()
"""


@pytest.mark.cuda
def test_nccl_shards_over_every_card(card, tmp_path):
    """One process per visible card through init_distributed on nccl (its
    default device: card RANK): an all_gather, then each process aligns
    its shard of the SE fixture on its own card; the merged chunks equal
    golden_se.sam.  With one card it skips (chip_smoke.py runs two
    --shard processes on one card)."""
    import glob
    import socket
    import subprocess
    import sys
    from bwamem2_tpu_torch.parallel.multihost import merge_chunks
    world = torch.cuda.device_count()
    if world < 2:
        pytest.skip("one visible card")
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    outdir = str(tmp_path / "parts")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    script = NCCL_WORKER.format(repo=repo, world=world, prefix=PREFIX,
                                fq=os.path.join(DATA, "reads_se.fq"),
                                outdir=outdir)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
               WORLD_SIZE=str(world))
    procs = [subprocess.Popen([sys.executable, "-c", script],
                              env={**env, "RANK": str(r)},
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE)
             for r in range(world)]
    try:
        outs = [p.communicate(timeout=600) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, (so, se) in zip(procs, outs):
        assert p.returncode == 0, se.decode()[-3000:]
    merged = str(tmp_path / "merged.sam")
    with open(merged, "w") as f:
        merge_chunks(f, glob.glob(os.path.join(outdir, "part.chunk*.sam")))
    with open(merged) as f, open(os.path.join(FIXTURES, "golden_se.sam")) as g:
        assert f.read() == "".join(ln for ln in g if not ln.startswith("@"))


# ------------------------------------------------ the sharded index
def stage_inputs(fm):
    """The PE fixture's read grid, its round-1 pivots (the second half at
    min_intv 3) padded with dead pivots, their forward candidates and the
    candidate lanes (7 pad lanes on the last, dead pivot), all on the CPU
    from the plain versions."""
    from bwamem2_tpu_torch.ops import smem
    from bwamem2_tpu_torch.ops.backend import ROUND2_MAX_CAND, pivot_cap
    reads = read_chunk(FastxReader(os.path.join(DATA, "reads_r1.fq")),
                       FastxReader(os.path.join(DATA, "reads_r2.fq")),
                       10**9)
    enc, lens = (torch.from_numpy(a) for a in
                 _pad_reads(encode_reads([r.seq for r in reads])))
    dfm = DeviceFMIndex.from_host(fm, "cpu")
    cap = pivot_cap(enc.shape[1])
    npiv, px = smem.round1_chain_ref(dfm, enc, lens, cap)
    take = npiv.long().clamp(max=cap)
    rid = torch.repeat_interleave(torch.arange(len(take)), take).int()
    x = px[torch.arange(cap)[None, :] < take[:, None]]
    P = len(rid) + 64
    ridp = torch.full((P,), -1, dtype=torch.int32)
    ridp[:len(rid)] = rid
    xp = torch.zeros(P, dtype=torch.int32)
    xp[:len(x)] = x
    mi = torch.ones(P, dtype=torch.int64)
    mi[len(rid) // 2:len(rid)] = 3
    fwd = smem.round2_forward_ref(dfm, enc, ridp, xp, mi, ROUND2_MAX_CAND)
    nc = fwd[4].long().clamp(max=ROUND2_MAX_CAND)
    piv = torch.repeat_interleave(torch.arange(P), nc)
    slot = torch.arange(len(piv)) - torch.repeat_interleave(
        nc.cumsum(0) - nc, nc)
    piv = torch.cat([piv, torch.full((7,), P - 1)]).int()
    slot = torch.cat([slot, torch.zeros(7, dtype=torch.long)]).int()
    return dfm, enc, lens, cap, ridp, xp, mi, fwd, piv, slot


def skewed_stage_inputs(fm, n_long: int = 8, n_short: int = 600,
                        L: int = 150, seed: int = 11):
    """A skewed round-2 batch on the CPU: n_long reads cut from the genome
    (their walks run to the read's ends) among n_short random reads (their
    walks die within a few steps), three pivots a read (x 0, L // 2 and
    L - 10; min_intv 1, every fourth 3) and 64 pad pivots, with the plain
    version's candidate lanes at width ROUND2_MAX_CAND."""
    from bwamem2_tpu_torch.ops import smem
    from bwamem2_tpu_torch.ops.backend import ROUND2_MAX_CAND
    rng = np.random.default_rng(seed)
    ref = np.asarray(fm.ref_string)
    rows = [rng.integers(0, 4, L).astype(np.int8) for _ in range(n_short)]
    for at, p in zip(rng.choice(n_short, n_long, replace=False),
                     rng.integers(0, len(ref) - L, n_long)):
        rows[at] = np.minimum(ref[p:p + L], 4).astype(np.int8)
    enc = torch.from_numpy(np.stack(rows))
    N = len(rows)
    P = 3 * N + 64
    ridp = torch.full((P,), -1, dtype=torch.int32)
    ridp[:3 * N] = torch.arange(N, dtype=torch.int32).repeat_interleave(3)
    xp = torch.zeros(P, dtype=torch.int32)
    xp[:3 * N] = torch.tensor([0, L // 2, L - 10],
                              dtype=torch.int32).repeat(N)
    mi = torch.ones(P, dtype=torch.int64)
    mi[:3 * N:4] = 3
    dfm = DeviceFMIndex.from_host(fm, "cpu")
    fwd = smem.round2_forward_ref(dfm, enc, ridp, xp, mi, ROUND2_MAX_CAND)
    nc = fwd[4].long().clamp(max=ROUND2_MAX_CAND)
    piv = torch.repeat_interleave(torch.arange(P), nc).int()
    slot = (torch.arange(len(piv)) - torch.repeat_interleave(
        nc.cumsum(0) - nc, nc)).int()
    return dfm, enc, ridp, xp, mi, fwd, piv, slot


def _equal(got, want):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.cpu().numpy(), w.numpy())


@pytest.mark.cuda
def test_stage_kernels_match_ref_on_card(card):
    """round1_chain, round2_forward, round2_backward (both entries, with
    and without steps_max), round3_replay, round1_walk and sa_resolve on
    the card against their plain versions on the CPU: over the replicated
    index, over 2 shards on this card and, where there are several cards,
    over one shard per card (peer loads); then round2_forward (C 24 and 4)
    and round2_backward (both entries) on a skewed batch, replicated and
    over 2 shards."""
    from bwamem2_tpu_torch.ops import smem
    from bwamem2_tpu_torch.ops.backend import ROUND2_MAX_CAND
    from bwamem2_tpu_torch.parallel.shard_index import shard_index
    fm = FMIndex.load(PREFIX)
    dfm_h, enc, lens, cap, ridp, xp, mi, fwd, piv, slot = stage_inputs(fm)
    L = enc.shape[1]
    n = torch.cuda.device_count()
    layouts = [[card], [card, card]] + ([[torch.device("cuda", i)
                                          for i in range(n)]] if n > 1
                                        else [])
    pos = torch.from_numpy(np.random.default_rng(5).integers(
        0, int(dfm_h.counts[4]), 50000))
    want = dict(
        r1=smem.round1_chain_ref(dfm_h, enc, lens, cap),
        r3=smem.round3_replay_ref(dfm_h, enc, lens, 20, 20, L // 20 + 1),
        fwd=fwd,
        bwd8=smem.round2_backward_ref(dfm_h, enc, ridp, xp, fwd[1], fwd[3],
                                      piv, slot, mi, 8),
        bwd=smem.round2_backward_ref(dfm_h, enc, ridp, xp, fwd[1], fwd[3],
                                     piv, slot, mi),
        walk=smem.round1_walk_ref(dfm_h, enc, lens),
        sa=[tseed.sa_resolve_ref(dfm_h, pos)])
    live = want["bwd8"][4].nonzero()[:, 0]
    lp = piv[live].long()
    res = [ridp[lp], xp[lp], mi[lp]] + [w[live] for w in want["bwd8"][:3]]
    want["resume"] = smem.round2_backward_resume_ref(dfm_h, enc, *res, L - 8)
    for devs in layouts:
        d = (DeviceFMIndex.from_host(fm, card) if len(devs) == 1
             else shard_index(dfm_h, devs)[0])
        c = lambda *a: [x.to(card) for x in a]  # noqa: E731
        e, ln = c(enc, lens)
        got = dict(
            r1=smem.round1_chain(d, e, ln, cap),
            r3=smem.round3_replay(d, e, ln, 20, 20, L // 20 + 1),
            fwd=smem.round2_forward(d, e, *c(ridp, xp, mi), ROUND2_MAX_CAND),
            bwd8=smem.round2_backward(d, e, *c(ridp, xp, fwd[1], fwd[3],
                                               piv, slot, mi), 8),
            bwd=smem.round2_backward(d, e, *c(ridp, xp, fwd[1], fwd[3], piv,
                                              slot, mi)),
            resume=smem.round2_backward.resume(d, e, *c(*res[:5]),
                                               res[5].to(card), L - 8),
            walk=smem.round1_walk(d, e, ln),
            sa=[tseed.sa_resolve(d, pos.to(card))])
        torch.cuda.synchronize()
        for k in want:
            _equal(got[k], want[k])
    # a skewed batch: a few walks to the read's ends among many short ones
    # and more candidates than C = 4, replicated and over 2 shards
    dfm_h, enc, ridp, xp, mi, fwd, piv, slot = skewed_stage_inputs(fm)
    L = enc.shape[1]
    want = dict(fwd=fwd, fwd4=smem.round2_forward_ref(dfm_h, enc, ridp, xp,
                                                      mi, 4),
                bwd=smem.round2_backward_ref(dfm_h, enc, ridp, xp, fwd[1],
                                             fwd[3], piv, slot, mi),
                bwd8=smem.round2_backward_ref(dfm_h, enc, ridp, xp, fwd[1],
                                              fwd[3], piv, slot, mi, 8))
    steps = want["bwd"][0]
    assert int(steps.max()) >= L - 20 and float(steps.float().median()) < 20
    assert int((want["fwd4"][4] > 4).sum()) >= 8
    live = want["bwd8"][4].nonzero()[:, 0]
    lp = piv[live].long()
    res = [ridp[lp], xp[lp], mi[lp]] + [w[live] for w in want["bwd8"][:3]]
    want["resume"] = smem.round2_backward_resume_ref(dfm_h, enc, *res, L - 8)
    fw, bw = smem.round2_forward, smem.round2_backward
    for devs in ([card], [card, card]):
        d = (DeviceFMIndex.from_host(fm, card) if len(devs) == 1
             else shard_index(dfm_h, devs)[0])
        c = lambda *a: [x.to(card) for x in a]  # noqa: E731
        e = enc.to(card)
        got = dict(
            fwd=fw(d, e, *c(ridp, xp, mi), ROUND2_MAX_CAND),
            fwd4=fw(d, e, *c(ridp, xp, mi), 4),
            bwd=bw(d, e, *c(ridp, xp, fwd[1], fwd[3], piv, slot, mi)),
            bwd8=bw(d, e, *c(ridp, xp, fwd[1], fwd[3], piv, slot, mi), 8),
            resume=bw.resume(d, e, *c(*res[:5]), res[5].to(card), L - 8))
        torch.cuda.synchronize()
        for k in want:
            _equal(got[k], want[k])


@pytest.mark.cuda
def test_sharded_mem_and_step_on_cards(card):
    """mem SE over a sharded backend (one shard per card, or two on this
    card with one card) equals golden_se.sam, with every per-stage kernel
    and sa_resolve launched and no plain version run; the seed-extend step
    over a sharded index equals the replicated step."""
    from bwamem2_tpu_torch.align.pipeline import Aligner
    from bwamem2_tpu_torch.ops import smem
    from bwamem2_tpu_torch.ops.backend import TorchBackend
    from bwamem2_tpu_torch.ops.entry import seed_extend_step
    from bwamem2_tpu_torch.parallel.shard_index import (
        sharded_seed_extend_sharded_index)
    n = torch.cuda.device_count()
    devs = ([torch.device("cuda", i) for i in range(n)] if n > 1
            else [card, card])
    fm = FMIndex.load(PREFIX)
    opt = MemOptions().finalize()
    reads = read_chunk(FastxReader(os.path.join(DATA, "reads_se.fq")), None,
                       10**9)
    kern = (smem.round1_chain, smem.round2_forward, smem.round2_backward,
            smem.round3_replay, tseed.sa_resolve)
    for k in kern:
        k.reset()
    be = TorchBackend(fm, opt, devices=devs, sharded=True)
    Aligner(fm, opt, backend=be, verbose=0).process(reads, 0)
    assert all(k.launches >= len(devs) and not k.plain_calls for k in kern)
    with open(os.path.join(FIXTURES, "golden_se.sam")) as f:
        want = [ln for ln in f if not ln.startswith("@")]
    assert "".join(r.sam for r in reads).splitlines(keepends=True) == want
    dfm = DeviceFMIndex.from_host(fm, card)
    enc, lens = step_batch(fm, 512, 152, 1)
    rep = [g.cpu().numpy() for g in seed_extend_step(dfm, enc, lens)]
    for g, w in zip(sharded_seed_extend_sharded_index(devs, dfm, enc, lens),
                    rep):
        np.testing.assert_array_equal(g, w)

"""The sharded index and the per-stage seeding of the port on the CPU,
value for value (tolerance 0 throughout).

* each per-stage plain version (round1_chain_ref, round2_forward_ref,
  round2_backward_ref with and without steps_max, round2_backward_
  resume_ref, round3_replay_ref) against the JAX kernel of the same name
  (jitted XLA, no Pallas) on the fixture index, replicated and through 2
  and 3 shards (the last shard padded);
* the kernels' bodies (csrc/seed_stages.cuh with fm_occ.cuh's FmView and
  FmShardView, and sa_group.cuh over FmShardView) compiled as host C++
  against the plain versions: round 1's and round 3's with their step
  counts in all and per read, on the fixture's reads and on a genome
  built to reach every exit (an element in 30 copies, the text's end, the
  strands' boundary, absent 6-mers, Ns); round 2's forward body with its
  steps, and its backward body (r2b_group.cuh) under permuted ticket
  orders;
* the K-mer table (index/klut.py) against K forward extensions;
* dist_rows_ref through occ_all4, bwt_char_occ and occ_one, and the
  sharded SA walk, against JAX's sharded kernels on the virtual 8-device
  CPU mesh (tests/test_shard_index.py:48-82);
* sharded_seed_extend_sharded_index over 2 CPU "cards" against JAX's on
  the mesh and against the replicated step;
* the port's sharded collect_smems against JAX's DeviceBackend.
  collect_smems, a chunk of 3 reads over 2 shards (the pad read emits
  nothing), and `mem` SE and PE through the CLI over 2 and 3 shards
  (ops.resolve_devices patched, BWAMEM2_TPU_SHARD_INDEX set),
  byte-identical to golden_se.sam / golden_pe.sam apart from @PG.
"""

import ctypes
import os
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from bwamem2_tpu.align.seeding import encode_reads
from bwamem2_tpu.index.fmindex import FMIndex as JaxFMIndex
from bwamem2_tpu.ops import smem as jsmem
from bwamem2_tpu.ops.backend import DeviceBackend, _pad_reads
from bwamem2_tpu.ops.device_index import DeviceFMIndex as JaxDFM
from bwamem2_tpu.ops.device_index import bwt_char_occ as j_bwt_char_occ
from bwamem2_tpu.ops.device_index import occ_all4 as j_occ_all4
from bwamem2_tpu.ops.device_index import occ_one as j_occ_one
from bwamem2_tpu.ops.salookup import sa_lookup_kernel
from bwamem2_tpu.options import MemOptions as JaxMemOptions
from bwamem2_tpu.parallel.mesh import make_mesh as jax_make_mesh
from bwamem2_tpu.parallel.shard_index import (
    index_specs, shard_index as jax_shard_index, sharded_kernel,
    sharded_seed_extend_sharded_index as jax_sharded_step)
from bwamem2_tpu_torch import cli, ops
from bwamem2_tpu_torch.index.build import build_index
from bwamem2_tpu_torch.index.fmindex import FMIndex
from bwamem2_tpu_torch.index.klut import build_klut
from bwamem2_tpu_torch.io.fastq import FastxReader, read_chunk
from bwamem2_tpu_torch.native import hostrt
from bwamem2_tpu_torch.ops import smem
from bwamem2_tpu_torch.ops.backend import TorchBackend, pivot_cap
from bwamem2_tpu_torch.ops.cuda_build import CSRC
from bwamem2_tpu_torch.ops.device_index import (DeviceFMIndex,
                                                backward_ext_full,
                                                bwt_char_occ,
                                                dist_rows_ref, occ_all4,
                                                occ_one)
from bwamem2_tpu_torch.ops.entry import seed_extend_step
from bwamem2_tpu_torch.ops.seed import sa_resolve_ref
from bwamem2_tpu_torch.ops.seed_cuda import fm_table
from bwamem2_tpu_torch.options import MemOptions
from bwamem2_tpu_torch.parallel.shard_index import (
    shard_index, sharded_seed_extend_sharded_index, split_lanes,
    table_bytes)
from bwamem2_tpu_torch.utils.profiling import PROF

from conftest import DATA, FIXTURES

torch.set_num_threads(1)

PREFIX = os.path.join(FIXTURES, "ref_small.fa")
C = 24              # ROUND2_MAX_CAND
MSL1 = 20           # round 3's min length: opt.min_seed_len (19) + 1
SHARDS = [1, 2, 3]  # 1: the replicated index


@pytest.fixture(scope="module")
def jdfm():
    return JaxDFM.from_host(JaxFMIndex.load(PREFIX))


@pytest.fixture(scope="module")
def fm():
    return FMIndex.load(PREFIX)


@pytest.fixture(scope="module")
def views(fm):
    """{D: the port's index on the CPU, replicated (1) or in D shards}."""
    dfm = DeviceFMIndex.from_host(fm, "cpu")
    return {1: dfm, **{d: shard_index(dfm, ["cpu"] * d)[0] for d in (2, 3)}}


@pytest.fixture(scope="module")
def grid(fm):
    """60 reads of the SE fixture and 24 genome slices with N bases, as
    the JAX backend pads them (int8[N, L], lens int32[N])."""
    reads = read_chunk(FastxReader(os.path.join(DATA, "reads_se.fq")), None,
                       10**9)[:60]
    encs = encode_reads([r.seq for r in reads])
    rng = np.random.default_rng(7)
    for _ in range(24):
        p = int(rng.integers(0, 4000))
        s = fm.ref_string[p:p + 120].astype(np.uint8).copy()
        s[rng.integers(0, 120, 3)] = 4
        encs.append(s)
    return encs, _pad_reads(encs)


@pytest.fixture(scope="module")
def pivots(jdfm, grid):
    """The pivots of round 1 (min_intv 1) and of a re-seeding round (the
    second half of them at min_intv 3), padded to P with dead pivots, and
    JAX's forward candidates of them."""
    _, (enc, lens) = grid
    N, L = enc.shape
    npiv, px = (np.asarray(a) for a in jsmem.round1_chain_kernel(
        jdfm, jnp.asarray(enc), jnp.asarray(lens), pivot_cap(L)))
    take = np.minimum(npiv, pivot_cap(L))
    rid = np.repeat(np.arange(N, dtype=np.int32), take)
    x = px[np.arange(px.shape[1])[None, :] < take[:, None]].astype(np.int32)
    P = 2048
    ridp = np.full(P, -1, np.int32)
    ridp[:len(rid)] = rid
    xp = np.zeros(P, np.int32)
    xp[:len(x)] = x
    mi = np.ones(P, np.int64)
    mi[len(rid) // 2:len(rid)] = 3
    fwd = [np.asarray(a) for a in jsmem.round2_forward_kernel(
        jdfm, jnp.asarray(enc), jnp.asarray(ridp), jnp.asarray(xp),
        jnp.asarray(mi), C)]
    nc = np.minimum(fwd[4], C)
    piv = np.repeat(np.arange(P, dtype=np.int32), nc)
    slot = (np.arange(len(piv)) - np.repeat(np.cumsum(nc) - nc, nc))
    M = len(piv) + 7           # 7 pad lanes on the dead pivot P - 1
    piv = np.concatenate([piv, np.full(7, P - 1, np.int32)])
    slot = np.concatenate([slot, np.zeros(7)]).astype(np.int32)
    assert M > 1000
    return ridp, xp, mi, fwd, piv, slot


def t(a):
    return torch.from_numpy(np.array(a))


def same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


# ------------------------------------ plain versions vs the JAX kernels
@pytest.mark.parametrize("D", SHARDS)
def test_round1_chain_and_round3_match_jax(jdfm, views, grid, D):
    _, (enc, lens) = grid
    L = enc.shape[1]
    cap3 = L // MSL1 + 1
    want1 = jsmem.round1_chain_kernel(jdfm, jnp.asarray(enc),
                                      jnp.asarray(lens), pivot_cap(L))
    want3 = jsmem.round3_replay_kernel(jdfm, jnp.asarray(enc),
                                       jnp.asarray(lens), jnp.int64(20),
                                       jnp.int32(MSL1), cap3)
    same(smem.round1_chain_ref(views[D], t(enc), t(lens), pivot_cap(L)),
         want1)
    got3 = smem.round3_replay_ref(views[D], t(enc), t(lens), 20, MSL1, cap3)
    same(got3, want3)
    assert int(got3[0].sum()) > 100


@pytest.mark.parametrize("D", SHARDS)
def test_round2_forward_matches_jax(views, grid, pivots, D):
    _, (enc, _) = grid
    ridp, xp, mi, fwd, _, _ = pivots
    got = smem.round2_forward_ref(views[D], t(enc), t(ridp), t(xp), t(mi), C)
    same(got, fwd)


@pytest.mark.parametrize("D", SHARDS)
def test_round2_backward_and_resume_match_jax(jdfm, views, grid, pivots, D):
    _, (enc, _) = grid
    ridp, xp, mi, fwd, piv, slot = pivots
    L = enc.shape[1]
    ck, cs = fwd[1], fwd[3]
    j = [jnp.asarray(a) for a in (enc, ridp, xp, ck, cs, piv, slot, mi)]
    args = (t(enc), t(ridp), t(xp), t(ck), t(cs), t(piv), t(slot), t(mi))
    # the JAX package's two phases: 8 lockstep steps, then the survivors
    phase = jsmem.round2_backward_kernel(jdfm, *j, 8)
    got = smem.round2_backward_ref(views[D], *args, steps_max=8)
    same(got, phase)
    live = np.nonzero(np.asarray(phase[4]))[0]
    assert len(live) > 10
    lp = piv[live]
    st = [np.asarray(a)[live] for a in phase[:3]]
    want = jsmem.round2_backward_resume_kernel(
        jdfm, j[0], *(jnp.asarray(a) for a in (ridp[lp], xp[lp], mi[lp],
                                                st[0], st[1])), L - 8,
        jnp.asarray(st[2]))
    same(smem.round2_backward_resume_ref(
        views[D], t(enc), t(ridp[lp]), t(xp[lp]), t(mi[lp]), t(st[0]),
        t(st[1]), t(st[2]), L - 8), want)
    # one walk to the end per lane (the port's route) == the two phases
    full = smem.round2_backward_ref(views[D], *args)
    merged = [np.asarray(a).copy() for a in phase[:4]]
    for m, w in zip(merged, want):
        m[live] = np.asarray(w)
    same(full, merged)
    same(full, jsmem.round2_backward_kernel(jdfm, *j))


# ---------------------------------- the lane bodies as host C++
SHIM = r"""
#include "seed_stages.cuh"
#include "sa_group.cuh"
template <class V>
static long long r1(const V &f, const int8_t *enc, const int *lens, int N,
                    int L, int cap, int *npiv, int *px, int64_t *per) {
  long long total = 0;
  for (int r = 0; r < N; ++r) {
    int64_t steps = 0;
    npiv[r] = stage_round1_chain(f, enc + (int64_t)r * L, lens[r], cap,
                                 px + (int64_t)r * cap, &steps);
    per[r] = steps;
    total += steps;
  }
  return total;
}
template <class V>
static long long r3(const V &f, const int8_t *enc, const int *lens, int N,
                    int L, int64_t mx, int ml, int cap, int *nout, int *ox,
                    int *on, int64_t *os, int64_t *ok, int64_t *per) {
  long long total = 0;
  for (int r = 0; r < N; ++r) {
    const int64_t o = (int64_t)r * cap;
    int64_t steps = 0;
    nout[r] = stage_round3(f, enc + (int64_t)r * L, lens[r], mx, ml, cap,
                           ox + o, on + o, os + o, ok + o, &steps);
    per[r] = steps;
    total += steps;
  }
  return total;
}
template <class V>
static long long r2f(const V &f, const int8_t *enc, int N, int L,
                     const int *rid, const int *x, const int64_t *mi, int P,
                     int C, int *cn, int64_t *ck, int64_t *cl, int64_t *cs,
                     int *nc) {
  int64_t steps = 0;
  for (int p = 0; p < P; ++p) {
    const int64_t o = (int64_t)p * C;
    nc[p] = stage_round2_forward(f, enc, (int64_t)N * L, L, rid[p], x[p],
                                 mi[p], C, cn + o, ck + o, cl + o, cs + o,
                                 &steps);
  }
  return steps;
}
extern "C" long long h_r1(const int64_t *t, const int8_t *enc,
                          const int *lens, int N, int L, int cap, int *npiv,
                          int *px, int64_t *per) {
  return t[0] == 1
      ? r1(fm_view_of(t), enc, lens, N, L, cap, npiv, px, per)
      : r1(fm_shard_view_of(t), enc, lens, N, L, cap, npiv, px, per);
}
extern "C" long long h_r3(const int64_t *t, const int8_t *enc,
                          const int *lens, int N, int L, int64_t mx, int ml,
                          int cap, int *nout, int *ox, int *on, int64_t *os,
                          int64_t *ok, int64_t *per) {
  return t[0] == 1
      ? r3(fm_view_of(t), enc, lens, N, L, mx, ml, cap, nout, ox, on, os, ok,
           per)
      : r3(fm_shard_view_of(t), enc, lens, N, L, mx, ml, cap, nout, ox, on,
           os, ok, per);
}
extern "C" long long h_r2f(const int64_t *t, const int8_t *enc, int N, int L,
                           const int *rid, const int *x, const int64_t *mi,
                           int P, int C, int *cn, int64_t *ck, int64_t *cl,
                           int64_t *cs, int *nc) {
  return t[0] == 1
      ? r2f(fm_view_of(t), enc, N, L, rid, x, mi, P, C, cn, ck, cl, cs, nc)
      : r2f(fm_shard_view_of(t), enc, N, L, rid, x, mi, P, C, cn, ck, cl, cs,
            nc);
}
extern "C" void h_sa(const int64_t *t, const int64_t *pos, int64_t n,
                     int64_t *out) {
  const SaBatchOf<FmShardView> b{fm_shard_view_of(t), nullptr, nullptr, pos,
                                 n, out};
  SaWarp g;
  sa_group_run<1>(g, b);
}
"""


@pytest.fixture(scope="module")
def host_stages(tmp_path_factory):
    d = tmp_path_factory.mktemp("stages")
    src, so = str(d / "stages.cpp"), str(d / "stages.so")
    with open(src, "w") as f:
        f.write(SHIM)
    subprocess.run(["g++", "-O2", "-std=c++17", "-shared", "-fPIC", "-I",
                    CSRC, src, "-o", so], check=True, capture_output=True)
    lib = ctypes.CDLL(so)
    for name in ("h_r1", "h_r3", "h_r2f"):
        getattr(lib, name).restype = ctypes.c_longlong
    return lib


def _call(fn, *args):
    """fn(*args) with tensors passed as pointers, np.int64 as int64_t and
    ints as int; `args` holds the tensors alive through the call."""
    conv = []
    for a in args:
        if isinstance(a, np.int64):
            conv.append(ctypes.c_int64(int(a)))
        elif isinstance(a, int):
            conv.append(ctypes.c_int(a))
        elif isinstance(a, torch.Tensor):
            conv.append(ctypes.c_void_p(a.data_ptr()))
        else:
            conv.append(a)
    return fn(*conv)


def _chains_match_plain(lib, v, enc, lens, min_len=MSL1):
    """round1_chain's and round3_replay's bodies (host build, one read
    after another, as the kernels' threads) on the index view v ==
    round1_chain_ref and round3_replay_ref (max_intv 20), with the plain
    versions' backward_ext counts, in all and per read (`longest`,
    `longest_read`).  Returns {"r1" / "r3": (plain outputs, stats)}."""
    N, L = enc.shape
    cap, cap3 = pivot_cap(L), L // min_len + 1
    tab = fm_table(v)
    out = {}
    for kind, ref, params, got in (
            ("r1", smem.round1_chain_ref, (cap,),
             (torch.zeros(N, dtype=torch.int32),
              torch.full((N, cap), -1, dtype=torch.int32))),
            ("r3", smem.round3_replay_ref, (np.int64(20), min_len, cap3),
             (torch.zeros(N, dtype=torch.int32),
              *(torch.full((N, cap3), -1, dtype=torch.int32)
                for _ in range(2)),
              *(torch.zeros((N, cap3), dtype=torch.int64)
                for _ in range(2))))):
        st: dict = {}
        want = ref(v, enc, lens, *(int(p) for p in params), st)
        per = torch.zeros(N, dtype=torch.int64)
        steps = _call(getattr(lib, "h_" + kind), tab, enc, lens, N, L,
                      *params, *got, per)
        same(got, want)
        assert steps == st["steps"] == int(per.sum()) > 0
        assert int(per.max()) == st["longest"]
        assert int(per[st["longest_read"]]) == st["longest"]
        out[kind] = (want, st)
    return out


@pytest.mark.parametrize("D", SHARDS)
def test_lane_bodies_host_build_match_plain(host_stages, views, grid,
                                            pivots, D):
    """csrc/seed_stages.cuh (host build: round1_chain's and round3_replay's
    bodies) == the plain versions, over the replicated index (FmView) and
    over 2 and 3 shards (FmShardView), with the same step counts in all
    and per read; sa_group.cuh over FmShardView == sa_resolve_ref."""
    _, (enc, lens) = grid
    v = views[D]
    _chains_match_plain(host_stages, v, t(enc), t(lens))
    if D > 1:
        rng = np.random.default_rng(D)
        pos = t(rng.integers(0, int(v.counts[4]), 3000).astype(np.int64))
        out = torch.zeros(3000, dtype=torch.int64)
        _call(host_stages.h_sa, fm_table(v), pos, np.int64(3000), out)
        same([out], [sa_resolve_ref(views[1], pos)])


@pytest.mark.parametrize("D", SHARDS)
def test_round2_forward_host_build_match_plain(host_stages, views, grid,
                                               pivots, D):
    """csrc/seed_stages.cuh:stage_round2_forward (host build, one pivot
    after another, as round2_forward.cu's threads) == round2_forward_ref
    and JAX's round2_forward_kernel over the replicated index and 2 and 3
    shards, at C 24 and 4 (pivots over the cap), with the plain version's
    backward_ext count.  The pivots hold pad pivots (rid -1), pivots at x
    0, min_intv 3 and walks that reach an N."""
    _, (enc, _) = grid
    ridp, xp, mi, fwd, _, _ = pivots
    N, L = enc.shape
    live = ridp >= 0
    assert (~live).any() and (xp[live] == 0).any() and (mi > 1).any()
    assert (enc == 4).any()
    v = views[D]
    tab = fm_table(v)
    P = len(ridp)
    e = t(enc)
    for C_ in (C, 4):
        st: dict = {}
        want = smem.round2_forward_ref(v, e, t(ridp), t(xp), t(mi), C_, st)
        if C_ == C:
            same(want, fwd)
        else:
            assert int((want[4] > C_).sum()) > 20
        got = (torch.full((P, C_), -1, dtype=torch.int32),
               *(torch.zeros((P, C_), dtype=torch.int64) for _ in range(3)),
               torch.zeros(P, dtype=torch.int32))
        steps = _call(host_stages.h_r2f, tab, e, N, L, t(ridp), t(xp), t(mi),
                      P, C_, *got)
        same(got, want)
        assert steps == st["steps"] > 0


def test_kmer_table_matches_stepped_extension():
    """index/klut.py's table at K = 6 on ref_tiny.fa: for every K-mer, the
    bi-interval read from it (k = start[code], l = start of the reverse
    complement's code, s = size[code]) == K forward extensions from
    scratch (backward_ext_full on the RC twin, k and l swapped, as
    round1_chain_ref steps); s alone where it is 0."""
    fm = FMIndex.load(os.path.join(FIXTURES, "ref_tiny.fa"))
    K, start, size = build_klut(fm, 6)
    dfm = DeviceFMIndex.from_host(fm, "cpu", (K, start, size))
    code = torch.arange(4 ** K)
    base = [(code >> (2 * (K - 1 - i))) & 3 for i in range(K)]
    rc = sum((3 - base[i]) << (2 * i) for i in range(K))
    k, l, s = smem._start(dfm.counts, base[0])
    for c in base[1:]:
        l, k, s = backward_ext_full(dfm, l, k, s, 3 - c)
    assert torch.equal(s, dfm.lut_size)
    occ = s > 0
    assert 0 < int(occ.sum()) < 4 ** K
    assert torch.equal(k[occ], dfm.lut_start[occ])
    assert torch.equal(l[occ], dfm.lut_start[rc][occ])


def _exit_genome(tmp_path_factory):
    """A genome over A, C, G (so a 6-mer with both A and T occurs on
    neither strand): 30 copies of a 250 bp element between random spacers,
    then 3,000 random bases; its index on the CPU, and reads that reach
    each exit of the chain bodies (a name each): the element (its interval
    stays at 30 rows, above round 3's max_intv, to the read's end: the
    longest chain), the doubled text's last 40 codes then A's (the text's
    end), 120 codes across the forward / reverse-complement boundary, an
    absent 6-mer at a read's start and inside one (segments that die on
    an empty interval, then followed by an N or the read's end before
    round 3's least length), Ns inside a segment, an N in round 3's second
    segment, and unique reads."""
    rng = np.random.default_rng(11)
    elem = rng.integers(0, 3, 250)
    parts = []
    for _ in range(30):
        parts += [rng.integers(0, 3, int(rng.integers(60, 140))), elem]
    g = np.concatenate(parts + [rng.integers(0, 3, 3000)])
    d = tmp_path_factory.mktemp("exits")
    fa = str(d / "exits.fa")
    with open(fa, "w") as f:
        f.write(">exits\n")
        s = "".join("ACGT"[c] for c in g)
        f.write("".join(s[i:i + 80] + "\n" for i in range(0, len(s), 80)))
    build_index(fa, fa, verbose=False)
    fm = FMIndex.load(fa)
    text = fm.ref_string.astype(np.int8)
    n, lp = len(text), fm.l_pac
    absent = np.array([0, 0, 3, 3, 0, 0], np.int8)     # AATTAA
    u = len(g) - 3000                                  # the unique tail
    cat = lambda *a: np.concatenate([np.asarray(x, np.int8) for x in a])  # noqa
    with_n = text[u + 100:u + 250].copy()
    with_n[[2, 70]] = 4
    r3_n = text[u + 400:u + 550].copy()
    r3_n[30] = 4
    reads = {"element": elem[20:170], "text_end": cat(text[n - 40:],
                                                       np.zeros(30)),
             "boundary": text[lp - 60:lp + 60],
             "absent_start": cat(absent, text[u + 600:u + 700]),
             "absent_inside": cat(text[u + 800:u + 850], absent,
                                  text[u + 900:u + 950]),
             "n_in_kmer": with_n, "r3_n": r3_n,
             "unique": text[u + 1200:u + 1350],
             "repeat_then_unique": cat(elem[150:250],
                                       text[u + 1500:u + 1550]),
             "absent_then_n": cat(absent, [1, 2, 1], [4],
                                  text[u + 2000:u + 2100]),
             "absent_at_end": cat(text[u + 2200:u + 2290], absent,
                                  [2, 1])}
    return fa, fm, reads


@pytest.fixture(scope="module")
def exit_index(tmp_path_factory):
    fa, fm, reads = _exit_genome(tmp_path_factory)
    dfm = DeviceFMIndex.from_host(fm, "cpu")
    names = list(reads)
    enc, lens = _pad_reads([reads[k].astype(np.uint8) for k in names])
    return fa, dfm, names, enc, lens


def test_chain_exits_plain_match_jax(exit_index):
    """round1_chain_ref and round3_replay_ref == JAX's round1_chain_kernel
    and round3_replay_kernel on the exit genome's reads."""
    fa, dfm, _, enc, lens = exit_index
    jd = JaxDFM.from_host(JaxFMIndex.load(fa))
    L = enc.shape[1]
    cap, cap3 = pivot_cap(L), L // MSL1 + 1
    same(smem.round1_chain_ref(dfm, t(enc), t(lens), cap),
         jsmem.round1_chain_kernel(jd, jnp.asarray(enc), jnp.asarray(lens),
                                   cap))
    same(smem.round3_replay_ref(dfm, t(enc), t(lens), 20, MSL1, cap3),
         jsmem.round3_replay_kernel(jd, jnp.asarray(enc), jnp.asarray(lens),
                                    jnp.int64(20), jnp.int32(MSL1), cap3))


@pytest.mark.parametrize("D", SHARDS)
def test_chain_exits_host_build_match_plain(host_stages, exit_index, D):
    """The round-1 and round-3 bodies (host build) == the plain versions
    on the exit genome's reads, replicated and over 2 and 3 shards, at
    round 3's min_len 20 and 50, with the step counts in all and per read;
    and each exit was taken: segments die on the absent 6-mer's empty
    interval and restart after an N, round 3 stops at an N, and the
    element's read takes the longest round-3 chain (one segment to the
    read's end)."""
    _, dfm, names, enc, lens = exit_index
    v = dfm if D == 1 else shard_index(dfm, ["cpu"] * D)[0]
    e, ln = t(enc), t(lens)
    at = {k: i for i, k in enumerate(names)}
    out = _chains_match_plain(host_stages, v, e, ln)
    (npiv, px), _ = out["r1"]
    assert px[at["absent_start"]][:3].tolist() == [0, 2, 4]
    assert 3 in px[at["n_in_kmer"]].tolist()
    (nout, ox, on, _, _), st3 = out["r3"]
    assert st3["longest_read"] == at["element"]
    assert int(nout[at["element"]]) == 0
    r = at["r3_n"]
    assert 31 in ox[r][:int(nout[r])].tolist()
    _chains_match_plain(host_stages, v, e, ln, min_len=50)


# ------------- round 2's backward body (refilled lanes)
GROUP_SHIM = r"""
static long long g_steps = 0;
#define R2B_STEP_HOOK() (++g_steps)
#include "r2b_group.cuh"
template <class V>
static void r2b(const R2bBatch<V> &b, const int64_t *perm) {
  SaWarp g;
  g.perm = perm;
  r2b_group_run(g, b);
}
extern "C" long long h_r2b(const int64_t *t, const int8_t *enc, int N,
                           int L, const int *rid, const int *x,
                           const int64_t *mi, const int64_t *ck,
                           const int64_t *cs, int C, const int *piv,
                           const int *slot, const int *col0,
                           const int64_t *k0, const int64_t *s0, int M,
                           int n_steps, const int64_t *perm, int *col,
                           int64_t *k, int64_t *s, bool *died, bool *alive) {
  g_steps = 0;
  const int64_t NL = (int64_t)N * L;
  if (t[0] == 1)
    r2b(R2bBatch<FmView>{fm_view_of(t), enc, NL, L, rid, x, mi, ck, cs, C,
                         piv, slot, col0, k0, s0, M, n_steps, col, k, s,
                         died, alive}, perm);
  else
    r2b(R2bBatch<FmShardView>{fm_shard_view_of(t), enc, NL, L, rid, x, mi,
                              ck, cs, C, piv, slot, col0, k0, s0, M, n_steps,
                              col, k, s, died, alive}, perm);
  return g_steps;
}
"""


@pytest.fixture(scope="module")
def host_groups(tmp_path_factory):
    d = tmp_path_factory.mktemp("groups")
    src, so = str(d / "groups.cpp"), str(d / "groups.so")
    with open(src, "w") as f:
        f.write(GROUP_SHIM)
    subprocess.run(["g++", "-O2", "-std=c++17", "-shared", "-fPIC", "-I",
                    CSRC, src, "-o", so], check=True, capture_output=True)
    lib = ctypes.CDLL(so)
    lib.h_r2b.restype = ctypes.c_longlong
    return lib


def _perms(rng, n):
    """Two ticket orders over n items: a random permutation and the
    reversed order."""
    return [t(rng.permutation(n).astype(np.int64)),
            t(np.arange(n - 1, -1, -1, dtype=np.int64))]


@pytest.mark.parametrize("D", SHARDS)
def test_round2_backward_refill_host_build_match_plain(host_groups, views,
                                                       grid, pivots, D):
    """csrc/r2b_group.cuh (host build, a warp of 32 lanes in lockstep, one
    walk a lane) == round2_backward_ref at n_steps 8 and L and
    round2_backward_resume_ref on the lanes alive after 8 steps, over the
    replicated index and 2 and 3 shards, under two permuted ticket orders
    and the identity, with the plain versions' LF step counts."""
    _, (enc, _) = grid
    ridp, xp, mi, fwd, piv, slot = pivots
    v = views[D]
    tab = fm_table(v)
    N, L = enc.shape
    M = len(piv)
    e = t(enc)
    rng = np.random.default_rng(30 + D)
    none = ctypes.c_void_p(None)

    def outputs(n):
        return (torch.zeros(n, dtype=torch.int32),
                *(torch.zeros(n, dtype=torch.int64) for _ in range(2)),
                *(torch.zeros(n, dtype=torch.bool) for _ in range(2)))

    for n_steps in (8, 0):
        st: dict = {}
        want = smem.round2_backward_ref(v, e, t(ridp), t(xp), t(fwd[1]),
                                        t(fwd[3]), t(piv), t(slot), t(mi),
                                        n_steps, st)
        for perm in _perms(rng, M) + [none]:
            got = outputs(M)
            steps = _call(host_groups.h_r2b, tab, e, N, L, t(ridp), t(xp),
                          t(mi), t(fwd[1]), t(fwd[3]), C, t(piv), t(slot),
                          none, none, none, M, n_steps or L, perm, *got)
            same(got if n_steps else got[:4], want)
            assert steps == st["steps"] > 0
        if n_steps:
            phase = want
    live = np.nonzero(phase[4].numpy())[0]
    assert 10 < len(live) < M
    lp = piv[live]
    res = [t(a) for a in (ridp[lp], xp[lp], mi[lp])] + \
        [p[live] for p in phase[:3]]
    st = {}
    want = smem.round2_backward_resume_ref(v, e, *res, L - 8, st)
    for perm in _perms(rng, len(live)) + [none]:
        got = outputs(len(live))
        steps = _call(host_groups.h_r2b, tab, e, N, L, *res[:3], none,
                      none, 0, none, none, *res[3:], len(live), L - 8, perm,
                      *got)
        same(got[:4], want)
        assert steps == st["steps"] > 0


# --------------------- row fetch and SA walks vs JAX's sharded kernels
@pytest.fixture(scope="module")
def jmesh():
    if len(jax.devices()) < 8:
        pytest.skip("needs the virtual 8-device CPU mesh")
    return jax_make_mesh(8)


@pytest.mark.parametrize("D", [3, 8])
def test_dist_rows_match_jax_sharded_kernels(fm, jdfm, jmesh, D):
    rng = np.random.default_rng(0)
    n = 4096
    pos = rng.integers(0, 2 * fm.l_pac, n).astype(np.int64)
    c = rng.integers(0, 4, n).astype(np.int32)
    sj = jax_shard_index(jmesh, jdfm)
    spec = index_specs(sj)
    pj, cj = jnp.asarray(pos), jnp.asarray(c)
    want_all4 = sharded_kernel(jmesh, j_occ_all4, spec, 1)(sj, pj)
    want_bc = sharded_kernel(jmesh, j_bwt_char_occ, spec, 1,
                             out_specs=(JP("data"), JP("data")))(sj, pj)
    want_one = sharded_kernel(jmesh, j_occ_one, spec, 2)(sj, pj, cj)
    want_sa = sharded_kernel(jmesh, sa_lookup_kernel, spec, 1)(
        sj, pj[:2048])
    v = shard_index(DeviceFMIndex.from_host(fm, "cpu"), ["cpu"] * D)[0]
    assert len(v.shards.occp) == D
    assert v.shards.rows * D >= v.nblocks > v.shards.rows * (D - 1)
    same([occ_all4(v, t(pos))], [want_all4])
    same(bwt_char_occ(v, t(pos)), want_bc)
    same([occ_one(v, t(pos), t(c))], [want_one])
    same([sa_resolve_ref(v, t(pos[:2048]))], [want_sa])
    # the plain fetch: each shard's rows where the ids fall, summed
    ids = t(rng.integers(0, v.nblocks, 500).astype(np.int64))
    dfm = DeviceFMIndex.from_host(fm, "cpu")
    same([dist_rows_ref(v.shards.occp, ids)], [dfm.occp[ids]])
    same([dist_rows_ref(v.shards.sa_ls, ids)], [dfm.sa_ls[ids]])


def test_sharded_step_matches_jax_and_replicated(fm, jdfm, jmesh):
    rng = np.random.default_rng(2)
    n, L = 32, 128
    enc = np.full((n, L), 4, np.int32)
    lens = np.full((n,), L, np.int32)
    for i in range(n):
        p = int(rng.integers(0, fm.l_pac - L))
        enc[i] = fm.ref_string[p:p + L]
        mut = rng.integers(0, L, 3)
        enc[i, mut] = (enc[i, mut] + 1) % 4
    want = jax_sharded_step(jmesh, jdfm, enc, lens)
    dfm = DeviceFMIndex.from_host(fm, "cpu")
    got = sharded_seed_extend_sharded_index(["cpu"] * 2, dfm, enc, lens)
    same(got, want)
    same(got, [x.numpy() for x in seed_extend_step(dfm, enc, lens)])


def test_shard_layout_and_bytes(fm):
    dfm = DeviceFMIndex.from_host(fm, "cpu")
    vs = shard_index(dfm, ["cpu"] * 3)
    assert vs[0] is vs[1] is vs[2] and vs[0].occp is None
    sh = vs[0].shards
    assert [x.shape[0] for x in sh.occp] == [sh.rows] * 3
    assert torch.equal(torch.cat(sh.occp)[:dfm.occp.shape[0]], dfm.occp)
    assert torch.equal(torch.cat(sh.sa_ms)[:dfm.sa_ms.shape[0]], dfm.sa_ms)
    assert not bool(torch.cat(sh.occp)[dfm.occp.shape[0]:].any())
    total = sum(table_bytes(vs).values())
    tabs = (dfm.occp, dfm.sa_ms, dfm.sa_ls)
    assert total >= sum(x.numel() * x.element_size() for x in tabs)
    with pytest.raises(ValueError, match="1 to 8"):
        shard_index(dfm, ["cpu"] * 9)


def test_split_lanes_slices_and_tally(views):
    """Card i gets the i-th slice of the lanes and the shared inputs whole,
    from its own thread with the caller's tally; outputs in order."""
    from bwamem2_tpu_torch.ops import cuda_build
    vs = shard_index(views[1], ["cpu"] * 3)
    seen = []
    tally: dict = {}
    cuda_build.launch_tally(tally)
    try:
        out = split_lanes(vs, lambda v, sh, a: (
            seen.append((cuda_build.current_tally() is tally, sh.numel(),
                         a.numel())) or (a * 2,)),
            (torch.arange(9),), (torch.zeros(4),))
    finally:
        cuda_build.launch_tally(None)
    assert seen == [(True, 4, 3)] * 3
    same(out, [torch.arange(9) * 2])
    with pytest.raises(ValueError, match="split"):
        split_lanes(vs, lambda v, a: (a,), (torch.arange(4),))


# ------------------------------------- the sharded backend end to end
def drop_l(per_read):
    return [[(x[0], x[1], x[2], x[3], x[5]) for x in r] for r in per_read]


@pytest.fixture(scope="module")
def jax_backend():
    return DeviceBackend(JaxFMIndex.load(PREFIX), JaxMemOptions().finalize())


def test_collect_smems_matches_jax_backend(fm, grid, jax_backend):
    encs, _ = grid
    opt = MemOptions().finalize()
    be = TorchBackend(fm, opt, devices=["cpu"] * 2, sharded=True)
    assert be.collect_chunk(encs, opt) is None
    n = {k: (k.plain_calls, k.launches) for k in (
        smem.round1_chain, smem.round2_forward, smem.round2_backward,
        smem.round3_replay)}
    got = be.collect_smems(encs, opt)
    want = jax_backend.collect_smems(encs, JaxMemOptions().finalize())
    assert drop_l(got) == drop_l(want)
    assert sum(map(len, got)) > 400
    # every stage ran its plain version on each of the two "cards"
    for k, (p0, l0) in n.items():
        assert k.plain_calls >= p0 + 2 and k.launches == l0, k.NAME
    assert be.launches == {}
    # and the host oracle agrees
    assert drop_l(got) == drop_l(hostrt.collect_smems_reads(fm, encs, opt))
    pos = np.random.default_rng(3).integers(0, fm.ref_seq_len, 1001)
    np.testing.assert_array_equal(be.sa_lookup(pos),
                                  hostrt.sa_entries_host(fm, pos))


def test_three_reads_over_two_shards(fm, grid):
    """A chunk of 3 reads: the grid is padded to 4 rows over 2 shards, and
    the pad row emits nothing."""
    encs, _ = grid
    opt = MemOptions().finalize()
    be = TorchBackend(fm, opt, devices=["cpu"] * 2, sharded=True)
    seen = []
    orig = smem.Round1Chain.__call__

    def spy(self, dfm, enc, lens, cap):
        out = orig(self, dfm, enc, lens, cap)
        seen.append((enc.shape[0], lens.tolist(), out[0].tolist()))
        return out

    smem.Round1Chain.__call__ = spy
    try:
        got = be.collect_smems(encs[:3], opt)
    finally:
        smem.Round1Chain.__call__ = orig
    assert len(got) == 3
    assert drop_l(got) == drop_l(hostrt.collect_smems_reads(fm, encs[:3],
                                                            opt))
    assert sorted(s[:2] for s in seen) == [(2, [101, 0]), (2, [102, 101])]
    pad = next(s for s in seen if s[1][1] == 0)
    assert pad[2][1] == 0                   # the pad read has no pivot


def golden_body(name):
    with open(os.path.join(FIXTURES, name)) as f:
        return [ln for ln in f if not ln.startswith("@")]


@pytest.mark.parametrize("D", [2, 3])
@pytest.mark.parametrize("pe", [False, True], ids=["se", "pe"])
def test_cli_mem_sharded_index_golden(tmp_path, monkeypatch, capfd, D, pe):
    """`mem` with BWAMEM2_TPU_SHARD_INDEX over D devices builds one sharded
    backend (CPU stand-ins for cards), seeds on the per-stage path and
    writes the golden SAM."""
    made = []
    orig = TorchBackend.__init__

    def spy(self, *args, **kw):
        made.append(kw)
        orig(self, *args, **kw)

    monkeypatch.setattr(TorchBackend, "__init__", spy)
    monkeypatch.setattr(ops, "resolve_devices",
                        lambda dev: [torch.device("cpu")] * D)
    monkeypatch.setenv("BWAMEM2_TPU_SHARD_INDEX", "1")
    n_r1 = smem.round1_chain.plain_calls
    out = str(tmp_path / "out.sam")
    fq = ([os.path.join(DATA, "reads_r1.fq"), os.path.join(DATA,
                                                           "reads_r2.fq")]
          if pe else [os.path.join(DATA, "reads_se.fq")])
    assert cli.main(["mem", "--device", "cpu", "-v", "3", "-o", out, PREFIX,
                     *fq]) == 0
    assert made == [dict(devices=[torch.device("cpu")] * D, sharded=True)]
    assert f"index sharded over {D} cards" in capfd.readouterr().err
    assert smem.round1_chain.plain_calls > n_r1
    with open(out) as f:
        ours = [ln for ln in f if not ln.startswith("@")]
    assert ours == golden_body("golden_pe.sam" if pe else "golden_se.sam")
    assert PROF.c["overflow.r1_pivot_cap"] == 0


# ----------------------------------------------- wrappers off the card
@pytest.mark.parametrize("kernel", [smem.round1_chain, smem.round2_forward,
                                    smem.round2_backward, smem.round3_replay],
                         ids=lambda k: k.NAME)
def test_stage_wrappers_refuse_cpu_launch(views, kernel):
    """The CPU runs the plain version only through __call__; the launch
    itself takes CUDA tensors or raises."""
    e = torch.zeros((2, 8), dtype=torch.int8)
    n_args = {"round1_chain": 2, "round2_forward": 4, "round3_replay": 4,
              "round2_backward": 7}[kernel.NAME]
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        kernel.launch(views[2], e, *[None] * n_args)


def test_sharded_backend_without_a_card_or_peer_raises(fm, monkeypatch):
    """A sharded backend on cuda with no card raises, and so does peer
    access that cannot be enabled: there is no fallback to the CPU or to
    copying the tables."""
    from bwamem2_tpu_torch.parallel import shard_index as si
    opt = MemOptions().finalize()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        TorchBackend(fm, opt, devices=["cuda:0", "cuda:1"], sharded=True)
    with pytest.raises(ValueError, match="needs its devices"):
        TorchBackend(fm, opt, sharded=True)

    class NoPeer:
        def peer_enable(self, a, b):
            return 217              # cudaErrorPeerAccessUnsupported

    monkeypatch.setattr(si.PEER, "lib", lambda: NoPeer())
    with pytest.raises(RuntimeError, match="peer_enable.*217"):
        si.enable_peers([0, 1])
    with pytest.raises(ValueError, match="all on the CPU or all on cards"):
        monkeypatch.setattr(si, "resolve_device", torch.device)
        shard_index(DeviceFMIndex.from_host(fm, "cpu"), ["cpu", "cuda:0"])


def test_wide_candidate_tier_keeps_output(fm, grid, monkeypatch):
    """A pivot with more forward candidates than ROUND2_MAX_CAND runs
    again at width L on the device (seeding.cand_wide*) and walks from the
    resume entry; here a cap of 3 sends most pivots there, and the SMEMs
    still equal the host oracle's."""
    from bwamem2_tpu_torch.ops import backend
    encs, _ = grid
    opt = MemOptions().finalize()
    monkeypatch.setattr(backend, "ROUND2_MAX_CAND", 3)
    be = TorchBackend(fm, opt, devices=["cpu"] * 2, sharded=True)
    c0 = (PROF.c["seeding.cand_wider1"], PROF.ctot["seeding.cand_wider1"])
    n_resume = smem.round2_backward.plain_calls
    got = be.collect_smems(encs, opt)
    assert drop_l(got) == drop_l(hostrt.collect_smems_reads(fm, encs, opt))
    wide = PROF.c["seeding.cand_wider1"] - c0[0]
    assert 0.3 < wide / (PROF.ctot["seeding.cand_wider1"] - c0[1]) < 1
    assert smem.round2_backward.plain_calls >= n_resume + 4

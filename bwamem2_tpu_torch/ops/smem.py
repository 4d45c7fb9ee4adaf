"""The SMEM stages as separate device calls: plain versions and kernels.

  round1_walk     the round-1 walk from every (read, end) lane
                  (csrc/round1_walk.cu), the fused seed-extend step's
                  first stage;
  round1_compact  the same walk (from the K-mer table where it applies),
                  the SMEM emission rule and the per-read compaction in
                  one launch (csrc/round1_compact.cu): round 1 of the
                  legacy configuration, TorchBackend(pivot_seeding=False);
  round1_chain    round 1's pivot chain, one thread per read
                  (csrc/round1_chain.cu);
  round2_forward  per pivot, the forward candidates, one thread a pivot
                  (csrc/round2_forward.cu);
  round2_backward per candidate lane, the backward walk, from the forward
                  pass's candidate slot or resumed from a given state,
                  lanes refilled as walks end (csrc/round2_backward.cu);
  round3_replay   round 3's pivot chain under max_mem_intv, one thread
                  per read (csrc/round3_replay.cu).

The last four are the per-stage seeding of the sharded index
(ops/backend.py:TorchBackend.collect_smems, the counterpart of
bwamem2_tpu/ops/backend.py:collect_smems); the replicated index seeds
through the fused smem_collect (ops/seed.py) instead.  Each plain version
(`*_ref`) steps its lanes in lockstep as the JAX kernel of the same name
in bwamem2_tpu/ops/smem.py does and returns its arrays value for value
(int32 where the JAX kernel returns int16); each wrapper runs it on CPU
tensors and launches its kernel on CUDA tensors, or raises.  The kernels'
bodies (csrc/seed_stages.cuh's and round 2's backward r2b_group.cuh)
compile as host C++ in the tests.  If `stats` is a dict, a plain version
stores in it the LF steps or backward extensions its lanes took (`steps`,
each reading two occ rows) and the distinct occ rows they read (`rows`):
the kernel's work on these inputs; the steps whose interval's two ends
lie in one 64-character block (`one_block`), those at s = 1 (`single`:
one occ row and one count in the round-1 walk, fm_occ.cuh:
fm_walk_single), those at s = 1 that empty the interval (`single_empty`:
no count; counted where the plain version passes the new size) and those
at s > 1 in one block (`wide_one_block`), the classes of the round-1
walk's bound; also the steps of its longest walk or
chain (`longest`: a kernel thread's dependent loads) and, for the
round-1 and round-3 chains, the read that takes them (`longest_read`).

The round-1 walk:

For every end column n of a read, one lane walks the FM index backward
from n until the interval empties (bwamem2_tpu/ops/smem.py:round1_kernel /
_round1_walk at lut_k = 0), yielding the leftmost start b(n) and the
interval (k, s) of [b(n), n]; the round-1 SMEMs are exactly the [b(n), n]
with b(n) < b(n + 1).  `ops/entry.py:seed_extend_step` takes each read's
longest.  The JAX version's int32 variant is not ported: int64 is exact
for every genome.  Its K-mer jump start (lut_k > 0, index/klut.py) is:
round1_walk_ref(..., K) and round1_compact start a lane from its
K-mer's interval where the K codes ending at its column are bases and
the K-mer occurs; round1_walk (the step's kernel) walks from scratch.

`round1_walk(dfm, enc, lens)` and `round1_compact(dfm, enc, lens, K,
min_seed_len, cap)` are the wrappers: CPU tensors run the plain version
(`round1_walk_ref`, `round1_compact_ref`), CUDA tensors launch the kernel
or raise.
"""

from __future__ import annotations

import ctypes

import torch

from .cuda_build import I32, I64, VP, CudaKernel, check_tensors
from .device_index import (DeviceFMIndex, backward_ext_full, lf_step,
                           take_counts)
from .seed_cuda import _check_index, fm_table


class _Work:
    """The steps of a plain version's lanes and the distinct occ rows they
    read, stored into `stats` (a dict, or None: nothing is counted).  With
    `lockstep` (every live lane takes one step per add(), as in
    round2_forward_ref and _bwd_walk) also the steps of the longest walk
    (`longest`, the add() calls); with `lanes` (add() names the lanes that
    step, as in _chains) the most steps of one lane (`longest`) and that
    lane (`longest_read`)."""

    def __init__(self, dfm: DeviceFMIndex, stats: dict | None, dev,
                 lockstep: bool = False, lanes: int = 0):
        self.stats = stats
        self.steps = 0
        self.one_block = 0
        self.single = 0
        self.single_empty = 0
        self.wide_one_block = 0
        self.calls = 0
        self.lockstep = lockstep
        self.per = (torch.zeros(lanes, dtype=torch.int64, device=dev)
                    if stats is not None and lanes else None)
        self.touched = (None if stats is None else
                        torch.zeros(dfm.nblocks, dtype=torch.bool,
                                    device=dev))

    def add(self, k: torch.Tensor, s: torch.Tensor,
            lanes: torch.Tensor | None = None,
            s2: torch.Tensor | None = None) -> None:
        if self.stats is not None:
            self.steps += k.numel()
            one = (k >> 6) == ((k + s) >> 6)
            self.one_block += one.sum()
            self.single += (s == 1).sum()
            if s2 is not None:
                self.single_empty += ((s == 1) & (s2 <= 0)).sum()
            self.wide_one_block += (one & (s > 1)).sum()
            self.calls += 1
            self.touched[k >> 6] = True
            self.touched[(k + s) >> 6] = True
            if self.per is not None:
                self.per[lanes] += 1

    def done(self) -> None:
        if self.stats is not None:
            self.stats.update(steps=self.steps,
                              one_block=int(self.one_block),
                              single=int(self.single),
                              single_empty=int(self.single_empty),
                              wide_one_block=int(self.wide_one_block),
                              rows=int(self.touched.sum()))
            if self.lockstep:
                self.stats["longest"] = self.calls
            if self.per is not None:
                self.stats.update(longest=int(self.per.max()),
                                  longest_read=int(self.per.argmax()))


def _lut_start(dfm: DeviceFMIndex, enc: torch.Tensor, valid: torch.Tensor,
               K: int):
    """The lanes the K-mer table starts (bwamem2_tpu/ops/smem.py:
    _round1_walk, lut_k > 0): a valid lane whose K codes ending at its
    column are bases (column >= K - 1) and whose K-mer occurs.  Returns
    (use bool[N, L], code int64[N, L]); code = sum of base(n - i) << 2i."""
    N, L = enc.shape
    if dfm.lut_depth != K or dfm.lut_start is None:
        raise ValueError(f"round1 walk at K={K}: the index carries a K-mer "
                         f"table of depth {dfm.lut_depth}")
    code = torch.zeros_like(enc)
    clean = valid & (torch.arange(L, device=enc.device) >= K - 1)
    for i in range(K):
        c = torch.nn.functional.pad(enc, (i, 0), value=4)[:, :L]  # n - i
        clean = clean & (c < 4)
        code = code | ((c & 3) << (2 * i))
    code = torch.where(clean, code, 0)
    return clean & (dfm.lut_size[code] > 0), code


def round1_walk_ref(dfm: DeviceFMIndex, enc: torch.Tensor,
                    lens: torch.Tensor, stats: dict | None = None,
                    K: int = 0):
    """Plain version: enc int[N, L] codes (4 = N or padding), lens
    int32[N] -> (b int32[N, L], k int64[N, L], s int64[N, L]).  A lane
    whose code is not a base or that lies past its read gets b = n + 1 and
    the interval of base 0.  Only live lanes are stepped.  With K > 0
    (the index's K-mer table, dfm.lut_depth), a lane _lut_start picks
    starts from its K-mer's interval with b = n - K + 1 and walks on from
    column n - K.  If `stats` is a dict, the LF steps the walks took
    (`steps`, the step that empties an interval included), the distinct
    occ rows they read (`rows`) and the distinct table entries read
    (`lut_rows`) are stored in it: the kernel's work on these inputs."""
    dev = enc.device
    N, L = enc.shape
    enc = enc.long()
    pos = torch.arange(L, device=dev).expand(N, L)
    valid = (enc >= 0) & (enc < 4) & (pos < lens.long()[:, None])
    a0 = torch.where(valid, enc, 0)
    k = take_counts(dfm.counts, a0)
    s = take_counts(dfm.counts, a0, 1) - k
    b = torch.where(valid, pos, pos + 1)
    skip = torch.zeros_like(pos)    # columns the start covers beyond n
    lut_rows = 0
    if K:
        use, code = _lut_start(dfm, enc, valid, K)
        k = torch.where(use, dfm.lut_start[code], k)
        s = torch.where(use, dfm.lut_size[code], s)
        b = torch.where(use, pos - K + 1, b)
        skip = torch.where(use, K - 1, 0)
        lut_rows = int(torch.unique(code[use]).numel())
    lane = valid.reshape(-1).nonzero()[:, 0]      # live lanes, flat
    k, s, b = k.reshape(-1), s.reshape(-1), b.reshape(-1)
    flat = enc.reshape(-1)
    work = _Work(dfm, stats, dev)
    col = lane % L - skip.reshape(-1)[lane]
    while lane.numel():
        col = col - 1
        keep = col >= 0
        lane, col = lane[keep], col[keep]
        c = flat[lane - (lane % L) + col]
        keep = c < 4
        lane, col, c = lane[keep], col[keep], c[keep]
        if not lane.numel():
            break
        kk, ss = k[lane], s[lane]
        k2, s2 = lf_step(dfm, kk, ss, c)
        work.add(kk, ss, s2=s2)
        ext = s2 > 0
        lane, col = lane[ext], col[ext]
        k[lane], s[lane], b[lane] = k2[ext], s2[ext], col
    work.done()
    if stats is not None:
        stats["lut_rows"] = lut_rows
    return (b.reshape(N, L).to(torch.int32), k.reshape(N, L),
            s.reshape(N, L))


def round1_compact_ref(dfm: DeviceFMIndex, enc: torch.Tensor,
                       lens: torch.Tensor, K: int, min_seed_len: int,
                       cap: int, stats: dict | None = None):
    """Round 1 of the legacy seeding (bwamem2_tpu/ops/smem.py:
    round1_compact_kernel): round1_walk_ref at depth K, then column n of a
    read emits [b(n), n] when b(n) <= n, b(n) < b(n + 1) (where n + 1 >=
    len, always), n - b(n) + 1 >= min_seed_len and n < len.  Returns cnt
    int32[N] (the true emit count: more than cap routes the read to the
    host) and, in cap slots per read in ascending n, n, b int32 (-1 past
    cnt), s int32 (clamped to 2^31 - 1; 0 past cnt) and k int64 (0 past
    cnt): the JAX kernel's values, int32 where it returns int16.  `stats`
    as round1_walk_ref's."""
    dev = enc.device
    N, L = enc.shape
    b, k, s = round1_walk_ref(dfm, enc, lens, stats, K)
    b = b.long()
    pos = torch.arange(L, device=dev).expand(N, L)
    ln = lens.long()[:, None]
    bnext = torch.cat([b[:, 1:], torch.full((N, 1), L + 1, device=dev)], 1)
    bnext = torch.where(pos + 1 >= ln, L + 1, bnext)
    emit = ((b <= pos) & (b < bnext) & (pos - b + 1 >= min_seed_len)
            & (pos < ln))
    cnt = emit.sum(1)
    # the emitting columns first, in ascending n (a stable sort)
    order = torch.sort((~emit).to(torch.int8), dim=1, stable=True).indices
    order = order[:, :cap]
    if order.shape[1] < cap:
        order = torch.nn.functional.pad(order, (0, cap - order.shape[1]))
    ok = torch.arange(cap, device=dev)[None, :] < cnt[:, None]
    take = lambda a: torch.gather(a, 1, order)  # noqa: E731
    return (cnt.to(torch.int32),
            torch.where(ok, order, -1).to(torch.int32),
            torch.where(ok, take(b), -1).to(torch.int32),
            torch.where(ok, take(s).clamp(max=2**31 - 1), 0).to(torch.int32),
            torch.where(ok, take(k), 0))


class Round1Walk(CudaKernel):
    """round1_walk(dfm, enc int8[N, L], lens int32[N]) -> (b int32[N, L],
    k int64[N, L], s int64[N, L]), as round1_walk_ref: one thread per
    (read, end) lane."""

    NAME = "round1_walk"
    SOURCES = ("round1_walk.cu", "fm_occ.cuh")
    SIGNATURE = ("round1_walk_launch", [VP, VP, VP, I32, I32, VP, VP, VP, VP])

    def __call__(self, dfm, enc, lens):
        if enc.device.type == "cpu":
            self._plain()
            return round1_walk_ref(dfm, enc, lens)
        return self.launch(dfm, enc, lens)

    def launch(self, dfm, enc, lens):
        dev = enc.device
        if dev.type != "cuda":
            raise ValueError(f"round1_walk kernel needs CUDA tensors, got "
                             f"{dev}")
        _check_index("round1_walk", dfm, dev)
        check_tensors("round1_walk", dev, enc=(enc, torch.int8, 2),
                      lens=(lens, torch.int32, 1))
        N, L = enc.shape
        if lens.shape[0] != N:
            raise ValueError(f"round1_walk: {lens.shape[0]} lengths for {N} "
                             "reads")
        if N * L >= 1 << 31:
            raise ValueError(f"round1_walk: {N} x {L} lanes, the grid takes "
                             "fewer than 2^31")
        b = torch.empty((N, L), dtype=torch.int32, device=dev)
        k = torch.empty((N, L), dtype=torch.int64, device=dev)
        s = torch.empty((N, L), dtype=torch.int64, device=dev)
        if N * L:
            self._launch(dev, fm_table(dfm), enc.data_ptr(),
                         lens.data_ptr(), N, L, b.data_ptr(), k.data_ptr(),
                         s.data_ptr())
        return b, k, s


round1_walk = Round1Walk()


class Round1Compact(CudaKernel):
    """round1_compact(dfm, enc int8[N, L], lens int32[N], K, min_seed_len,
    cap) -> (cnt int32[N], n, b, s int32[N, cap], k int64[N, cap]), as
    round1_compact_ref: one warp per read, K > 0 starting lanes from the
    index's K-mer table (which must have depth K)."""

    NAME = "round1_compact"
    SOURCES = ("round1_compact.cu", "round1_compact.cuh", "smem_group.cuh",
               "fm_occ.cuh")
    SIGNATURE = ("round1_compact_launch",
                 [VP, VP, VP, I32, I32, I32, I32, I32, VP, VP, VP, VP, VP,
                  VP])

    def __call__(self, dfm, enc, lens, K: int, min_seed_len: int, cap: int):
        if enc.device.type == "cpu":
            self._plain()
            return round1_compact_ref(dfm, enc, lens, K, min_seed_len, cap)
        return self.launch(dfm, enc, lens, K, min_seed_len, cap)

    def launch(self, dfm, enc, lens, K: int, min_seed_len: int, cap: int):
        dev = _stage_inputs(self.NAME, dfm, enc,
                            lens=(lens, torch.int32, 1))
        if dfm.shards is not None:
            raise ValueError("round1_compact reads a replicated index; a "
                             "sharded one seeds through the pivot chain")
        if K and (K != dfm.lut_depth or dfm.lut_start is None):
            raise ValueError(f"round1_compact at K={K}: the index carries a "
                             f"K-mer table of depth {dfm.lut_depth}")
        if K:
            check_tensors(self.NAME, dev,
                          lut_start=(dfm.lut_start, torch.int64, 1),
                          lut_size=(dfm.lut_size, torch.int64, 1))
        N, L = enc.shape
        if lens.shape[0] != N or cap < 1:
            raise ValueError(f"round1_compact: {lens.shape[0]} lengths for "
                             f"{N} reads, cap {cap}")
        cnt = torch.empty(N, dtype=torch.int32, device=dev)
        on, ob, os_ = (torch.empty((N, cap), dtype=torch.int32, device=dev)
                       for _ in range(3))
        ok = torch.empty((N, cap), dtype=torch.int64, device=dev)
        if N:
            self._launch(dev, fm_table(dfm), enc.data_ptr(), lens.data_ptr(),
                         N, L, int(min_seed_len), cap, int(K),
                         cnt.data_ptr(), on.data_ptr(), ob.data_ptr(),
                         os_.data_ptr(), ok.data_ptr())
        return cnt, on, ob, os_, ok


round1_compact = Round1Compact()


# ------------------------------------------------- per-stage seeding
def _start(counts, a):
    """The interval (k, l, s) of the single base a (a tensor of 0..3)."""
    return counts[a], counts[3 - a], counts[a + 1] - counts[a]


def _chains(dfm, enc, lens, stats, on_start, on_ext) -> None:
    """The per-read pivot chain of rounds 1 and 3 (the loop of
    round1_chain_kernel and round3_replay_kernel), lockstep over the reads
    until every read is done.  A read not in a segment starts one at x (an
    N there skips it; on_start(started reads, x) sees the others), a read
    in a segment extends forward by the base at col, or ends it at the
    read end (next x = len) or at an N (next x = col + 1).  on_ext(live,
    x, col, (k, l, s), (k', l', s')) sees the extended reads `live` (an
    index tensor) and returns (stop, next x, kept (k, l, s)) for them: a
    stopped segment ends, the others advance col."""
    dev = enc.device
    N, L = enc.shape
    e = enc.long()
    ln = lens.long()
    z = lambda: torch.zeros(N, dtype=torch.int64, device=dev)  # noqa: E731
    x, col, k, l, s = z(), z(), z(), z(), z()
    seg = torch.zeros(N, dtype=torch.bool, device=dev)
    rows = torch.arange(N, device=dev)
    work = _Work(dfm, stats, dev, lanes=N)
    while True:
        act = x < ln
        if not bool(act.any()):
            break
        starting = act & ~seg
        c0 = e[rows, x.clamp(0, L - 1)]
        start_ok = starting & (c0 < 4)
        x = torch.where(starting & ~start_ok, x + 1, x)
        on_start(start_ok, x)
        k0, l0, s0 = _start(dfm.counts, torch.where(start_ok, c0, 0))
        k = torch.where(start_ok, k0, k)
        l = torch.where(start_ok, l0, l)
        s = torch.where(start_ok, s0, s)
        col = torch.where(start_ok, x + 1, col)
        adv = act & seg
        inb = col < ln
        c = e[rows, col.clamp(0, L - 1)]
        x = torch.where(adv & ~inb, ln, x)
        x = torch.where(adv & inb & (c >= 4), col + 1, x)
        seg = (seg & ~adv) | start_ok
        live = (adv & inb & (c < 4)).nonzero()[:, 0]
        if not live.numel():
            continue
        kk, ll, ss, cl = k[live], l[live], s[live], col[live]
        work.add(kk, ss, live)
        # forward extension: backward on the RC twin, k and l swapped
        nl, nk, ns = backward_ext_full(dfm, ll, kk, ss, 3 - c[live])
        stop, x_next, (k[live], l[live], s[live]) = on_ext(
            live, x[live], cl, (kk, ll, ss), (nk, nl, ns))
        x[live] = torch.where(stop, x_next, x[live])
        col[live] = torch.where(stop, cl, cl + 1)
        seg[live] = ~stop
    work.done()


def round1_chain_ref(dfm: DeviceFMIndex, enc: torch.Tensor,
                     lens: torch.Tensor, cap: int,
                     stats: dict | None = None):
    """Round 1's pivot chain (bwamem2_tpu/ops/smem.py:round1_chain_kernel):
    from x = 0, a pivot at each x whose base is not N; its segment extends
    forward until the interval empties at col (next x = col), an N stops
    it (next x = col + 1) or it reaches the read end.  enc int8[N, L],
    lens int32[N].  Returns npiv int32[N] (the true pivot count: more than
    cap routes the read to the host) and px int32[N, cap] (-1 past npiv;
    an overflowing read's later pivots overwrite slot cap - 1, as in the
    JAX kernel)."""
    N = enc.shape[0]
    dev = enc.device
    npiv = torch.zeros(N, dtype=torch.int64, device=dev)
    px = torch.full((N, cap), -1, dtype=torch.int32, device=dev)

    def on_start(started, x):
        nonlocal npiv
        r = started.nonzero()[:, 0]
        px[r, npiv[r].clamp(max=cap - 1)] = x[r].to(torch.int32)
        npiv = npiv + started.long()

    def on_ext(live, x, col, old, new):
        dies = new[2] < 1        # the interval empties: next pivot at col
        return dies, col, tuple(torch.where(dies, o, n)
                                for o, n in zip(old, new))

    _chains(dfm, enc, lens, stats, on_start, on_ext)
    return npiv.to(torch.int32), px


def round3_replay_ref(dfm: DeviceFMIndex, enc: torch.Tensor,
                      lens: torch.Tensor, max_intv: int, min_len: int,
                      cap: int, stats: dict | None = None):
    """Round 3 (bwamem2_tpu/ops/smem.py:round3_replay_kernel): the pivot
    chain from x = 0 where a segment stops at the first column whose
    interval is below max_intv with a length of at least min_len
    (opt.min_seed_len + 1), emitting it if its interval is not empty; next
    x = that column + 1.  Returns nout int32[N] and, per read, cap slots
    x, n int32 (-1 past nout), s, k int64 (0 past nout): the seeds
    [x, n] with interval (k, s).  cap >= L // min_len + 1 cannot
    overflow; if it did, later seeds would overwrite slot cap - 1."""
    N = enc.shape[0]
    dev = enc.device
    nout = torch.zeros(N, dtype=torch.int64, device=dev)
    ox = torch.full((N, cap), -1, dtype=torch.int32, device=dev)
    on = torch.full((N, cap), -1, dtype=torch.int32, device=dev)
    os_ = torch.zeros((N, cap), dtype=torch.int64, device=dev)
    ok_ = torch.zeros((N, cap), dtype=torch.int64, device=dev)

    def on_ext(live, x, col, old, new):
        nk, nl, ns = new
        hit = (ns < max_intv) & (col - x + 1 >= min_len)
        emit = hit & (ns > 0)
        r = live[emit]
        at = nout[r].clamp(max=cap - 1)
        ox[r, at] = x[emit].to(torch.int32)
        on[r, at] = col[emit].to(torch.int32)
        os_[r, at] = ns[emit]
        ok_[r, at] = nk[emit]
        nout[r] += 1
        return hit, col + 1, new

    _chains(dfm, enc, lens, stats, lambda started, x: None, on_ext)
    return nout.to(torch.int32), ox, on, os_, ok_


def round2_forward_ref(dfm: DeviceFMIndex, enc: torch.Tensor,
                       rid: torch.Tensor, x: torch.Tensor,
                       min_intv: torch.Tensor, C: int,
                       stats: dict | None = None):
    """The forward pass per pivot (bwamem2_tpu/ops/smem.py:
    round2_forward_kernel): from the base at (rid, x) of the read grid
    enc int8[N, L] (rid -1: a pad pivot, no candidates), extend forward
    while the interval stays at least min_intv (int64[P]), pushing the
    interval before each change of size, then the last one if it is at
    least min_intv.  Returns per pivot up to C candidates: n (end offset
    from x) int32[P, C] (-1 past the count), k, l, s int64[P, C], and the
    true count int32[P] (more than C routes the pivot to the host; later
    candidates then overwrite slot C - 1, as in the JAX kernel)."""
    dev = enc.device
    N, L = enc.shape
    P = rid.shape[0]
    flat = enc.reshape(-1).long()
    rid, x, mi = rid.long(), x.long(), min_intv.long()
    base = rid * L + x
    plen = torch.where(rid >= 0, L - x, 0)
    a0 = flat[base.clamp(0, N * L - 1)]
    valid = (a0 < 4) & (plen > 0)
    k, l, s = _start(dfm.counts, torch.where(valid, a0, 0))
    n = torch.zeros(P, dtype=torch.int64, device=dev)
    cn = torch.full((P, C), -1, dtype=torch.int32, device=dev)
    ck, cl, cs = (torch.zeros((P, C), dtype=torch.int64, device=dev)
                  for _ in range(3))
    ncand = torch.zeros(P, dtype=torch.int64, device=dev)
    work = _Work(dfm, stats, dev, lockstep=True)

    def push(r):
        at = ncand[r].clamp(max=C - 1)
        cn[r, at] = n[r].to(torch.int32)
        ck[r, at], cl[r, at], cs[r, at] = k[r], l[r], s[r]
        ncand[r] += 1

    alive = valid.clone()
    for j in range(1, L):
        c = flat[(base + j).clamp(0, N * L - 1)]
        live = (alive & (j < plen) & (c < 4)).nonzero()[:, 0]
        alive = torch.zeros_like(alive)
        if not live.numel():
            break
        kk, ll, ss = k[live], l[live], s[live]
        work.add(kk, ss)
        nl, nk, ns = backward_ext_full(dfm, ll, kk, ss, 3 - c[live])
        push(live[ns != ss])
        grow = ns >= mi[live]
        g = live[grow]
        k[g], l[g], s[g], n[g] = nk[grow], nl[grow], ns[grow], j
        alive[g] = True
    push((valid & (s >= mi)).nonzero()[:, 0])
    work.done()
    return cn, ck, cl, cs, ncand.to(torch.int32)


def _bwd_walk(dfm, enc, rid, x, mi, alive, col, k, s, died, n_steps: int,
              work):
    """Every lane walks backward from column x - 1 - col of its read,
    one LF step per column, while its interval stays at least mi, at most
    n_steps steps (bwamem2_tpu/ops/smem.py:_bwd_walk).  A lane that steps
    below mi has died; one that reaches column 0 or an N has not."""
    N, L = enc.shape
    flat = enc.reshape(-1).long()
    base = rid * L + x - 1
    alive, col, k, s, died = (t.clone() for t in (alive, col, k, s, died))
    for _ in range(n_steps):
        c = flat[(base - col).clamp(0, N * L - 1)]
        live = (alive & (col < x) & (c < 4)).nonzero()[:, 0]
        alive = torch.zeros_like(alive)
        if not live.numel():
            break
        kk, ss = k[live], s[live]
        work.add(kk, ss)
        k2, s2 = lf_step(dfm, kk, ss, c[live])
        ext = s2 >= mi[live]
        died[live[~ext]] = True
        e = live[ext]
        k[e], s[e] = k2[ext], s2[ext]
        col[e] += 1
        alive[e] = True
    return alive, col, k, s, died


def round2_backward_ref(dfm: DeviceFMIndex, enc: torch.Tensor,
                        ridp: torch.Tensor, xp: torch.Tensor,
                        ck: torch.Tensor, cs: torch.Tensor,
                        piv_idx: torch.Tensor, slot_idx: torch.Tensor,
                        min_intv: torch.Tensor, steps_max: int = 0,
                        stats: dict | None = None):
    """The backward pass per candidate lane (bwamem2_tpu/ops/smem.py:
    round2_backward_kernel): lane i starts from its pivot piv_idx[i]'s
    forward candidate slot_idx[i], (ck, cs)[piv, slot], at the pivot's
    column xp (a pad pivot has xp 0: a dead lane), and walks backward
    while the interval stays at least min_intv[piv].  steps_max > 0 stops
    every walk after that many steps.  Returns (steps int32, k, s int64,
    died bool) per lane, and alive (bool: still walking) when steps_max >
    0."""
    pv, sl = piv_idx.long(), slot_idx.long()
    k, s = ck[pv, sl], cs[pv, sl]
    x = xp.long()[pv]
    alive = (x > 0) & (s > 0)
    col = torch.zeros_like(x)
    work = _Work(dfm, stats, enc.device, lockstep=True)
    alive, col, k, s, died = _bwd_walk(
        dfm, enc, ridp.long()[pv], x, min_intv.long()[pv], alive, col, k,
        s, torch.zeros_like(alive), steps_max or enc.shape[1], work)
    work.done()
    out = (col.to(torch.int32), k, s, died)
    return out + (alive,) if steps_max > 0 else out


def round2_backward_resume_ref(dfm: DeviceFMIndex, enc: torch.Tensor,
                               rid: torch.Tensor, x: torch.Tensor,
                               mi: torch.Tensor, col0: torch.Tensor,
                               k0: torch.Tensor, s0: torch.Tensor,
                               n_steps: int, stats: dict | None = None):
    """Continue walks from (col0, k0, s0) (bwamem2_tpu/ops/smem.py:
    round2_backward_resume_kernel): lane i of read rid[i], pivot column
    x[i], min_intv mi[i], at most n_steps more steps.  Returns (steps
    int32, k, s int64, died bool)."""
    work = _Work(dfm, stats, enc.device, lockstep=True)
    alive = torch.ones(col0.shape, dtype=torch.bool, device=enc.device)
    _, col, k, s, died = _bwd_walk(
        dfm, enc, rid.long(), x.long(), mi.long(), alive, col0.long(),
        k0.long(), s0.long(), torch.zeros_like(alive), n_steps, work)
    work.done()
    return col.to(torch.int32), k, s, died


# ----------------------------------------------------------- wrappers
def _stage_inputs(kernel: str, dfm, enc, **more):
    """Raise unless enc is an int8 read grid on a CUDA device with the
    index readable there and `more` as check_tensors wants; returns enc's
    device."""
    dev = enc.device
    if dev.type != "cuda":
        raise ValueError(f"{kernel} kernel needs CUDA tensors, got {dev}")
    _check_index(kernel, dfm, dev)
    check_tensors(kernel, dev, enc=(enc, torch.int8, 2), **more)
    if enc.numel() >= 1 << 31:
        raise ValueError(f"{kernel}: a read grid of {tuple(enc.shape)}, the "
                         "kernel takes fewer than 2^31 columns")
    return dev


class Round1Chain(CudaKernel):
    """round1_chain(dfm, enc int8[N, L], lens int32[N], cap) -> (npiv
    int32[N], px int32[N, cap]), as round1_chain_ref: one thread per
    read."""

    NAME = "round1_chain"
    SOURCES = ("round1_chain.cu", "seed_stages.cuh", "fm_occ.cuh")
    SIGNATURE = ("round1_chain_launch",
                 [VP, VP, VP, I32, I32, I32, VP, VP, VP])

    def __call__(self, dfm, enc, lens, cap: int):
        if enc.device.type == "cpu":
            self._plain()
            return round1_chain_ref(dfm, enc, lens, cap)
        return self.launch(dfm, enc, lens, cap)

    def launch(self, dfm, enc, lens, cap: int):
        dev = _stage_inputs(self.NAME, dfm, enc,
                            lens=(lens, torch.int32, 1))
        N, L = enc.shape
        npiv = torch.empty(N, dtype=torch.int32, device=dev)
        px = torch.full((N, cap), -1, dtype=torch.int32, device=dev)
        if N:
            self._launch(dev, fm_table(dfm), enc.data_ptr(), lens.data_ptr(),
                         N, L, cap, npiv.data_ptr(), px.data_ptr())
        return npiv, px


class Round3Replay(CudaKernel):
    """round3_replay(dfm, enc int8[N, L], lens int32[N], max_intv,
    min_len, cap) -> (nout int32[N], x, n int32[N, cap], s, k int64[N,
    cap]), as round3_replay_ref: one thread per read."""

    NAME = "round3_replay"
    SOURCES = ("round3_replay.cu", "seed_stages.cuh", "fm_occ.cuh")
    SIGNATURE = ("round3_replay_launch",
                 [VP, VP, VP, I32, I32, I64, I32, I32, VP, VP, VP, VP, VP,
                  VP])

    def __call__(self, dfm, enc, lens, max_intv: int, min_len: int,
                 cap: int):
        if enc.device.type == "cpu":
            self._plain()
            return round3_replay_ref(dfm, enc, lens, max_intv, min_len, cap)
        return self.launch(dfm, enc, lens, max_intv, min_len, cap)

    def launch(self, dfm, enc, lens, max_intv: int, min_len: int,
               cap: int):
        dev = _stage_inputs(self.NAME, dfm, enc,
                            lens=(lens, torch.int32, 1))
        N, L = enc.shape
        nout = torch.empty(N, dtype=torch.int32, device=dev)
        ox, on = (torch.full((N, cap), -1, dtype=torch.int32, device=dev)
                  for _ in range(2))
        os_, ok_ = (torch.zeros((N, cap), dtype=torch.int64, device=dev)
                    for _ in range(2))
        if N:
            self._launch(dev, fm_table(dfm), enc.data_ptr(), lens.data_ptr(),
                         N, L, int(max_intv), int(min_len), cap,
                         nout.data_ptr(), ox.data_ptr(), on.data_ptr(),
                         os_.data_ptr(), ok_.data_ptr())
        return nout, ox, on, os_, ok_


class _Persistent(CudaKernel):
    """A round-2 kernel on a persistent grid: its blocks of THREADS threads
    stay resident and take their work from a launch-wide ticket counter, a
    thread a work item.  RESIDENT names its occupancy query (sharded,
    threads, *blocks -> CUDA error)."""

    RESIDENT: str = ""
    THREADS = 128

    def __init__(self):
        super().__init__()
        self._resident = {}

    def plan(self, n: int, dev, sharded: bool = False) -> int:
        """Blocks of a launch of n work items on CUDA device `dev` over the
        replicated or the sharded index: the resident blocks (the
        occupancy API, asked once per device and view), or fewer where n
        items fill fewer."""
        key = (torch.device(dev).index, sharded)
        if key not in self._resident:
            blocks = I32()
            err = self._query(dev, self.RESIDENT, [I32, I32, VP],
                              int(sharded), self.THREADS,
                              ctypes.addressof(blocks))
            if err:
                raise ValueError(f"{self.NAME}: no launch of {self.THREADS} "
                                 f"threads (CUDA error {err})")
            self._resident[key] = blocks.value
        return max(1, min(self._resident[key], -(-n // self.THREADS)))


class Round2Forward(CudaKernel):
    """round2_forward(dfm, enc int8[N, L], rid, x int32[P], min_intv
    int64[P], C) -> (n int32[P, C], k, l, s int64[P, C], ncand int32[P]),
    as round2_forward_ref: one thread per pivot."""

    NAME = "round2_forward"
    SOURCES = ("round2_forward.cu", "seed_stages.cuh", "fm_occ.cuh")
    SIGNATURE = ("round2_forward_launch",
                 [VP, VP, I64, I32, VP, VP, VP, I32, I32, VP, VP, VP, VP, VP,
                  VP])

    def __call__(self, dfm, enc, rid, x, min_intv, C: int):
        if enc.device.type == "cpu":
            self._plain()
            return round2_forward_ref(dfm, enc, rid, x, min_intv, C)
        return self.launch(dfm, enc, rid, x, min_intv, C)

    def launch(self, dfm, enc, rid, x, min_intv, C: int):
        dev = _stage_inputs(self.NAME, dfm, enc,
                            rid=(rid, torch.int32, 1), x=(x, torch.int32, 1),
                            min_intv=(min_intv, torch.int64, 1))
        N, L = enc.shape
        P = rid.shape[0]
        cn = torch.full((P, C), -1, dtype=torch.int32, device=dev)
        ck, cl, cs = (torch.zeros((P, C), dtype=torch.int64, device=dev)
                      for _ in range(3))
        ncand = torch.empty(P, dtype=torch.int32, device=dev)
        if P:
            self._launch(dev, fm_table(dfm), enc.data_ptr(), N * L, L,
                         rid.data_ptr(), x.data_ptr(), min_intv.data_ptr(),
                         P, C, cn.data_ptr(), ck.data_ptr(), cl.data_ptr(),
                         cs.data_ptr(), ncand.data_ptr())
        return cn, ck, cl, cs, ncand


class Round2Backward(_Persistent):
    """round2_backward(dfm, enc, ridp, xp, ck, cs, piv_idx, slot_idx,
    min_intv, steps_max=0) as round2_backward_ref, and
    round2_backward.resume(dfm, enc, rid, x, mi, col0, k0, s0, n_steps)
    as round2_backward_resume_ref: the kernel's two entries, each thread
    keeping one walk refilled from a ticket counter by a persistent grid.
    steps_max 0 walks every lane to its end (L steps).  128-thread blocks,
    chosen on an NVIDIA H100 80GB HBM3 (700 W) over the launches of
    chip_smoke.py's run (g) (PERF.md)."""

    NAME = "round2_backward"
    SOURCES = ("round2_backward.cu", "r2b_group.cuh", "sa_group.cuh",
               "seed_stages.cuh", "fm_occ.cuh")
    SIGNATURE = ("round2_backward_launch",
                 [VP, VP, I64, I32, VP, VP, VP, VP, VP, I32, VP, VP, I32,
                  I32, VP, VP, VP, VP, VP, I32, I32, VP, VP])
    ENTRIES = {"round2_backward_resume_launch":
               [VP, VP, I64, I32, VP, VP, VP, VP, VP, VP, I32, I32, VP, VP,
                VP, VP, I32, I32, VP, VP]}
    RESIDENT = "round2_backward_resident"

    def __call__(self, dfm, enc, ridp, xp, ck, cs, piv_idx, slot_idx,
                 min_intv, steps_max: int = 0):
        args = (dfm, enc, ridp, xp, ck, cs, piv_idx, slot_idx, min_intv,
                steps_max)
        if enc.device.type == "cpu":
            self._plain()
            return round2_backward_ref(*args)
        return self.launch(*args)

    def _grid(self, M: int, dev, dfm) -> tuple:
        """(blocks, threads) of a launch of M lanes."""
        return self.plan(M, dev, dfm.shards is not None), self.THREADS

    def resume(self, dfm, enc, rid, x, mi, col0, k0, s0, n_steps: int):
        if enc.device.type == "cpu":
            self._plain()
            return round2_backward_resume_ref(dfm, enc, rid, x, mi, col0, k0,
                                              s0, n_steps)
        dev = _stage_inputs(
            self.NAME, dfm, enc, rid=(rid, torch.int32, 1),
            x=(x, torch.int32, 1), mi=(mi, torch.int64, 1),
            col0=(col0, torch.int32, 1), k0=(k0, torch.int64, 1),
            s0=(s0, torch.int64, 1))
        N, L = enc.shape
        M = rid.shape[0]
        col, k, s, died, nxt = self._outputs(M, dev)
        if M:
            self._launch(dev, fm_table(dfm), enc.data_ptr(), N * L, L,
                         rid.data_ptr(), x.data_ptr(), mi.data_ptr(),
                         col0.data_ptr(), k0.data_ptr(), s0.data_ptr(), M,
                         int(n_steps), col.data_ptr(), k.data_ptr(),
                         s.data_ptr(), died.data_ptr(),
                         *self._grid(M, dev, dfm), nxt,
                         entry="round2_backward_resume_launch")
        return col, k, s, died

    @staticmethod
    def _outputs(M: int, dev):
        """col, k, s, died of M lanes and the address of the launch's
        ticket counter (k's last element)."""
        k = torch.empty(M + 1, dtype=torch.int64, device=dev)
        return (torch.empty(M, dtype=torch.int32, device=dev), k[:M],
                torch.empty(M, dtype=torch.int64, device=dev),
                torch.empty(M, dtype=torch.bool, device=dev),
                k.data_ptr() + 8 * M)

    def launch(self, dfm, enc, ridp, xp, ck, cs, piv_idx, slot_idx,
               min_intv, steps_max: int = 0):
        dev = _stage_inputs(
            self.NAME, dfm, enc, ridp=(ridp, torch.int32, 1),
            xp=(xp, torch.int32, 1), ck=(ck, torch.int64, 2),
            cs=(cs, torch.int64, 2), piv_idx=(piv_idx, torch.int32, 1),
            slot_idx=(slot_idx, torch.int32, 1),
            min_intv=(min_intv, torch.int64, 1))
        N, L = enc.shape
        M = piv_idx.shape[0]
        col, k, s, died, nxt = self._outputs(M, dev)
        alive = torch.empty(M, dtype=torch.bool, device=dev)
        if M:
            self._launch(dev, fm_table(dfm), enc.data_ptr(), N * L, L,
                         ridp.data_ptr(), xp.data_ptr(), min_intv.data_ptr(),
                         ck.data_ptr(), cs.data_ptr(), ck.shape[1],
                         piv_idx.data_ptr(), slot_idx.data_ptr(), M,
                         steps_max or L, col.data_ptr(), k.data_ptr(),
                         s.data_ptr(), died.data_ptr(), alive.data_ptr(),
                         *self._grid(M, dev, dfm), nxt)
        out = (col, k, s, died)
        return out + (alive,) if steps_max > 0 else out


round1_chain = Round1Chain()
round2_forward = Round2Forward()
round2_backward = Round2Backward()
round3_replay = Round3Replay()

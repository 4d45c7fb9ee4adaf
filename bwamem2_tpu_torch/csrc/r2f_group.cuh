// r2f_group.cuh: round 2's forward pass of a batch of pivots, each pivot
// walked by a group of R2F_G lanes, the groups taking pivots from a
// launch-wide ticket counter: the body of the round2_forward CUDA kernel
// (round2_forward.cu), which the tests also compile as host C++.
//
// Semantics: ops/smem.py:round2_forward_ref (the JAX package's
// round2_forward_kernel).  Per pivot (rid, x, min_intv): from the
// base at x of read rid, extend forward while the interval stays >=
// min_intv, pushing the interval before each change of its size (slot
// min(j, C - 1)), then the last one if it is >= min_intv; the count goes
// to ncand.
//
// The lane group.  8 lanes of a warp walk one pivot.  A forward step is a
// backward_ext on the reverse-complement twin by the char a = 3 - c, over
// the occ rows at l and l + s (fm_occ.cuh's fm_row: every lane of the
// group loads the same two rows).  The walk loads each step's char one
// step ahead, so a step needs of each row only occ(., a) and the count of
// the chars after a: lane w counts, in code word w & 3 of row w >> 2, the
// chars equal to a and the chars past a before the position, packed a
// byte each with the other row's in the other half, and one reduction
// gives every lane all four counts; the new interval is a few int64
// additions.  The interval, the candidate rule ("push before each change
// of size") and the loop exits are computed by every lane from values the
// whole group shares; the leader writes the slots and the count.
//
// Tickets.  Each iteration of a group's loop is one step of its walk, or
// its refill: a group whose walk ended takes its next pivot (its own
// group index first, then one ticket from the launch's counter a walk),
// so a few long walks do not hold the other groups idle.  A group with no
// pivot left idles until every group of its warp is done, and a full-warp
// ballot each iteration keeps the warp's groups converged.  The ticket
// order decides only when a pivot is walked, never what it gets.
//
// The interface (R2fGroup) has two implementations: on the card one value
// per thread and the warp intrinsics over the group's lanes; in host C++
// the 8 lanes as arrays stepped in lockstep (each(f) calls f for every
// lane), where scalar code runs once, and a host counter whose tickets may
// be mapped through a permutation, so the tests can shuffle the order.
#pragma once

#include "seed_stages.cuh"

#ifdef __CUDACC__
#define R2_D __device__ __forceinline__
#else
#define R2_D inline
#endif

// lanes per pivot: one for each code word of a step's two rows
#define R2F_G 8

// Called once per backward_ext (the host tests count them).
#ifndef R2F_STEP_HOOK
#define R2F_STEP_HOOK()
#endif

// V: FmView or FmShardView
template <class V>
struct R2fBatch {
    V f;
    const int8_t *enc;      // the read grid int8[N, L], NL = N * L
    int64_t NL;
    int L;
    const int *rid, *x;     // [P]; rid -1: a pad pivot
    const int64_t *mi;      // [P] min_intv
    int P, C;
    int *cn;                // [P, C] candidate slots
    int64_t *ck, *cl, *cs;
    int *ncand;             // [P]
};

#ifdef __CUDACC__

template <class T>
struct R2fLane {
    T v;
    R2_D T &operator()(int) { return v; }
    R2_D const T &operator()(int) const { return v; }
};

// The card's group: 8 consecutive lanes of a warp.  Tickets: the group's
// index in the grid first, then groups + one from the counter per call.
struct R2fGroup {
    template <class T>
    using Lane = R2fLane<T>;
    unsigned mask;
    int l;
    unsigned long long *next;   // the launch's ticket counter
    int64_t first, groups;
    __device__ explicit R2fGroup(unsigned long long *ctr) : next(ctr) {
        const int wl = threadIdx.x & 31;
        l = wl & (R2F_G - 1);
        mask = ((1u << R2F_G) - 1u) << (wl & ~(R2F_G - 1));
        groups = (int64_t)gridDim.x * (blockDim.x / R2F_G);
        first = (int64_t)blockIdx.x * (blockDim.x / R2F_G)
                + threadIdx.x / R2F_G;
    }
    R2_D bool leader() const { return l == 0; }
    template <class F>
    R2_D void each(F f) const { f(l); }
    R2_D unsigned reduce_add(const Lane<unsigned> &x) const {
        return __reduce_add_sync(mask, x.v);
    }
    R2_D int64_t take() {
        if (first >= 0) {
            const int64_t t = first;
            first = -1;
            return t;
        }
        unsigned long long t = 0;
        if (l == 0) t = atomicAdd(next, 1ull);
        return groups + (int64_t)__shfl_sync(mask, t, 0, R2F_G);
    }
    R2_D int64_t index(int64_t t) const { return t; }
    // whether any group of the warp has work: a full-warp ballot, which
    // also reconverges the warp's groups every iteration
    R2_D bool warp_any(bool busy) const {
        return __ballot_sync(0xffffffffu, busy) != 0;
    }
};

#else

template <class T>
struct R2fLanes {
    T v[R2F_G] = {};
    T &operator()(int l) { return v[l]; }
    const T &operator()(int l) const { return v[l]; }
};

// The host's group: 8 lanes in lockstep; ticket t is perm[t] when a
// permutation is given.
struct R2fGroup {
    template <class T>
    using Lane = R2fLanes<T>;
    const int64_t *perm = nullptr;
    int64_t next = 0;
    bool leader() const { return true; }
    template <class F>
    void each(F f) const {
        for (int l = 0; l < R2F_G; ++l) f(l);
    }
    unsigned reduce_add(const Lane<unsigned> &x) const {
        unsigned r = 0;
        for (int l = 0; l < R2F_G; ++l) r += x(l);
        return r;
    }
    int64_t take() { return next++; }
    int64_t index(int64_t t) const { return perm ? perm[t] : t; }
    bool warp_any(bool busy) const { return busy; }
};

#endif

// code word w (0..3) of a row, by selects (a run-time index into the row
// would put it in local memory on the card)
R2_D uint32_t r2f_word(const uint32_t r[8], int w) {
    return w == 0 ? r[4] : w == 1 ? r[5] : w == 2 ? r[6] : r[7];
}

// the sum of the checkpoint counts of the chars after a (fm_cp by selects)
template <class V>
R2_D int64_t r2f_cp_after(const V &f, const uint32_t r[8], uint32_t hi,
                          int a) {
    return (a < 1 ? fm_cp(f, r, hi, 1) : 0) + (a < 2 ? fm_cp(f, r, hi, 2) : 0)
           + (a < 3 ? fm_cp(f, r, hi, 3) : 0);
}

// backwardExt of (k, l, s) by the char a (0..3) by the group: every lane
// gets (k', l', s') (fm_occ.cuh:fm_backward_ext's arithmetic).  Lane w
// packs, for code word w & 3 of the row at k (w < 4) or k + s, the chars
// equal to a and the chars past a among the row's first (pos & 63) into
// bytes 0 / 1 (row k) or 2 / 3 (row k + s) of one reduction.
template <class Gr, class V>
R2_D void r2f_ext(const Gr &g, const V &f, int64_t k, int64_t l, int64_t s,
                  int a, int64_t *ko, int64_t *lo, int64_t *so) {
    const int64_t p1 = k + s;
    const int y0 = (int)(k & 63), y1 = (int)(p1 & 63);
    uint32_t r0[8], r1[8];
    fm_row(f, k >> 6, r0);
    fm_row(f, p1 >> 6, r1);
    const uint32_t h0 = f.has_hi ? fm_hi(f, k >> 6) : 0u;
    const uint32_t h1 = f.has_hi ? fm_hi(f, p1 >> 6) : 0u;
    const uint32_t pat = (uint32_t)a * 0x55555555u;
    typename Gr::template Lane<unsigned> v;
    g.each([&](int ln) {
        const int hi_row = ln >> 2, wi = ln & 3;
        const uint32_t x = hi_row ? r2f_word(r1, wi) : r2f_word(r0, wi);
        const uint32_t pm = fm_prefix_mask(hi_row ? y1 : y0, wi);
        const uint32_t lb = x & 0x55555555u, hb = (x >> 1) & 0x55555555u;
        const uint32_t m = x ^ pat;
        const uint32_t eq = ~(m | (m >> 1)) & 0x55555555u & pm;
        const uint32_t gt = (a == 0 ? (lb | hb) : a == 1 ? hb
                             : a == 2 ? (lb & hb) : 0u) & pm;
        v(ln) = ((unsigned)fm_popc(eq) | (unsigned)fm_popc(gt) << 8)
                << (16 * hi_row);
    });
    const int64_t a0 = fm_cp(f, r0, h0, a), a1 = fm_cp(f, r1, h1, a);
    const int64_t after = r2f_cp_after(f, r1, h1, a)
                          - r2f_cp_after(f, r0, h0, a);
    const int64_t sent0 = a == 0 ? fm_sent_in(f, k, y0) : 0;
    const int64_t sent1 = a == 0 ? fm_sent_in(f, p1, y1) : 0;
    const int64_t sent = (k <= f.sentinel && f.sentinel < p1) ? 1 : 0;
    const unsigned n = g.reduce_add(v);
    const int64_t sp = a0 + (int64_t)(n & 0xFFu) - sent0;
    const int64_t ep = a1 + (int64_t)((n >> 16) & 0xFFu) - sent1;
    *ko = fm_count(f, a) + sp;
    *so = ep - sp;
    *lo = l + sent + after + (int64_t)(n >> 24)
          - (int64_t)((n >> 8) & 0xFFu);
}

// the leader writes candidate nc to slot min(nc, C - 1)
template <class Gr, class V>
R2_D void r2f_push(const Gr &g, const R2fBatch<V> &b, int64_t o, int &nc,
                    int n, int64_t k, int64_t l, int64_t s) {
    if (g.leader()) {
        const int64_t at = o + (nc < b.C ? nc : b.C - 1);
        b.cn[at] = n;
        b.ck[at] = k;
        b.cl[at] = l;
        b.cs[at] = s;
    }
    ++nc;
}

// Walk the batch's pivots until every group of the warp has drawn a
// ticket past P.  One iteration: the refill of a group without a pivot,
// then one step of its walk or its end (the last candidate and the
// count); a group that is done idles in the loop until its warp is.
template <class Gr, class V>
R2_D void r2f_group_run(Gr &g, const R2fBatch<V> &b) {
    const V &f = b.f;
    int p = -1, n = 0, nc = 0, j = 0, plen = 0, c = 4;
    int64_t base = 0, mi = 0, o = 0, k = 0, l = 0, s = 0, t = 0;
    bool valid = false, done = false;
    for (;;) {
        if (p < 0 && !done) {
            t = g.take();
            done = t >= b.P;
        }
        if (!g.warp_any(!done)) return;
        if (done) continue;
        if (p < 0) {
            p = (int)g.index(t);
            const int rid = b.rid[p], x = b.x[p];
            mi = b.mi[p];
            base = (int64_t)rid * b.L + x;
            plen = rid >= 0 ? b.L - x : 0;
            const int a0 = stage_code(b.enc, b.NL, base);
            valid = (unsigned)a0 < 4u && plen > 0;
            const int a = valid ? a0 : 0;
            k = fm_count(f, a);
            l = fm_count(f, 3 - a);
            s = fm_count(f, a + 1) - k;
            o = (int64_t)p * b.C;
            n = nc = 0;
            j = 1;
            c = stage_code(b.enc, b.NL, base + 1);
        }
        bool end = true;
        if (valid && j < plen && (unsigned)c < 4u) {
            // the next column's code, loaded with this step's rows
            const int cnext = stage_code(b.enc, b.NL, base + j + 1);
            int64_t nk, nl, ns;
            // forward extension: backward on the RC twin, k and l swapped
            r2f_ext(g, f, l, k, s, 3 - c, &nl, &nk, &ns);
            R2F_STEP_HOOK();
            if (ns != s) r2f_push(g, b, o, nc, n, k, l, s);
            if (ns >= mi) {
                k = nk;
                l = nl;
                s = ns;
                n = j++;
                c = cnext;
                end = false;
            }
        }
        if (end) {
            if (valid && s >= mi) r2f_push(g, b, o, nc, n, k, l, s);
            if (g.leader()) b.ncand[p] = nc;
            p = -1;
        }
    }
}

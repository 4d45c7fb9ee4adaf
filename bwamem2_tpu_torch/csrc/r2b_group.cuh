// r2b_group.cuh: round 2's backward walks of a batch of candidate lanes by
// one warp whose lanes are refilled as their walks end: the body of the
// round2_backward CUDA kernel (round2_backward.cu, both entries), which
// the tests also compile as host C++.
//
// Semantics: ops/smem.py:round2_backward_ref / round2_backward_resume_ref
// (the JAX package's _bwd_walk).  A walk:
// from column x - 1 - col of its read, one LF step per column while the
// interval stays >= min_intv, at most n_steps steps; a step below it sets
// died, column 0 or an N ends the walk without it.  The first entry
// starts lane i from its pivot's forward candidate (k, s) = (ck, cs)[piv,
// slot] at col 0 (a pivot at x 0 or an empty interval: a dead lane) and
// writes alive (still walking after n_steps) too; the resume entry
// starts from (col0, k0, s0).
//
// Refilled lanes.  Most walks die within a few dozen steps and a few run
// to column 0, so a warp that walks one lane per thread runs until its
// longest walk ends while most threads idle.  Here each thread keeps one
// walk in registers and takes another as it ends.  The first fill is
// static and strided over the grid (thread t of T takes ticket t), so a
// launch spreads over every resident thread; the warp refills the threads
// whose walks ended from its reservation of tickets, renewed from a
// launch-wide counter with one atomic per warp (the loop of sa_group.cuh,
// over its SaWarp).  An iteration: (1) a walking thread issues its step's
// loads, the occ rows at k and k + s (fm_occ.cuh's fm_row) and the next
// column's base; a refilled one loads its first column's base; (2) the
// empty threads are refilled, if any is (their descriptors load while the
// rows of (1) are in flight); (3) every thread of (1) takes its step
// (fm_occ_one's count on the loaded rows), or its first checks, and a walk
// that ends writes col, k, s, died (and alive) and frees its thread.  So a
// walk's base is always known one step ahead and a step waits only on its
// rows.  The refill order decides only when a walk runs, never what it
// returns.
#pragma once

#include "sa_group.cuh"
#include "seed_stages.cuh"

// Called once per LF step (the host tests count them).
#ifndef R2B_STEP_HOOK
#define R2B_STEP_HOOK()
#endif

// Tickets a warp reserves at once (SA_CHUNK's rule: about one whole
// refill of the warp).
#define R2B_CHUNK 32

// A launch's lanes: either from the candidate grids (ck != nullptr: lane i
// is candidate slot[i] of pivot piv[i], whose read, column and min_intv
// are rid, x, mi at piv[i]) or resumed (ck == nullptr: lane i's read,
// column, min_intv and state are rid, x, mi, col0, k0, s0 at i).
template <class V>
struct R2bBatch {
    V f;
    const int8_t *enc;      // the read grid int8[N, L], NL = N * L
    int64_t NL;
    int L;
    const int *rid, *x;
    const int64_t *mi;
    const int64_t *ck, *cs; // [P, C]
    int C;
    const int *piv, *slot;
    const int *col0;
    const int64_t *k0, *s0;
    int M, n_steps;
    int *col;
    int64_t *k, *s;
    bool *died, *alive;     // alive: nullptr on the resume entry
};

// An occ row between its load and its count
struct R2bRow {
    uint32_t w[8], hi;
};

template <class V>
SA_D void r2b_row(const V &f, int64_t pos, R2bRow &r) {
    fm_row(f, pos >> 6, r.w);
    r.hi = f.has_hi ? fm_hi(f, pos >> 6) : 0u;
}

// occ(pos, c) from pos's row: fm_occ.cuh:fm_occ_one after its load
template <class V>
SA_D int64_t r2b_occ(const V &f, const R2bRow &r, int64_t pos, int c) {
    const int y = (int)(pos & 63);
    return fm_cp(f, r.w, r.hi, c) + fm_inblock(r.w, y, c)
           - (c == 0 ? fm_sent_in(f, pos, y) : 0);
}

#ifdef __CUDA_ARCH__
SA_D int64_t r2b_thread(int) {
    return (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
}
SA_D int64_t r2b_threads() { return (int64_t)gridDim.x * blockDim.x; }
#else
// the host's grid: one warp
inline int64_t r2b_thread(int l) { return l; }
inline int64_t r2b_threads() { return 32; }
#endif

// Walk the batch's lanes until the ticket counter passes M and every
// thread of the warp is empty.
template <class Wp, class V>
SA_D void r2b_group_run(Wp &g, const R2bBatch<V> &b) {
    enum { R2B_FRESH, R2B_WALK };   // a thread's states
    // per thread: the lane's index (< 0: empty), state, column, pivot
    // column x, steps left, base code of this step and of the next;
    // interval, min_intv, flat index of column 0 - 1 of the walk (base -
    // col is this step's column); alive at the start; the rows between
    // (1) and (3)
    typename Wp::template Lane<int> idx, st, col, xx, rem, cc, cn;
    typename Wp::template Lane<int64_t> kk, ss, mi, base;
    typename Wp::template Lane<bool> live0, go;
    typename Wp::template Lane<R2bRow> ra, rb;
    const V &f = b.f;
    const bool first = b.ck != nullptr;
    // lane l takes ticket t: its lane's descriptor, state FRESH
    auto fill = [&](int l, int64_t t) {
        const int i = (int)g.index(t);
        int p = i;
        if (first) {
            p = b.piv[i];
            const int64_t at = (int64_t)p * b.C + b.slot[i];
            kk(l) = b.ck[at];
            ss(l) = b.cs[at];
            col(l) = 0;
        } else {
            kk(l) = b.k0[i];
            ss(l) = b.s0[i];
            col(l) = b.col0[i];
        }
        const int x = b.x[p];
        idx(l) = i;
        st(l) = R2B_FRESH;
        xx(l) = x;
        mi(l) = b.mi[p];
        base(l) = (int64_t)b.rid[p] * b.L + x - 1;
        rem(l) = b.n_steps;
        live0(l) = !first || (x > 0 && ss(l) > 0);
    };
    // the first fill: the grid's thread t takes ticket t; refills take
    // tickets from the counter, past T
    const int64_t T = r2b_threads();
    g.each([&](int l) {
        idx(l) = -1;
        if (r2b_thread(l) < b.M) fill(l, r2b_thread(l));
    });
    int64_t pool = T, pool_end = T;     // the warp's unused tickets
    bool drained = pool >= b.M;
    for (;;) {
        // (1) the loads of this iteration's steps and first checks
        g.each([&](int l) {
            go(l) = idx(l) >= 0;
            if (!go(l)) return;
            const int64_t at = base(l) - col(l);
            if (st(l) == R2B_FRESH) {
                cc(l) = stage_code(b.enc, b.NL, at);
                return;
            }
            r2b_row(f, kk(l), ra(l));
            r2b_row(f, kk(l) + ss(l), rb(l));
            cn(l) = stage_code(b.enc, b.NL, at - 1);
        });
        // (2) refill the empty threads, tickets in lane order: first the
        // rest of the warp's reservation, then a new one
        if (!drained) {
            const unsigned need = g.ballot([&](int l) { return idx(l) < 0; });
            const int total = sa_popc(need);
            if (total) {
                const int64_t avail = pool_end - pool;
                int64_t fresh = 0;
                if (total > avail) {
                    fresh = T + g.take(R2B_CHUNK);
                    pool_end = fresh + R2B_CHUNK;
                }
                g.each([&](int l) {
                    if (!(need >> l & 1)) return;
                    const int64_t r = sa_popc(need & ((1u << l) - 1u));
                    const int64_t t = r < avail ? pool + r
                                                : fresh + (r - avail);
                    if (t < b.M) fill(l, t);
                });
                pool = total > avail ? fresh + (total - avail)
                                     : pool + total;
                // every ticket this warp could hand out is past M, and so
                // is the counter
                drained = pool >= b.M;
            }
        }
        if (drained && !g.ballot([&](int l) { return idx(l) >= 0; }))
            break;
        // (3) the steps and first checks of the threads of (1)
        g.each([&](int l) {
            if (!go(l)) return;
            bool fin = false, alive = false, died = false;
            if (st(l) == R2B_FRESH) {
                alive = live0(l);
                fin = !alive || rem(l) <= 0 || col(l) >= xx(l)
                      || (unsigned)cc(l) >= 4u;
                // n_steps 0 keeps alive; an end column or N does not
                alive = alive && rem(l) <= 0;
                st(l) = R2B_WALK;
            } else {
                const int c = cc(l);
                const int64_t k = kk(l), s = ss(l);
                const int64_t sp = r2b_occ(f, ra(l), k, c);
                const int64_t s2 = r2b_occ(f, rb(l), k + s, c) - sp;
                R2B_STEP_HOOK();
                if (s2 < mi(l)) {
                    fin = died = true;
                } else {
                    kk(l) = fm_count(f, c) + sp;
                    ss(l) = s2;
                    col(l) += 1;
                    cc(l) = cn(l);
                    alive = --rem(l) <= 0;
                    fin = alive || col(l) >= xx(l) || (unsigned)cc(l) >= 4u;
                }
            }
            if (!fin) return;
            const int i = idx(l);
            b.col[i] = col(l);
            b.k[i] = kk(l);
            b.s[i] = ss(l);
            b.died[i] = died;
            if (b.alive) b.alive[i] = alive;
            idx(l) = -1;
        });
    }
}

// sa_group.cuh: suffix-array resolution of a batch of BWT positions by one
// warp whose lanes are refilled as their walks end: the body of the
// sa_resolve CUDA kernel (sa_resolve.cu), which the tests also compile as
// host C++.
//
// Semantics: get_sa_entry_compressed (FMI_search.cpp:1103-1175), as the
// port's host rt_sa_entries (native/runtime.cpp) and ops/seed.py:
// sa_resolve_ref compute it: LF-walk from pos until the position is a
// sampled slot (pos & 7 == 0) or the sentinel, then (sa_ms << 32) + sa_ls
// + steps with the int8 ms byte sign-extended; at the sentinel the result
// is the step count.  out[i] depends on pos[i] alone.
//
// Refilled lanes.  A walk's length is about geometric (1/8 of the
// positions are sampled), so a warp that walks one position per lane runs
// until its longest walk ends while most lanes idle.  Here each lane keeps
// W independent walks (slots) in registers.  Every iteration each walking
// slot takes one LF step (one occ-row read); a walk that ends writes
// out[i] and frees its slot.  Free slots are refilled at the top of the
// next iteration from the warp's reservation of tickets, which the leader
// renews from a launch-wide counter with one atomic when it runs short
// (the slots that need work are ballots, the base is broadcast, each
// slot's ticket is its rank among them), so the warp stays full until the
// queue drains.  Tickets go out in input order and to neighbouring lanes:
// the max_occ-sampled positions of one SMEM are consecutive BWT positions,
// so neighbouring lanes start on the same occ row.  Within an iteration
// all W slots' row reads are issued before any is used, so a thread keeps
// W reads in flight, and nothing else is waited on (sa_group_run).  The
// order in which slots are refilled decides only when a walk runs, never
// its result.
//
// The interface (SaWarp) has two implementations: on the card one value
// per thread, the warp intrinsics and an atomic counter in device memory;
// in host C++ the 32 lanes as arrays stepped in lockstep (each(f) calls f
// for every lane) and a host counter whose tickets may be mapped through a
// permutation, so the tests can shuffle the refill order.  Every loop exit
// is decided from a ballot, so the whole warp leaves together.
#pragma once

#include "fm_occ.cuh"

#ifdef __CUDACC__
#define SA_D __device__ __forceinline__
#define SA_UNROLL _Pragma("unroll")
#else
#define SA_D inline
#define SA_UNROLL
#endif

// Tickets a warp reserves at once, per walk a lane keeps: one whole refill
// of the warp, so a warp takes the counter about once per 9 iterations (a
// slot is busy ~9 iterations a walk) and the counter's atomics neither
// serialise the warps nor leave one warp many tickets at the end.
#define SA_CHUNK 32

// Called once per occ-row read (the host tests count them).
#ifndef SA_ROW_HOOK
#define SA_ROW_HOOK()
#endif

// V: FmView (the SA tables are sa_ms / sa_ls) or FmShardView (they are
// the view's shards, and sa_ms / sa_ls are unused)
template <class V>
struct SaBatchOf {
    V f;
    const int8_t *sa_ms;
    const uint32_t *sa_ls;
    const int64_t *pos;     // [P] BWT positions, P < 2^31
    int64_t P;
    int64_t *out;           // [P] reference coordinates
};
using SaBatch = SaBatchOf<FmView>;

// the SA words of sampled slot idx
SA_D void sa_words(const SaBatchOf<FmView> &b, int64_t idx, int &ms,
                   uint32_t &ls) {
    ms = b.sa_ms[idx];
    ls = b.sa_ls[idx];
}
SA_D void sa_words(const SaBatchOf<FmShardView> &b, int64_t idx, int &ms,
                   uint32_t &ls) {
    fm_sa_words(b.f, idx, &ms, &ls);
}

// One occ row as a walk holds it between its read and its use.
struct SaRow {
    uint32_t w[8];
    uint32_t hi;
};

SA_D int sa_popc(unsigned x) {
#ifdef __CUDA_ARCH__
    return __popc(x);
#else
    return __builtin_popcount(x);
#endif
}

#ifdef __CUDACC__

template <class T>
struct SaLane {
    T v;
    SA_D T &operator()(int) { return v; }
    SA_D const T &operator()(int) const { return v; }
};

// The card's warp: lane l is thread l of the warp; every lane runs the
// loop to its end (the launch's blocks are whole warps).
struct SaWarp {
    template <class T>
    using Lane = SaLane<T>;
    unsigned long long *next;   // the launch's ticket counter
    int l;
    __device__ explicit SaWarp(unsigned long long *ctr)
        : next(ctr), l(threadIdx.x & 31) {}
    template <class F>
    SA_D void each(F f) const { f(l); }
    template <class F>
    SA_D unsigned ballot(F f) const { return __ballot_sync(~0u, f(l)); }
    // n tickets: the leader's atomic, the base broadcast
    SA_D int64_t take(int n) const {
        unsigned long long t = 0;
        if (l == 0) t = atomicAdd(next, (unsigned long long)n);
        return (int64_t)__shfl_sync(~0u, t, 0);
    }
    SA_D int64_t index(int64_t t) const { return t; }
};

#else

template <class T>
struct SaLanes {
    T v[32];
    T &operator()(int l) { return v[l]; }
    const T &operator()(int l) const { return v[l]; }
};

// The host's warp: 32 lanes stepped in lockstep; ticket t resolves
// position perm[t] when a permutation is given.
struct SaWarp {
    template <class T>
    using Lane = SaLanes<T>;
    const int64_t *perm = nullptr;
    int64_t next = 0;
    template <class F>
    void each(F f) const {
        for (int l = 0; l < 32; ++l) f(l);
    }
    template <class F>
    unsigned ballot(F f) const {
        unsigned m = 0;
        for (int l = 0; l < 32; ++l)
            if (f(l)) m |= 1u << l;
        return m;
    }
    int64_t take(int n) {
        const int64_t t = next;
        next += n;
        return t;
    }
    int64_t index(int64_t t) const { return perm ? perm[t] : t; }
};

#endif

// Walk the batch's positions until the ticket counter passes P and every
// slot of the warp is empty.  W: walks per lane.
//
// A warp issues in order, so a load's first use stalls it.  Each
// iteration is laid out so that only the rows of the walking slots are
// waited on: a refilled slot's position is loaded in one iteration and
// walked from the next, and a walk that reaches a sampled slot loads its
// SA entry in one iteration and writes it in the next, after that
// iteration's rows are issued.  A slot is busy for its walk's steps plus
// two iterations.
template <int W, class Wp, class V>
SA_D void sa_group_run(Wp &g, const SaBatchOf<V> &b) {
    enum { SA_WALK, SA_NEW, SA_DONE };   // slot states
    // per slot: the position's index (< 0: empty), state, position on the
    // walk and steps so far, its row between read and use, and its SA
    // entry's two words between their load and the write
    typename Wp::template Lane<int64_t> sp[W];
    typename Wp::template Lane<int> idx[W], st[W], off[W], ms[W];
    typename Wp::template Lane<uint32_t> ls[W];
    typename Wp::template Lane<SaRow> row[W];
    SA_UNROLL
    for (int w = 0; w < W; ++w) g.each([&](int l) { idx[w](l) = -1; });
    int64_t pool = 0, pool_end = 0;     // the warp's unused tickets
    bool drained = false;
    for (;;) {
        // refill the empty slots, tickets in lane order within a slot:
        // first the rest of the warp's reservation, then a new one
        if (!drained) {
            unsigned need[W];
            int total = 0;
            SA_UNROLL
            for (int w = 0; w < W; ++w) {
                need[w] = g.ballot([&](int l) { return idx[w](l) < 0; });
                total += sa_popc(need[w]);
            }
            const int64_t avail = pool_end - pool;
            int64_t fresh = 0;
            if (total > avail) {
                fresh = g.take(SA_CHUNK * W);
                pool_end = fresh + SA_CHUNK * W;
            }
            int rank = 0;
            SA_UNROLL
            for (int w = 0; w < W; ++w) {
                g.each([&](int l) {
                    if (!(need[w] >> l & 1)) return;
                    const int64_t r =
                        rank + sa_popc(need[w] & ((1u << l) - 1u));
                    const int64_t t = r < avail ? pool + r
                                                : fresh + (r - avail);
                    if (t >= b.P) return;
                    const int i = (int)g.index(t);
                    idx[w](l) = i;
                    st[w](l) = SA_NEW;
                    sp[w](l) = b.pos[i];
                    off[w](l) = 0;
                });
                rank += sa_popc(need[w]);
            }
            pool = total > avail ? fresh + (total - avail) : pool + total;
            // every ticket this warp could hand out is past P, and so is
            // the counter
            drained = pool >= b.P;
        }
        // before the queue drains every slot is busy after the refill
        if (drained) {
            unsigned live = 0;
            SA_UNROLL
            for (int w = 0; w < W; ++w)
                live |= g.ballot([&](int l) { return idx[w](l) >= 0; });
            if (!live) break;
        }
        // the rows of the walking slots, all issued before any is used
        SA_UNROLL
        for (int w = 0; w < W; ++w) {
            g.each([&](int l) {
                if (idx[w](l) < 0 || st[w](l) != SA_WALK) return;
                const int64_t blk = sp[w](l) >> 6;
                fm_row(b.f, blk, row[w](l).w);
                row[w](l).hi = b.f.has_hi ? fm_hi(b.f, blk) : 0u;
            });
        }
        // the SA entries loaded in the last iteration, written while the
        // rows load
        SA_UNROLL
        for (int w = 0; w < W; ++w) {
            g.each([&](int l) {
                if (idx[w](l) < 0 || st[w](l) != SA_DONE) return;
                b.out[idx[w](l)] = fm_sa_value(ms[w](l), ls[w](l),
                                               off[w](l));
                idx[w](l) = -1;
            });
        }
        // one LF step per walking slot; a walk at the sentinel ends with
        // its steps
        SA_UNROLL
        for (int w = 0; w < W; ++w) {
            g.each([&](int l) {
                if (idx[w](l) < 0 || st[w](l) != SA_WALK) return;
                SA_ROW_HOOK();
                int64_t occ;
                const int c = fm_char_occ_row(b.f, row[w](l).w,
                                              row[w](l).hi, sp[w](l), &occ);
                if (c == 4) {
                    b.out[idx[w](l)] = off[w](l);
                    idx[w](l) = -1;
                    return;
                }
                sp[w](l) = fm_count(b.f, c) + occ;
                off[w](l) += 1;
            });
        }
        // a walk (or a new slot) on a sampled slot loads its SA entry;
        // the others walk on
        SA_UNROLL
        for (int w = 0; w < W; ++w) {
            g.each([&](int l) {
                if (idx[w](l) < 0) return;
                if (sp[w](l) & 7) {
                    st[w](l) = SA_WALK;
                    return;
                }
                st[w](l) = SA_DONE;
                sa_words(b, sp[w](l) >> 3, ms[w](l), ls[w](l));
            });
        }
    }
}

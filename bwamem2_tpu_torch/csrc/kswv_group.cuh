// Two-phase striped local Smith-Waterman for one mate-rescue problem, run by
// one lane group: the body of the kswv CUDA kernel (kswv.cu).
//
// Behavioral spec: ksw_align with KSW_XSUBO | KSW_XSTART (ksw.cpp:347-381),
// as the port's scalar host kernel emulates it lane for lane
// (native/core.cpp: ksw_run_u8 :397-505, ksw_run_i16 :507-612, ksw_align
// :631-655): NL = 16 u8 lanes (biased by shift = -min(mat), adds saturating
// at 255, subtracts at 0) or NL = 8 i16 lanes (signed adds saturating at
// 32767, _mm_adds_epi16: the i16 class's own width), slen =
// ceil(qlen/NL) segments, the main pass with intra-stripe F, up to 16 lazy-F
// sweeps, the row maximum taken before the fixup and Hmax copied after it.
// Three differences keep it identical to bwamem2_tpu/ops/kswv.py:
// kswv_two_phase (where no i16 score reaches 32767; JAX's int32 emulation
// does not saturate) and to ops/kswv.py:kswv_two_phase_ref, the outputs it
// is held against:
//   * q and t are gathered from descriptors (read grid `enc`, doubled genome
//     `ref` through bsw_ref_at): pad columns score 0, ambiguous bases -1,
//     else a / -b;
//   * each phase writes (score, te, qe, score2, te2, saturated); qe, score2
//     and te2 are also computed for saturated u8 lanes (the caller masks
//     them), and qe is -1 when no row scored;
//   * phase 1 walks the reversed prefixes of exactly te+1 target bases.
//
// The lane group.  Lane l of the group is SIMD lane l of the striped
// register: it owns stripe column l, the cells c = j*NL + l for j < slen,
// which are query columns l*slen + j.  Each lane runs the segment loops over
// its own cells; what crosses lanes goes through the group interface:
//   lane()              this lane's index
//   shfl_up0(x)         lane l-1's x, 0 in lane 0 (the striped lane shift)
//   all(p)              p holds in every lane (the lazy-F exit vote)
//   reduce_max/min(x)   over the lanes (the row maximum, the qe argmax)
//   broadcast(x, s)     lane s's x (the row's target base)
//   select(m, a, b)     per lane
//   map(f)              f(lane) per lane (the profile and target loads)
//   leader()            lane 0: the scalar b-array scan and the writes
// It has two implementations: on the card (__CUDACC__) one int per thread
// and the warp intrinsics over the group's lanes only; in host C++ the NL
// lanes as an int[NL] lane vector stepped in lockstep (leader() is always
// true there, scalar code runs once).  A group may give each lane S
// sub-threads (KswvGroup<NL, S>, the split form of kswv_phase_split:
// thread t = s * NL + l, with publish/get exchanges, an AND over the lanes
// of one s and map2(f(l, s)) beside the calls above; shared memory and a
// barrier between warps when NL x S > 32).  The kernel and the host tests compile
// this one source.  Every branch that ends a loop is decided from values the
// whole group shares: a reduction, a vote or a broadcast.
//
// Stripes.  H is updated in place (one temporary carries the old H[j] as the
// next segment's diagonal), beside E, Hmax and the profile.  With slen <=
// SMAX, a compile-time bucket, they are registers (KswvRegStripes: every
// segment loop runs SMAX times, fully unrolled, its body guarded by j <
// slen, and H's last segment is a register of its own, so no array is
// indexed at run time); with SMAX = 0 they are int16 / uint8 arrays laid
// out [segment][lane] (KswvPtrStripes: dynamic shared memory on the card,
// sized per launch from Qmax).  The row maxima go to the problem's int16
// row of `rowmax`, one write per row by the leader, which scans them for
// the second best after each phase.
//
// Profile.  Each lane loads its slen query codes once per phase (0-3 bases
// with the complement applied, 4 ambiguous, 5 pad column) and keeps each as
// a __byte_perm selector.  Each row builds from its target base an 8-byte
// table of scores by query code, so a cell's score is one byte permute:
// ksw_align's 5-scores-per-column profile, indexed from the row's side.
// The scores are those of bwa-mem2's int8 matrix (match a, mismatch -b,
// ambiguous -1; the caller reads a and b from it), as the native kernel's
// profile holds them: u8 bytes biased by shift = -min(matrix), as
// (uint8)(score + shift) (ksw_u8's profile, native/core.cpp:build_u8), so
// 0..255 for any int8 matrix; i16 bytes unbiased, the selector replicating
// the byte's sign into the upper bytes (ksw_i16's int16 profile of the
// same matrix), so any a and b of the matrix fit with no shift.

#pragma once

#include <limits.h>

#include "bsw_common.cuh"

#ifdef __CUDACC__
#define KSWV_D __device__ __forceinline__
#define KSWV_HD __host__ __device__ __forceinline__
#define KSWV_UNROLL _Pragma("unroll")
#define KSWV_NO_UNROLL _Pragma("unroll 1")
#else
#define KSWV_D inline
#define KSWV_HD inline
#define KSWV_UNROLL
#define KSWV_NO_UNROLL
#endif

#define KSWV_NO_LIMIT 0x10000   // endsc / minsc meaning "none"
#define KSWV_SWEEPS 16          // lazy-F sweeps at most per row
#define KSWV_MAX_THREADS 128    // threads per block at most
#define KSWV_FAR 0x3fffffff     // "no segment" in the split form's stop

// Called after each row's lazy-F with the number of sweeps it ran (the host
// tests count them).
#ifndef KSWV_SWEEP_HOOK
#define KSWV_SWEEP_HOOK(k)
#endif

struct KswvParams {
    int a, b, o_del, e_del, o_ins, e_ins;
};

// One launch: P problems of one precision class.  Problem p's row maxima
// live at rowmax[p * Tpad ...] (Tpad a multiple of 8), its phase rows at
// out[p * 6] and out[(P + p) * 6].
struct KswvBatch {
    const int8_t *enc;
    int64_t n_enc;
    const uint8_t *ref;
    int64_t n_ref;
    int packed;
    const int *qoff, *qdir;
    const uint8_t *qcomp;
    const int *qlen;
    const int64_t *toff;
    const int *tlen;
    int P, Qmax, Tmax, Tpad, minsc;
    KswvParams sp;
    int16_t *rowmax;
    int *out;
};

// One phase's problem: the query walk in the read grid, the target walk in
// the doubled genome, the stop score, the b-array floor and whether to run.
struct KswvDesc {
    int64_t qoff;
    int qdir, qcomp, qlen;
    int64_t toff;
    int tdir, tlen, endsc, minsc, live;
};

// What phase 1 needs of phase 0 (group-uniform).
struct KswvEnd {
    int score, te, qe, sat;
};

KSWV_D int kswv_max(int x, int y) { return x > y ? x : y; }
KSWV_D int kswv_min(int x, int y) { return x < y ? x : y; }
KSWV_D int kswv_max3(int x, int y, int z) {
#ifdef __CUDA_ARCH__
    return __vimax3_s32(x, y, z);   // one DPX instruction on sm_90
#else
    return kswv_max(kswv_max(x, y), z);
#endif
}
// the lowest set bit of x != 0
KSWV_D int kswv_ctz(int x) {
#ifdef __CUDA_ARCH__
    return __ffs(x) - 1;
#else
    return __builtin_ctz((unsigned)x);
#endif
}
// prmt (__byte_perm's PTX instruction): byte n of the result is byte
// (sel >> 4n) & 7 of hi:lo, or that byte's sign in all 8 bits where bit 3
// of the nibble is set.
KSWV_D int kswv_prmt(unsigned lo, unsigned hi, int sel) {
#ifdef __CUDA_ARCH__
    unsigned r;
    asm("prmt.b32 %0, %1, %2, %3;" : "=r"(r) : "r"(lo), "r"(hi), "r"(sel));
    return (int)r;
#else
    unsigned r = 0;
    for (int n = 0; n < 4; ++n) {
        const int k = (sel >> (4 * n)) & 7;
        unsigned x = (k < 4 ? lo >> (8 * k) : hi >> (8 * (k - 4))) & 0xffu;
        if ((sel >> (4 * n)) & 8) x = x & 0x80u ? 0xffu : 0u;
        r |= x << (8 * n);
    }
    return (int)r;
#endif
}

#ifdef __CUDACC__

// The card's group: NL lanes x S sub-threads, one int per thread, thread
// t = s * NL + l (sub-thread s of lane l).  A group of at most 32 threads
// is a run of consecutive lanes of a warp, and every crossing is a warp
// intrinsic over its threads; a larger one (the split form at S * NL > 32)
// is a whole block, whose crossings between warps go through `xch`, a
// shared-memory buffer of 2 x T ints (two halves used in turn, so that
// one barrier per exchange suffices).  A lane's NL sub-thread-s threads
// always lie in one warp.
template <int N, int S_ = 1>
struct KswvGroup {
    static constexpr int NL = N, S = S_, T = N * S_;
    static constexpr int W = T > 32 ? T / 32 : 1;      // warps
    static constexpr int WIDTH = T > 32 ? 32 : T;      // shuffle width
    using V = int;
    unsigned mask, lmask;
    int l, s, t;
    int *xch;
    mutable int half;
    __device__ explicit KswvGroup(int *x = nullptr) : xch(x), half(0) {
        const int wl = threadIdx.x & 31;
        t = W > 1 ? (int)threadIdx.x : wl & (T - 1);
        l = t & (NL - 1);
        s = t / NL;
        mask = W > 1 ? 0xffffffffu
                     : ((T == 32) ? 0xffffffffu : ((1u << T) - 1u))
                           << (wl & ~(T - 1));
        lmask = ((NL == 32) ? 0xffffffffu : ((1u << NL) - 1u))
                << (wl & ~(NL - 1));
    }
    KSWV_D int lane() const { return l; }
    KSWV_D int sub() const { return s; }
    KSWV_D bool leader() const { return t == 0; }
    KSWV_D int shfl_up0(int x) const {
        const int y = __shfl_up_sync(mask, x, 1, NL);
        return l ? y : 0;
    }
    KSWV_D bool all(bool p) const { return __all_sync(mask, p); }
    // One exchange: every thread offers x; get(src) is thread src's.
    struct Xch {
        const KswvGroup &g;
        int x;
        const int *p;
        KSWV_D int get(int src) const {
            if constexpr (W > 1)
                return p[src];
            else
                return __shfl_sync(g.mask, x, src, T);
        }
    };
    KSWV_D Xch publish(int x) const {
        if constexpr (W > 1) {
            int *p = xch + half * T;
            half ^= 1;
            p[t] = x;
            __syncthreads();
            return Xch{*this, x, p};
        } else {
            return Xch{*this, x, nullptr};
        }
    }
    KSWV_D int shfl(int x, int src) const { return publish(x).get(src); }
    KSWV_D int reduce_max(int x) const {
        const int r = __reduce_max_sync(mask, x);
        if constexpr (W > 1) {
            const Xch e = publish(r);
            int m = e.get(0);
            KSWV_UNROLL
            for (int w = 1; w < W; ++w) m = kswv_max(m, e.get(32 * w));
            return m;
        }
        return r;
    }
    KSWV_D int reduce_min(int x) const {
        const int r = __reduce_min_sync(mask, x);
        if constexpr (W > 1) {
            const Xch e = publish(r);
            int m = e.get(0);
            KSWV_UNROLL
            for (int w = 1; w < W; ++w) m = kswv_min(m, e.get(32 * w));
            return m;
        }
        return r;
    }
    // the AND over the NL lanes of this thread's sub-thread index
    KSWV_D int reduce_and_lanes(int x) const {
        return (int)__reduce_and_sync(lmask, (unsigned)x);
    }
    KSWV_D int broadcast(int x, int r) const {
        return __shfl_sync(mask, x, r, WIDTH);
    }
    KSWV_D int select(bool m, int a, int b) const { return m ? a : b; }
    template <class F>
    KSWV_D int map(F f) const { return f(l); }
    template <class F>           // f(lane, sub-thread)
    KSWV_D int map2(F f) const { return f(l, s); }
    KSWV_D int ld16(const int16_t *p) const { return p[l]; }
    KSWV_D void st16(int16_t *p, int x) const { p[l] = (int16_t)x; }
    KSWV_D int ld8(const uint8_t *p) const { return p[l]; }
    KSWV_D void st8(uint8_t *p, int x) const { p[l] = (uint8_t)x; }
    KSWV_D int prmt(unsigned lo, unsigned hi, int s) const {
        return kswv_prmt(lo, hi, s);
    }
};

#else

// The host's lane vector: one int per lane, every operation lane by lane.
template <int NL>
struct KswvLanes {
    int v[NL];
    KswvLanes() {}
    KswvLanes(int x) {   // a scalar is the same value in every lane
        for (int l = 0; l < NL; ++l) v[l] = x;
    }
    template <class F>
    static KswvLanes apply(F f) {
        KswvLanes r;
        for (int l = 0; l < NL; ++l) r.v[l] = f(l);
        return r;
    }
#define KSWV_LANE_OP(op)                                                  \
    friend KswvLanes operator op(const KswvLanes &x, const KswvLanes &y) { \
        return apply([&](int l) { return int(x.v[l] op y.v[l]); });        \
    }
    KSWV_LANE_OP(+)
    KSWV_LANE_OP(-)
    KSWV_LANE_OP(*)
    KSWV_LANE_OP(|)
    KSWV_LANE_OP(&)
    KSWV_LANE_OP(>)
    KSWV_LANE_OP(<=)
    KSWV_LANE_OP(==)
    KSWV_LANE_OP(!=)
#undef KSWV_LANE_OP
    friend KswvLanes kswv_max(const KswvLanes &x, const KswvLanes &y) {
        return apply([&](int l) { return kswv_max(x.v[l], y.v[l]); });
    }
    friend KswvLanes kswv_min(const KswvLanes &x, const KswvLanes &y) {
        return apply([&](int l) { return kswv_min(x.v[l], y.v[l]); });
    }
    friend KswvLanes kswv_max3(const KswvLanes &x, const KswvLanes &y,
                               const KswvLanes &z) {
        return apply(
            [&](int l) { return kswv_max3(x.v[l], y.v[l], z.v[l]); });
    }
    friend KswvLanes kswv_ctz(const KswvLanes &x) {
        return apply([&](int l) { return kswv_ctz(x.v[l]); });
    }
};

// The host's group: the NL x S threads stepped in lockstep (thread t =
// s * NL + l).
template <int N, int S_ = 1>
struct KswvGroup {
    static constexpr int NL = N, S = S_, T = N * S_;
    using V = KswvLanes<T>;
    explicit KswvGroup(int * = nullptr) {}
    V lane() const { return V::apply([](int t) { return t % NL; }); }
    V sub() const { return V::apply([](int t) { return t / NL; }); }
    bool leader() const { return true; }
    V shfl_up0(const V &x) const {
        return V::apply([&](int t) { return t % NL ? x.v[t - 1] : 0; });
    }
    bool all(const V &p) const {
        for (int l = 0; l < T; ++l)
            if (!p.v[l]) return false;
        return true;
    }
    struct Xch {
        V x;
        V get(const V &src) const {
            return V::apply([&](int t) { return x.v[src.v[t]]; });
        }
        int get(int src) const { return x.v[src]; }
    };
    Xch publish(const V &x) const { return Xch{x}; }
    V shfl(const V &x, const V &src) const { return publish(x).get(src); }
    int reduce_max(const V &x) const {
        int r = x.v[0];
        for (int l = 1; l < T; ++l) r = kswv_max(r, x.v[l]);
        return r;
    }
    int reduce_min(const V &x) const {
        int r = x.v[0];
        for (int l = 1; l < T; ++l) r = kswv_min(r, x.v[l]);
        return r;
    }
    V reduce_and_lanes(const V &x) const {
        return V::apply([&](int t) {
            int r = -1;
            for (int l = 0; l < NL; ++l) r &= x.v[t / NL * NL + l];
            return r;
        });
    }
    int broadcast(const V &x, int s) const { return x.v[s]; }
    V select(const V &m, const V &a, const V &b) const {
        return V::apply([&](int l) { return m.v[l] ? a.v[l] : b.v[l]; });
    }
    template <class F>
    V map(F f) const {
        return V::apply([&](int t) { return f(t % NL); });
    }
    template <class F>
    V map2(F f) const {
        return V::apply([&](int t) { return f(t % NL, t / NL); });
    }
    V ld16(const int16_t *p) const {
        return V::apply([&](int t) { return (int)p[t % NL]; });
    }
    void st16(int16_t *p, const V &x) const {
        for (int l = 0; l < T; ++l) p[l % NL] = (int16_t)x.v[l];
    }
    V ld8(const uint8_t *p) const {
        return V::apply([&](int t) { return (int)p[t % NL]; });
    }
    void st8(uint8_t *p, const V &x) const {
        for (int l = 0; l < T; ++l) p[l % NL] = (uint8_t)x.v[l];
    }
    V prmt(unsigned lo, unsigned hi, const V &s) const {
        return V::apply([&](int l) { return kswv_prmt(lo, hi, s.v[l]); });
    }
};

#endif

// The __byte_perm selector of a query code: byte `code` of the row table,
// zeros above it (u8) or its sign replicated above it (i16: nibbles 8 + k
// copy the sign of byte k).
template <bool U8, class V>
KSWV_HD V kswv_sel(const V &code) {
    if constexpr (U8)
        return code | 0x7770;
    else
        return code * 0x1111 + 0x8880;
}

// Stripes in registers: SMAX segments per lane, indexed only by the
// unrolled loops' constants.
template <class G, int SMAX, bool U8>
struct KswvRegStripes {
    using V = typename G::V;
    V h[SMAX], e[SMAX], m[SMAX], s[SMAX];
    KSWV_D V H(int j) const { return h[j]; }
    KSWV_D void setH(int j, const V &x) { h[j] = x; }
    KSWV_D V E(int j) const { return e[j]; }
    KSWV_D void setE(int j, const V &x) { e[j] = x; }
    KSWV_D V M(int j) const { return m[j]; }
    KSWV_D V sel(int j) const { return s[j]; }
    KSWV_D void set_code(int j, const V &code) { s[j] = kswv_sel<U8>(code); }
    KSWV_D void init(int) {
        KSWV_UNROLL
        for (int j = 0; j < SMAX; ++j) h[j] = e[j] = 0;
    }
    KSWV_D void keep(int) {   // Hmax = H
        KSWV_UNROLL
        for (int j = 0; j < SMAX; ++j) m[j] = h[j];
    }
};

// Stripes behind a pointer (shared memory on the card): int16 H, E and Hmax
// and uint8 query codes, each [smax segments][NL lanes].
template <class G, bool U8>
struct KswvPtrStripes {
    using V = typename G::V;
    static constexpr int NL = G::NL;
    G g;
    int16_t *h, *e, *m;
    uint8_t *s;
    KSWV_D KswvPtrStripes(const G &g_, void *base, int smax) : g(g_) {
        h = (int16_t *)base;
        e = h + smax * NL;
        m = e + smax * NL;
        s = (uint8_t *)(m + smax * NL);
    }
    KSWV_D V H(int j) const { return g.ld16(h + j * NL); }
    KSWV_D void setH(int j, const V &x) { g.st16(h + j * NL, x); }
    KSWV_D V E(int j) const { return g.ld16(e + j * NL); }
    KSWV_D void setE(int j, const V &x) { g.st16(e + j * NL, x); }
    KSWV_D V M(int j) const { return g.ld16(m + j * NL); }
    KSWV_D V sel(int j) const { return kswv_sel<U8>(g.ld8(s + j * NL)); }
    KSWV_D void set_code(int j, const V &code) { g.st8(s + j * NL, code); }
    KSWV_D void init(int slen) {
        for (int j = 0; j < slen; ++j) {
            setH(j, 0);
            setE(j, 0);
        }
    }
    KSWV_D void keep(int slen) {
        for (int j = 0; j < slen; ++j) g.st16(m + j * NL, H(j));
    }
};

// Bytes of pointer stripes per group for queries up to Qmax columns.
KSWV_HD int64_t kswv_group_bytes(int Qmax) { return (int64_t)7 * Qmax; }

// The register bucket of a launch whose longest query is Qmax (a multiple
// of 16): the least SMAX >= Qmax / nl that is instantiated, or 0 (pointer
// stripes).  KSWV_BUCKETS lists every instantiation.
#define KSWV_BUCKETS(X) \
    X(true, 8) X(true, 12) X(true, 16) X(true, 0) X(false, 16) X(false, 0)
inline int kswv_bucket(int u8, int Qmax) {
    const int s = Qmax / (u8 ? 16 : 8);
    if (u8) return s <= 8 ? 8 : s <= 12 ? 12 : s <= 16 ? 16 : 0;
    return s <= 16 ? 16 : 0;
}

// Row maxima are read eight at a time by the b-array scan.
struct alignas(16) KswvRow8 {
    int16_t v[8];
};

// The leader's end of a phase: the second best from the b-array (an
// entry merges only into the entry of the immediately preceding row; the
// first best outside te +- ceil(score / maxsc) wins) and the row of 6.
KSWV_D void kswv_write(const KswvDesc &d, const int16_t *rm, int rowstop,
                       int score, int te, int qe, int sat, int maxsc,
                       int *out) {
    int best2 = -1, te2 = -1;
    if (d.minsc <= 0xFFFF && d.live) {
        const int i2 = (score + maxsc - 1) / maxsc;
        const int low = te - i2, high = te + i2;
        bool have = false;
        int val = 0, row = -2;
        for (int i0 = 0; i0 < rowstop; i0 += 8) {
            const KswvRow8 r8 = *(const KswvRow8 *)(rm + i0);
            KSWV_UNROLL
            for (int u = 0; u < 8; ++u) {
                const int i = i0 + u, v = r8.v[u];
                if (i >= rowstop || v < d.minsc) continue;
                if (have && row + 1 == i) {
                    if (v > val) val = v, row = i;
                    continue;
                }
                if (have && (row < low || row > high) && val > best2)
                    best2 = val, te2 = row;
                val = v, row = i, have = true;
            }
        }
        if (have && (row < low || row > high) && val > best2)
            best2 = val, te2 = row;
    }
    out[0] = score;
    out[1] = te;
    out[2] = qe;
    out[3] = best2;
    out[4] = te2;
    out[5] = sat;
}

// One phase of one problem in group g with stripes st; qcap/tcap bound
// qlen/tlen to the stripes and to the row array rm.  The leader writes out
// (score te qe score2 te2 saturated).
template <int SMAX, bool U8, class G, class S>
KSWV_D KswvEnd kswv_phase(const G &g, S &st, const KswvBatch &b,
                          const KswvDesc &d, int qcap, int tcap, int16_t *rm,
                          int *out) {
    using V = typename G::V;
    constexpr int NL = G::NL;
    const KswvParams &sp = b.sp;
    // -min and max of the matrix (a, -b, -1), as build_u8 / build_i16
    const int shift = kswv_max(kswv_max(-sp.a, sp.b), 1);
    const int maxsc = kswv_max(kswv_max(sp.a, -sp.b), 1);
    const int oe_del = sp.o_del + sp.e_del, oe_ins = sp.o_ins + sp.e_ins;
    const int qlen = d.qlen < qcap ? d.qlen : qcap;
    const int tlen = d.tlen < tcap ? d.tlen : tcap;
    const int slen = (qlen + NL - 1) / NL;
    const int JN = SMAX ? SMAX : slen;

    // the profile: each lane's query codes, once per phase
    KSWV_UNROLL
    for (int j = 0; j < JN; ++j) {
        if (j < slen)
            st.set_code(j, g.map([&](int l) {
                const int c = l * slen + j;
                if (c >= qlen) return 5;                  // pad column
                int64_t qp = d.qoff + (int64_t)d.qdir * c;
                qp = qp < 0 ? 0 : (qp > b.n_enc - 1 ? b.n_enc - 1 : qp);
                int qc = b.enc[qp];
                if (d.qcomp && qc < 4) qc = 3 - qc;
                return (unsigned)qc < 4u ? qc : 4;
            }));
    }
    // the row tables: bytes 0-3 the bases, 4 ambiguous, 5 pad, 6-7 zero;
    // u8 biased by shift, i16 not
    const int bias = U8 ? shift : 0;
    const unsigned ap = (unsigned)(sp.a + bias) & 0xffu;
    const unsigned amb = (unsigned)(bias - 1) & 0xffu;
    const unsigned t_mis = ((unsigned)(bias - sp.b) & 0xffu) * 0x01010101u;
    const unsigned t_amb = amb * 0x01010101u;
    const unsigned thi = amb | ((unsigned)bias << 8);

    st.init(slen);
    // H's last segment, kept apart: selected where it is written, never
    // loaded by a run-time index (which would pin register stripes in
    // local memory)
    V last = 0;
    int gmax = 0, te = -1, rowstop = d.live ? tlen : 0;
    // target bases NL rows at a time, one row per lane, the next block
    // loaded while this one is used
    auto tload = [&](int i0) {
        return g.map([&](int l) {
            return bsw_ref_at(b.ref, b.n_ref, b.packed,
                              d.toff + (int64_t)d.tdir * (i0 + l));
        });
    };
    V tcur = 0, tnxt = 0;
    if (d.live && tlen > 0) {
        tcur = tload(0);
        tnxt = tload(NL);
    }
    for (int i = 0; d.live && i < tlen; ++i) {
        const int r = i & (NL - 1);
        const int ti = g.broadcast(tcur, r);
        if (r == NL - 1) {
            tcur = tnxt;
            tnxt = tload(i + 1 + NL);
        }
        const unsigned tlo =
            ti < 4 ? (t_mis & ~(0xffu << (8 * ti))) | (ap << (8 * ti))
                   : t_amb;
        // main pass: h = the previous row's last segment shifted up a lane
        V h = g.shfl_up0(last);
        V f = 0, mx = 0;
        KSWV_UNROLL
        for (int j = 0; j < JN; ++j) {
            if (j >= slen) continue;
            V hh = h + g.prmt(tlo, thi, st.sel(j));
            if (U8)     // subsu8(addsu8(h, sc + shift), shift), floored below
                hh = kswv_min(hh, 255) - shift;
            else        // addsi16(h, sc): saturates at 32767
                hh = kswv_min(hh, 32767);
            const V ee = st.E(j);
            hh = kswv_max3(hh, ee, f);   // E, F >= 0: the u8 floor at 0
            mx = kswv_max(mx, hh);
            h = st.H(j);                 // the old H[j]: next diagonal
            st.setH(j, hh);
            last = j == slen - 1 ? hh : last;
            st.setE(j, kswv_max3(ee - sp.e_del, hh - oe_del, 0));
            f = kswv_max3(f - sp.e_ins, hh - oe_ins, 0);
        }
        // lazy-F: carry F across the stripe boundaries, one lane a sweep;
        // the segment loops keep one exit (the guard skips the segments
        // after the vote) so that they unroll fully
        bool go = true;
        int k = 0;
        for (; go && k < KSWV_SWEEPS; ++k) {
            f = g.shfl_up0(f);
            KSWV_UNROLL
            for (int j = 0; j < JN; ++j) {
                if (!go || j >= slen) continue;
                const V hh = kswv_max(st.H(j), f);
                st.setH(j, hh);
                last = j == slen - 1 ? hh : last;
                f = kswv_max(f - sp.e_ins, 0);
                go = !g.all(f <= kswv_max(hh - oe_ins, 0));
            }
        }
        KSWV_SWEEP_HOOK(k);
        const int imax = g.reduce_max(mx);
        if (g.leader()) rm[i] = (int16_t)imax;
        if (imax > gmax) {
            gmax = imax;
            te = i;
            st.keep(slen);
            if ((U8 && gmax + shift >= 255) || gmax >= d.endsc) {
                rowstop = i + 1;
                break;
            }
        }
    }

    const int sat = U8 && d.live && gmax + shift >= 255;
    const int score = sat ? 255 : gmax;
    // qe: the least query column among the Hmax maxima, pad columns
    // included (each lane's columns l*slen + j rise with j)
    int qe = -1;
    if (d.live && te >= 0) {
        const V col0 = g.lane() * slen;
        V bv = -1, bp = INT_MAX;
        KSWV_UNROLL
        for (int j = 0; j < JN; ++j) {
            if (j >= slen) continue;
            const V v = st.M(j);
            const auto up = v > bv;
            bp = g.select(up, col0 + j, bp);
            bv = g.select(up, v, bv);
        }
        const int mv = g.reduce_max(bv);
        qe = g.reduce_min(g.select(bv == mv, bp, V(INT_MAX)));
    }
    if (g.leader()) kswv_write(d, rm, rowstop, score, te, qe, sat, maxsc, out);
    return KswvEnd{score, te, qe, sat};
}

// One phase of one problem in the split form, G::S > 1 sub-threads a
// lane (register stripes of SMAX segments): kswv_phase's cells, stop and
// output, value for value.  Lane l keeps its columns [l*slen, (l+1)*slen),
// so the stripes, and with them the row maximum taken before the lazy-F
// fixup, are kswv_phase's; its segments are cut into runs of m =
// ceil(slen / S), sub-thread s holding segments s*m .. s*m + n - 1 as its
// registers 0 .. n - 1.
//   * main pass: F into the next segment is max(F - a, b_j), a =
//     min(e_ins, oe_ins) and b_j = max(X_j - oe_ins, 0), where X_j =
//     max(sat(diag + score), E_j) is known before F; a run composes to F
//     -> max(F - n*a, B).  Pass 1 finds each run's B (F entering at
//     -inf), one exchange gives every sub-thread its lane's S values, each
//     folds those before it into its entering F (and all of them into the
//     lane's F out), and pass 2 runs its segments as kswv_phase does.
//   * lazy-F: F only decays, max(F - e_ins, 0), so a sweep's F at any
//     segment follows from the lane's entering F.  Each sub-thread votes
//     on its segments without writing them; an AND over the NL lanes of
//     the same runs and a min over the group find the first segment at
//     which every lane stops, and only the segments up to it are written.
// Per row: one exchange for the diagonal (the previous run's last H, or
// lane l-1's), one for the runs' B, a min per lazy-F sweep, the row max.
template <int SMAX, bool U8, class G, class St>
KSWV_D KswvEnd kswv_phase_split(const G &g, St &st, const KswvBatch &b,
                                const KswvDesc &d, int qcap, int tcap,
                                int16_t *rm, int *out) {
    static_assert(SMAX > 0, "the split form keeps its stripes in registers");
    using V = typename G::V;
    constexpr int NL = G::NL, S = G::S;
    const KswvParams &sp = b.sp;
    const int shift = kswv_max(kswv_max(-sp.a, sp.b), 1);
    const int maxsc = kswv_max(kswv_max(sp.a, -sp.b), 1);
    const int oe_del = sp.o_del + sp.e_del, oe_ins = sp.o_ins + sp.e_ins;
    const int fa = kswv_min(sp.e_ins, oe_ins);
    const int qlen = d.qlen < qcap ? d.qlen : qcap;
    const int tlen = d.tlen < tcap ? d.tlen : tcap;
    const int slen = (qlen + NL - 1) / NL;
    const int m = (slen + S - 1) / S;
    const int slast = m ? (slen - 1) / m : 0;   // the run holding slen - 1
    const V l = g.lane(), s = g.sub();
    const V j0 = s * m;
    const V n = kswv_min(kswv_max(slen - j0, 0), m);

    KSWV_UNROLL
    for (int jj = 0; jj < SMAX; ++jj) {
        if (jj < m)
            st.set_code(jj, g.map2([&](int ll, int ss) {
                const int j = ss * m + jj, c = ll * slen + j;
                if (j >= slen || c >= qlen) return 5;     // pad column
                int64_t qp = d.qoff + (int64_t)d.qdir * c;
                qp = qp < 0 ? 0 : (qp > b.n_enc - 1 ? b.n_enc - 1 : qp);
                int qc = b.enc[qp];
                if (d.qcomp && qc < 4) qc = 3 - qc;
                return (unsigned)qc < 4u ? qc : 4;
            }));
    }
    const int bias = U8 ? shift : 0;
    const unsigned ap = (unsigned)(sp.a + bias) & 0xffu;
    const unsigned amb = (unsigned)(bias - 1) & 0xffu;
    const unsigned t_mis = ((unsigned)(bias - sp.b) & 0xffu) * 0x01010101u;
    const unsigned t_amb = amb * 0x01010101u;
    const unsigned thi = amb | ((unsigned)bias << 8);

    st.init(slen);
    V last = 0;       // H at this run's last segment
    int gmax = 0, te = -1, rowstop = d.live ? tlen : 0;
    auto tload = [&](int i0) {
        return g.map([&](int ll) {
            return bsw_ref_at(b.ref, b.n_ref, b.packed,
                              d.toff + (int64_t)d.tdir * (i0 + ll));
        });
    };
    V tcur = 0, tnxt = 0;
    if (d.live && tlen > 0) {
        tcur = tload(0);
        tnxt = tload(NL);
    }
    // where a run's first diagonal comes from: the lane's previous run, or
    // lane l-1's run holding slen - 1 (lane 0's first run: 0)
    const V d_zero = (s == 0) & (l == 0);
    const V d_src = kswv_max(
        g.select(s > 0, (s - 1) * NL + l, slast * NL + l - 1), 0);
    for (int i = 0; d.live && i < tlen; ++i) {
        const int r = i & (NL - 1);
        const int ti = g.broadcast(tcur, r);
        if (r == NL - 1) {
            tcur = tnxt;
            tnxt = tload(i + 1 + NL);
        }
        const unsigned tlo =
            ti < 4 ? (t_mis & ~(0xffu << (8 * ti))) | (ap << (8 * ti))
                   : t_amb;
        const V h0 = g.select(d_zero, 0, g.shfl(last, d_src));
        // pass 1: the run's B
        V h = h0, B = -KSWV_FAR;
        KSWV_UNROLL
        for (int jj = 0; jj < SMAX; ++jj) {
            if (jj >= m) continue;
            V hh = h + g.prmt(tlo, thi, st.sel(jj));
            hh = U8 ? kswv_min(hh, 255) - shift : kswv_min(hh, 32767);
            B = g.select(n > jj,
                         kswv_max3(B - fa, kswv_max(hh, st.E(jj)) - oe_ins,
                                   0),
                         B);
            h = st.H(jj);
        }
        // the entering F of this run and the lane's F out
        V f = 0, fl = 0;
        {
            const auto xb = g.publish(B);
            KSWV_UNROLL
            for (int u = 0; u < S; ++u) {
                const int nu = kswv_min(kswv_max(slen - u * m, 0), m);
                fl = kswv_max(fl - nu * fa, xb.get(u * NL + l));
                f = g.select(s == u + 1, fl, f);
            }
        }
        // pass 2: kswv_phase's main pass over the run
        h = h0;
        V mx = 0;
        KSWV_UNROLL
        for (int jj = 0; jj < SMAX; ++jj) {
            if (jj >= m) continue;
            V hh = h + g.prmt(tlo, thi, st.sel(jj));
            if (U8)
                hh = kswv_min(hh, 255) - shift;
            else
                hh = kswv_min(hh, 32767);
            const V ee = st.E(jj);
            hh = kswv_max3(hh, ee, f);
            mx = g.select(n > jj, kswv_max(mx, hh), mx);
            h = st.H(jj);
            st.setH(jj, hh);
            last = g.select(n == jj + 1, hh, last);
            st.setE(jj, kswv_max3(ee - sp.e_del, hh - oe_del, 0));
            f = kswv_max3(f - sp.e_ins, hh - oe_ins, 0);
        }
        // lazy-F: sweep k enters lane l with lane l-1's F
        V fin = g.shfl_up0(fl);
        bool go = true;
        int k = 0;
        for (; go && k < KSWV_SWEEPS; ++k) {
            if (k) fin = g.shfl_up0(kswv_max(fin - slen * sp.e_ins, 0));
            const V f0 = kswv_max(fin - j0 * sp.e_ins, 0);
            V fv = f0, votes = 0;
            KSWV_UNROLL
            for (int jj = 0; jj < SMAX; ++jj) {
                if (jj >= m) continue;
                const V hh = kswv_max(st.H(jj), fv);
                fv = kswv_max(fv - sp.e_ins, 0);
                votes = votes | g.select((n > jj) & (fv <= kswv_max(
                                                         hh - oe_ins, 0)),
                                         1 << jj, 0);
            }
            const V all = g.reduce_and_lanes(votes);
            const int stop = g.reduce_min(
                g.select(all != 0, j0 + kswv_ctz(all | (all == 0)),
                         KSWV_FAR));
            fv = f0;
            KSWV_UNROLL
            for (int jj = 0; jj < SMAX; ++jj) {
                if (jj >= m) continue;
                const V hh = kswv_max(st.H(jj), fv);
                const V up = j0 + jj <= stop;
                st.setH(jj, g.select(up, hh, st.H(jj)));
                last = g.select(up & (n == jj + 1), hh, last);
                fv = kswv_max(fv - sp.e_ins, 0);
            }
            go = stop == KSWV_FAR;
        }
        KSWV_SWEEP_HOOK(k);
        const int imax = g.reduce_max(mx);
        if (g.leader()) rm[i] = (int16_t)imax;
        if (imax > gmax) {
            gmax = imax;
            te = i;
            st.keep(slen);
            if ((U8 && gmax + shift >= 255) || gmax >= d.endsc) {
                rowstop = i + 1;
                break;
            }
        }
    }

    const int sat = U8 && d.live && gmax + shift >= 255;
    const int score = sat ? 255 : gmax;
    int qe = -1;
    if (d.live && te >= 0) {
        const V col0 = l * slen + j0;
        V bv = -1, bp = INT_MAX;
        KSWV_UNROLL
        for (int jj = 0; jj < SMAX; ++jj) {
            if (jj >= m) continue;
            const V v = g.select(n > jj, st.M(jj), -1);
            const auto up = v > bv;
            bp = g.select(up, col0 + jj, bp);
            bv = g.select(up, v, bv);
        }
        const int mv = g.reduce_max(bv);
        qe = g.reduce_min(g.select(bv == mv, bp, V(INT_MAX)));
    }
    if (g.leader()) kswv_write(d, rm, rowstop, score, te, qe, sat, maxsc, out);
    return KswvEnd{score, te, qe, sat};
}

// One phase in group g: the split form where G::S > 1, else kswv_phase.
template <int SMAX, bool U8, class G, class St>
KSWV_D KswvEnd kswv_one_phase(const G &g, St &st, const KswvBatch &b,
                              const KswvDesc &d, int qcap, int tcap,
                              int16_t *rm, int *out) {
    if constexpr (G::S > 1)
        return kswv_phase_split<SMAX, U8>(g, st, b, d, qcap, tcap, rm, out);
    else
        return kswv_phase<SMAX, U8>(g, st, b, d, qcap, tcap, rm, out);
}

// Both phases of problem p: phase 0 forward with the b-array floor minsc,
// then phase 1 on the reversed prefixes that end at the phase-0 end,
// stopping at the phase-0 score, when phase 0 found a score >= minsc that
// did not saturate.  Phase 1's descriptors never leave the group.
template <int SMAX, bool U8, class G, class S>
KSWV_D void kswv_both(const G &g, S &st, const KswvBatch &b, int p,
                      int qcap) {
    const int64_t qoff = b.qoff[p], toff = b.toff[p];
    const int qdir = b.qdir[p], qcomp = b.qcomp[p];
    int16_t *rm = b.rowmax + (int64_t)p * b.Tpad;
    int *out = b.out + (int64_t)p * 6;
    KswvDesc d{qoff, qdir,       qcomp,         b.qlen[p], toff,
               1,    b.tlen[p], KSWV_NO_LIMIT, b.minsc,   1};
    KSWV_NO_UNROLL
    for (int ph = 0; ph < 2; ++ph) {
        const KswvEnd r =
            kswv_one_phase<SMAX, U8>(g, st, b, d, qcap, b.Tmax, rm, out);
        const int want =
            !r.sat && r.score >= b.minsc && r.te >= 0 && r.qe >= 0;
        d = KswvDesc{qoff + (int64_t)qdir * r.qe, -qdir, qcomp,
                     want ? r.qe + 1 : 0,         toff + r.te,
                     -1,                          want ? r.te + 1 : 0,
                     r.score,                     KSWV_NO_LIMIT,
                     want};
        out += (int64_t)b.P * 6;
    }
}

// The stripes of a launch in group g: registers (SMAX > 0) or `stripes`,
// the group's kswv_group_bytes(Qmax) bytes (SMAX = 0); body(st, qcap)
// runs with them and the query length they hold.
template <bool U8, int SMAX, class G, class F>
KSWV_D void kswv_with_stripes(const G &g, const KswvBatch &b, void *stripes,
                              F body) {
    constexpr int NL = G::NL, Q = SMAX * NL * G::S;
    if constexpr (SMAX > 0) {
        KswvRegStripes<G, SMAX, U8> st;
        body(st, b.Qmax < Q ? b.Qmax : Q);
    } else {
        KswvPtrStripes<G, U8> st(g, stripes, b.Qmax / NL);
        body(st, b.Qmax);
    }
}

// Both phases of problem p in group g (the kswv kernel).
template <bool U8, int SMAX, class G>
KSWV_D void kswv_run(const G &g, const KswvBatch &b, int p, void *stripes) {
    kswv_with_stripes<U8, SMAX>(g, b, stripes, [&](auto &st, int qcap) {
        kswv_both<SMAX, U8>(g, st, b, p, qcap);
    });
}

// What one phase takes per problem beyond the batch's descriptors: the
// target's walk direction, the stop score (KSWV_NO_LIMIT: none) and
// whether the problem runs (bwamem2_tpu/ops/kswv.py:kswv_kernel's tdir,
// endsc and do_lane).
struct KswvPhaseArgs {
    const int *tdir, *endsc;
    const uint8_t *live;
};

// One phase of problem p in group g with the caller's tdir, endsc and
// live and the batch's minsc (the kswv_phase kernel): its row of 6 at
// b.out[p * 6].
template <bool U8, int SMAX, class G>
KSWV_D void kswv_run_phase(const G &g, const KswvBatch &b,
                           const KswvPhaseArgs &a, int p, void *stripes) {
    // the descriptor is read before the stripes exist: read inside the
    // stripes' scope, ptxas spilled 8 bytes of the u8 SMAX = 12 kernel
    const KswvDesc d{b.qoff[p], b.qdir[p],  b.qcomp[p], b.qlen[p],
                     b.toff[p], a.tdir[p],  b.tlen[p],  a.endsc[p],
                     b.minsc,   a.live[p]};
    int16_t *rm = b.rowmax + (int64_t)p * b.Tpad;
    int *out = b.out + (int64_t)p * 6;
    kswv_with_stripes<U8, SMAX>(g, b, stripes, [&](auto &st, int qcap) {
        kswv_one_phase<SMAX, U8>(g, st, b, d, qcap, b.Tmax, rm, out);
    });
}

// Banded Smith-Waterman extension of one pair (ksw_extend2 semantics), run
// by one lane group: the body of the bsw_extend CUDA kernel (bsw_extend.cu).
//
// Behavioral spec: bandedSWA.cpp:116-237, the scalar row loop that the
// port's host kernel (native/core.cpp:bsw_extend) runs, with the two
// differences that keep it identical to the descriptor kernels of the JAX
// package and to ops/bsw.py:bsw_desc_ref, the output it is held against:
//   * q and t are gathered from descriptors (read grid `enc`, doubled genome
//     `ref` through bsw_ref_at), out-of-range positions clamped;
//   * the score is arithmetic (match a, mismatch -b, any N -1), the
//     structure bwa_fill_scmat always gives, and max_sc is passed in.
//
// The lane group.  G lanes run one pair; lane l owns the C consecutive
// query columns l*C ... l*C+C-1 (G*C >= qlen+1, so column qlen, the band's
// end slot, has an owner).  Each lane keeps its columns' H, E and query
// codes in registers for the whole pair.  H keeps the scalar kernel's
// column-shifted storage: entering row i, H[j] = H(i-1, j-1), and columns
// outside the band keep what the scalar loop leaves there.  A row is
// computed for all columns at once, as bsw_desc_ref does across its grid:
//   * M and E of a column depend only on the previous row: per lane;
//   * F is a max-plus prefix with linear decay, f[j+1] = max(f[j] - e_ins,
//     relu(M[j] - oe_ins)), 0 at the band start: each lane runs the
//     recurrence over its columns from 0 to get its carry, an inclusive
//     scan of the carries over the lanes (lane k back decays by k*C*e_ins,
//     log2 G shuffles) gives the F entering each lane, and a second
//     in-lane pass computes the columns' F;
//   * H(i, j) goes to the next column's slot; a lane's last column crosses
//     to lane l+1 by one shuffle;
//   * the row maximum (rightmost tie), the band shrink (first non-zero
//     column of [beg, end), last of [beg, end]) and H at the band's end
//     are reductions or a broadcast.
// What crosses lanes goes through the group interface:
//   lane()              this lane's index
//   shfl_up(x, k)       lane l-k's x (lanes below k keep their own)
//   shfl_down(x, k)     lane l+k's x (lanes above G-1-k keep their own;
//                       the sheared kernel's frame shift, shear_group.cuh)
//   broadcast(x, s)     lane s's x (the row's target base, H at `end`)
//   reduce_max/min(x)   over the lanes
//   select(m, a, b)     per lane
//   map(f)              f(lane) per lane (the query and target loads)
//   prmt(lo, hi, s)     per-lane byte permute (the row's score table)
//   leader()            lane 0: writes the output row
// It has two implementations: on the card (__CUDACC__) one int per thread
// and warp intrinsics over the group's lanes; in host C++ the G lanes as an
// int[G] lane vector stepped in lockstep (leader() is always true there).
// The kernel and the host tests compile this one source.  Every branch
// that ends a loop is decided from reduced or broadcast values, so the
// shuffles never run under a diverged group.
//
// Registers only.  Every column loop runs C times, fully unrolled, its
// body guarded by the band's lane-local bounds, so no register array is
// indexed at run time (which would put it in local memory without any
// spill being reported).  G and C are compile-time buckets (BSW_BUCKETS),
// chosen per launch from the batch's longest query.
//
// Scores.  Each lane keeps a column's query code as a __byte_perm selector
// (0-3 bases, 4 ambiguous or past the query, 5 a negative code); each row
// builds from its target base an 8-byte table of score + bias, so a cell's
// score is one byte permute and the bias folds into the add.  The table
// needs a + max(b, 1) <= 255 (the wrapper checks it).

#pragma once

#include <math.h>
#include <stdint.h>

#include "bsw_common.cuh"

#ifdef __CUDACC__
#define BSW_D __device__ __forceinline__
#define BSW_UNROLL _Pragma("unroll")
#else
#define BSW_D inline
#define BSW_UNROLL
#endif

#define BSW_MAX_THREADS 128     // threads per block at most
#define BSW_FAR 0x3fffffff      // "no column" in the first-column minimum

// Called where pair p's row loop stops early: why = 0 on a zero row
// maximum, 1 on z-drop (the host tests count them).
#ifndef BSW_STOP_HOOK
#define BSW_STOP_HOOK(p, why)
#endif

// One launch: P pairs, pair p's output row at out[p * 6].
struct BswBatch {
    const int8_t *enc;
    int64_t n_enc;
    const uint8_t *ref;
    int64_t n_ref;
    int packed;
    const int *qoff, *qdir, *qlen;
    const int64_t *toff;
    const int *tdir, *tlen, *h0, *w;
    int P;
    BswParams sp;
    int *out;
};

// The (G, C) instantiations, by rising column capacity G*C.  A launch's
// time grows with G*C at the main path's sizes, and at equal capacity
// fewer lanes spend less on the per-row scan and reductions, down to 8
// lanes (chip_smoke.py's phase 5a shows each launch's bucket and time).
#define BSW_BUCKETS(X)                                                    \
    X(8, 4) X(8, 8) X(16, 6) X(16, 8) X(32, 5) X(32, 6) X(32, 8) X(32, 10) \
    X(32, 12)

// The bucket of a launch whose longest query is Qmax: the first whose G*C
// columns hold 0..Qmax.  Returns 0 when none does.
inline int bsw_bucket(int Qmax, int *G, int *C) {
#define BSW_PICK(g, c)           \
    if (Qmax + 1 <= (g) * (c)) { \
        *G = (g);                \
        *C = (c);                \
        return 1;                \
    }
    BSW_BUCKETS(BSW_PICK)
#undef BSW_PICK
    return 0;
}

BSW_D int bsw_max(int x, int y) { return x > y ? x : y; }
BSW_D int bsw_min(int x, int y) { return x < y ? x : y; }
BSW_D int bsw_max3(int x, int y, int z) {
#ifdef __CUDA_ARCH__
    return __vimax3_s32(x, y, z);     // one DPX instruction on sm_90
#else
    return bsw_max(bsw_max(x, y), z);
#endif
}
// max(x + y, z)
BSW_D int bsw_addmax(int x, int y, int z) {
#ifdef __CUDA_ARCH__
    return __viaddmax_s32(x, y, z);   // one DPX instruction on sm_90
#else
    return bsw_max(x + y, z);
#endif
}
// lowest / highest set bit of a non-zero x
BSW_D int bsw_ctz(int x) {
#ifdef __CUDA_ARCH__
    return __ffs(x) - 1;
#else
    return x ? __builtin_ctz((unsigned)x) : 32;
#endif
}
BSW_D int bsw_msb(int x) {
#ifdef __CUDA_ARCH__
    return 31 - __clz(x);
#else
    return x ? 31 - __builtin_clz((unsigned)x) : -1;
#endif
}
// __byte_perm: byte n of the result is byte (sel >> 4n) & 7 of hi:lo.
BSW_D int bsw_prmt(unsigned lo, unsigned hi, int sel) {
#ifdef __CUDA_ARCH__
    return (int)__byte_perm(lo, hi, (unsigned)sel);
#else
    unsigned r = 0;
    for (int n = 0; n < 4; ++n) {
        const int k = (sel >> (4 * n)) & 7;
        r |= ((k < 4 ? lo >> (8 * k) : hi >> (8 * (k - 4))) & 0xffu)
             << (8 * n);
    }
    return (int)r;
#endif
}

#define BSW_SEL(code) ((code) | 0x7770)   // byte `code`, zeros above

#ifdef __CUDACC__

// The card's group: G consecutive lanes of a warp, one int per thread.
template <int N>
struct BswGroup {
    static constexpr int G = N;
    using V = int;
    unsigned mask;
    int l;
    __device__ BswGroup() {
        const int wl = threadIdx.x & 31;
        l = wl & (G - 1);
        mask = ((G == 32) ? 0xffffffffu : ((1u << G) - 1u))
               << (wl & ~(G - 1));
    }
    BSW_D int lane() const { return l; }
    BSW_D bool leader() const { return l == 0; }
    BSW_D int shfl_up(int x, int k) const {
        return __shfl_up_sync(mask, x, k, G);
    }
    BSW_D int shfl_down(int x, int k) const {
        return __shfl_down_sync(mask, x, k, G);
    }
    BSW_D int broadcast(int x, int s) const {
        return __shfl_sync(mask, x, s, G);
    }
    BSW_D int reduce_max(int x) const { return __reduce_max_sync(mask, x); }
    BSW_D int reduce_min(int x) const { return __reduce_min_sync(mask, x); }
    BSW_D int select(bool m, int a, int b) const { return m ? a : b; }
    template <class F>
    BSW_D int map(F f) const { return f(l); }
    BSW_D int prmt(unsigned lo, unsigned hi, int s) const {
        return bsw_prmt(lo, hi, s);
    }
};

#else

// The host's lane vector: one int per lane, every operation lane by lane.
template <int G>
struct BswLanes {
    int v[G];
    BswLanes() {}
    BswLanes(int x) {   // a scalar is the same value in every lane
        for (int l = 0; l < G; ++l) v[l] = x;
    }
    template <class F>
    static BswLanes apply(F f) {
        BswLanes r;
        for (int l = 0; l < G; ++l) r.v[l] = f(l);
        return r;
    }
#define BSW_LANE_OP(op)                                                 \
    friend BswLanes operator op(const BswLanes &x, const BswLanes &y) { \
        return apply([&](int l) { return int(x.v[l] op y.v[l]); });     \
    }
    BSW_LANE_OP(+)
    BSW_LANE_OP(-)
    BSW_LANE_OP(*)
    BSW_LANE_OP(&)
    BSW_LANE_OP(|)
    BSW_LANE_OP(<<)
    BSW_LANE_OP(==)
    BSW_LANE_OP(!=)
    BSW_LANE_OP(<)
    BSW_LANE_OP(<=)
    BSW_LANE_OP(>)
    BSW_LANE_OP(>=)
#undef BSW_LANE_OP
#define BSW_LANE_FN(fn)                                                  \
    friend BswLanes fn(const BswLanes &x, const BswLanes &y) {           \
        return apply([&](int l) { return fn(x.v[l], y.v[l]); });         \
    }
    BSW_LANE_FN(bsw_max)
    BSW_LANE_FN(bsw_min)
#undef BSW_LANE_FN
    friend BswLanes bsw_max3(const BswLanes &x, const BswLanes &y,
                             const BswLanes &z) {
        return apply([&](int l) { return bsw_max3(x.v[l], y.v[l], z.v[l]); });
    }
    friend BswLanes bsw_addmax(const BswLanes &x, const BswLanes &y,
                               const BswLanes &z) {
        return apply(
            [&](int l) { return bsw_addmax(x.v[l], y.v[l], z.v[l]); });
    }
    friend BswLanes bsw_ctz(const BswLanes &x) {
        return apply([&](int l) { return bsw_ctz(x.v[l]); });
    }
    friend BswLanes bsw_msb(const BswLanes &x) {
        return apply([&](int l) { return bsw_msb(x.v[l]); });
    }
};

// The host's group: the G lanes stepped in lockstep.
template <int N>
struct BswGroup {
    static constexpr int G = N;
    using V = BswLanes<G>;
    V lane() const { return V::apply([](int l) { return l; }); }
    bool leader() const { return true; }
    V shfl_up(const V &x, int k) const {
        return V::apply([&](int l) { return l >= k ? x.v[l - k] : x.v[l]; });
    }
    V shfl_down(const V &x, int k) const {
        return V::apply(
            [&](int l) { return l + k < G ? x.v[l + k] : x.v[l]; });
    }
    int broadcast(const V &x, int s) const { return x.v[s]; }
    int reduce_max(const V &x) const {
        int r = x.v[0];
        for (int l = 1; l < G; ++l) r = bsw_max(r, x.v[l]);
        return r;
    }
    int reduce_min(const V &x) const {
        int r = x.v[0];
        for (int l = 1; l < G; ++l) r = bsw_min(r, x.v[l]);
        return r;
    }
    V select(const V &m, const V &a, const V &b) const {
        return V::apply([&](int l) { return m.v[l] ? a.v[l] : b.v[l]; });
    }
    template <class F>
    V map(F f) const { return V::apply(f); }
    V prmt(unsigned lo, unsigned hi, const V &s) const {
        return V::apply([&](int l) { return bsw_prmt(lo, hi, s.v[l]); });
    }
};

#endif

// Pair p of the batch in group g, C columns per lane.  The leader writes
// out (score qle tle gtle gscore max_off).
template <int C, class Grp>
BSW_D void bsw_group_pair(const Grp &g, const BswBatch &b, int p) {
    using V = typename Grp::V;
    constexpr int G = Grp::G;
    const BswParams &sp = b.sp;
    const int oe_del = sp.o_del + sp.e_del, oe_ins = sp.o_ins + sp.e_ins;
    // qlen < G*C is the launch's contract (the bucket holds the batch's
    // longest query); the clamp keeps a broken descriptor in the lanes
    const int qlen = b.qlen[p] < G * C - 1 ? b.qlen[p] : G * C - 1;
    const int64_t qoff = b.qoff[p], toff = b.toff[p];
    const int qdir = b.qdir[p], tdir = b.tdir[p], tlen = b.tlen[p];
    const int h0 = b.h0[p];

    // clamp the band in double, exactly as bsw.py (bandedSWA.cpp:147-156)
    int max_ins = (int)floor(
        (double)(qlen * sp.max_sc + sp.end_bonus - sp.o_ins) / sp.e_ins + 1.0);
    int max_del = (int)floor(
        (double)(qlen * sp.max_sc + sp.end_bonus - sp.o_del) / sp.e_del + 1.0);
    max_ins = max_ins > 1 ? max_ins : 1;
    max_del = max_del > 1 ? max_del : 1;
    int w = b.w[p];
    w = w < max_ins ? w : max_ins;
    w = w < max_del ? w : max_del;

    // the first row (bandedSWA.cpp:139-146) and the query codes, once
    const V col0 = g.lane() * C;
    V H[C], E[C], S[C];
    BSW_UNROLL
    for (int c = 0; c < C; ++c) {
        const V j = col0 + c;
        H[c] = g.select(j == 0, V(h0),
                        g.select(j <= qlen,
                                 bsw_max(h0 - oe_ins - (j - 1) * sp.e_ins, 0),
                                 0));
        E[c] = 0;
        S[c] = g.map([&](int l) {
            const int jj = l * C + c;
            int code = 4;             // past the query: the reference's pad
            if (jj < qlen) {
                int64_t qp = qoff + (int64_t)qdir * jj;
                qp = qp < 0 ? 0 : (qp > b.n_enc - 1 ? b.n_enc - 1 : qp);
                const int qc = b.enc[qp];
                code = qc < 0 ? 5 : (qc < 4 ? qc : 4);
            }
            return BSW_SEL(code);
        });
    }
    // the row's score table: bytes 0-3 the bases, 4 ambiguous, 5 negative
    // codes, 6-7 zero; each score + bias
    const int bias = sp.b > 1 ? sp.b : 1;
    const unsigned t_mis = (unsigned)(bias - sp.b);
    const unsigned t_amb = (unsigned)(bias - 1);
    const unsigned t_hit = (unsigned)(sp.a + bias);

    // target bases G rows at a time, one row per lane, the next block
    // loaded while this one is used
    auto tload = [&](int i0) {
        return g.map([&](int l) {
            return bsw_ref_at(b.ref, b.n_ref, b.packed,
                              toff + (int64_t)tdir * (i0 + l));
        });
    };
    V tcur = 0, tnxt = 0;
    if (tlen > 0) {
        tcur = tload(0);
        tnxt = tload(G);
    }

    int max = h0, max_i = -1, max_j = -1, max_ie = -1, gscore = -1;
    int max_off = 0, beg = 0, end = qlen;
    for (int i = 0; i < tlen; ++i) {
        const int r = i & (G - 1);
        const int ti = g.broadcast(tcur, r);
        if (r == G - 1) {
            tcur = tnxt;
            tnxt = tload(i + 1 + G);
        }
        if (beg < i - w) beg = i - w;
        if (end > i + w + 1) end = i + w + 1;
        if (end > qlen) end = qlen;
        const int h1_0 =
            beg == 0 ? bsw_max(h0 - (sp.o_del + sp.e_del * (i + 1)), 0) : 0;
        const unsigned tlo =
            ti < 4 ? ((t_mis * 0x01010101u) & ~(0xffu << (8 * ti)))
                         | (t_hit << (8 * ti))
                   : t_amb * 0x01010101u;
        const unsigned thi = t_amb | ((ti < 4 ? t_mis : t_amb) << 8);
        // this lane's columns c in [lo, hi) are in the band, c == hi is
        // its end slot
        const V lo = beg - col0, hi = end - col0;

        // pass 1: the diagonal input M and F's gap-open term U per column
        // (0 left of the band, so F is 0 at its start); fc is F carried
        // out of the lane when it enters with 0
        V M[C], U[C];
        V fc = 0;
        BSW_UNROLL
        for (int c = 0; c < C; ++c) {
            // H[c] holds H(i-1, j-1); no restart through a zero H
            M[c] = g.select(H[c] != 0, H[c] + g.prmt(tlo, thi, S[c]) - bias,
                            0);
            U[c] = g.select(lo <= c, bsw_addmax(M[c], -oe_ins, 0), 0);
            fc = bsw_addmax(fc, -sp.e_ins, U[c]);
        }
        // F entering each lane: scan the carries over the lanes
        BSW_UNROLL
        for (int k = 1; k < G; k <<= 1) {
            const V y = g.shfl_up(fc, k);
            fc = g.select(g.lane() >= k, bsw_addmax(y, -k * C * sp.e_ins, fc),
                          fc);
        }
        V f = g.shfl_up(fc, 1);
        f = g.select(g.lane() == 0, 0, f);

        // pass 2: H = max(M, E, F) in the band (0 outside it); slots beg
        // to end take H(i, j-1) (0 at beg, h1_0 there when beg is 0, set
        // below); E(i+1, j) in the band, 0 at the end slot; the lane's row
        // maximum (rightmost tie) and its non-zero slots
        V bv = 0, bc = -1, bits = 0, hlast = 0;
        BSW_UNROLL
        for (int c = 0; c < C; ++c) {
            const V inb = (lo <= c) & (c < hi);
            const V h = g.select(inb, bsw_max3(M[c], E[c], f), 0);
            const V up = h >= bv;
            bv = g.select(up, h, bv);
            bc = g.select(up, col0 + c, bc);
            if (c + 1 < C)
                H[c + 1] = g.select((lo <= c + 1) & (c < hi), h, H[c + 1]);
            else
                hlast = h;
            const V e = bsw_max(E[c] - sp.e_del, bsw_addmax(M[c], -oe_del, 0));
            E[c] = g.select(inb, e, g.select(c == hi, 0, E[c]));
            f = bsw_addmax(f, -sp.e_ins, U[c]);
            if (c > 0) bits = bits | g.select((H[c] | E[c]) != 0, 1 << c, 0);
        }
        // slot 0 takes the previous lane's last H (lane 0: h1_0)
        const V hin = g.select(g.lane() == 0, h1_0, g.shfl_up(hlast, 1));
        H[0] = g.select((lo <= 0) & (hi >= 0), hin, H[0]);
        bits = bits | g.select((H[0] | E[0]) != 0, 1, 0);

        const int row_m = g.reduce_max(bv);
        const int mj = g.reduce_max(g.select(bv == row_m, bc, -1));
        if (end == qlen) {               // the row reached the query's end
            V v = 0;                     // h1 = H[end], from its owner lane
            BSW_UNROLL
            for (int c = 0; c < C; ++c) v = g.select(hi == c, H[c], v);
            const int h1 = g.broadcast(v, end / C);
            max_ie = gscore > h1 ? max_ie : i;
            gscore = gscore > h1 ? gscore : h1;
        }
        if (row_m == 0) {
            BSW_STOP_HOOK(p, 0);
            break;
        }
        if (row_m > max) {
            max = row_m, max_i = i, max_j = mj;
            const int off = mj > i ? mj - i : i - mj;
            max_off = max_off > off ? max_off : off;
        } else if (sp.zdrop > 0) {
            const int z =
                i - max_i > mj - max_j
                    ? max - row_m - ((i - max_i) - (mj - max_j)) * sp.e_del
                    : max - row_m - ((mj - max_j) - (i - max_i)) * sp.e_ins;
            if (z > sp.zdrop) {
                BSW_STOP_HOOK(p, 1);
                break;
            }
        }
        // shrink the band to the non-zero region: beg to the first
        // non-zero slot of [beg, end), then end past the last of [beg_new,
        // end] (the slots of [beg, beg_new) are all zero)
        const V clo = bsw_min(bsw_max(lo, 0), C);
        const V below = (1 << clo) - 1;
        const V band = (1 << bsw_min(bsw_max(hi, 0), C)) - 1 - below;
        const V bandE = (1 << bsw_min(bsw_max(hi + 1, 0), C)) - 1 - below;
        const V nb = bits & band, nbE = bits & bandE;
        const int first =
            g.reduce_min(g.select(nb != 0, col0 + bsw_ctz(nb), BSW_FAR));
        const int last =
            g.reduce_max(g.select(nbE != 0, col0 + bsw_msb(nbE), -1));
        beg = first < end ? first : end;
        end = bsw_min(bsw_max(last, beg - 1) + 2, qlen);
    }
    if (g.leader()) {
        int *out = b.out + (int64_t)p * 6;
        out[0] = max;
        out[1] = max_j + 1;
        out[2] = max_i + 1;
        out[3] = max_ie + 1;
        out[4] = gscore;
        out[5] = max_off;
    }
}

// Sheared-band Smith-Waterman extension of one long pair (ksw_extend2
// semantics): the bodies of the bsw_shear CUDA kernel (bsw_shear.cu).
//
// Behavioral spec: the same rows as bsw_group.cuh (bandedSWA.cpp:116-237,
// with the query and target gathered from descriptors and the arithmetic
// score), held against ops/bsw.py:bsw_shear_desc_ref, the port of
// bwamem2_tpu's _bsw_shear_dp.  A long pair (qlen up to 32768, tlen
// unbounded) only ever computes the band [i - w, i + w] of row i, so the
// DP state is a frame of band offsets instead of the query: frame slot u
// at row i holds query column j = i - Wh - 1 + u, where Wh >= w is the
// launch's band radius.  The frame has F >= 2*Wh + 3 slots, so the band
// and its end slot lie in slots 1 .. 2*Wh + 2 and the column entering at
// the right after row i (i + F - Wh - 1) is one no row has written yet
// (row i writes up to column i + w + 1).
//
// The shear.  Moving to row i+1 moves the frame one column right, so
// frame slot u of row i+1 is slot u+1 of row i.  The diagonal step
// (i-1, j-1) -> (i, j) becomes vertical: bsw_group.cuh's column-shifted H
// (H[j] = H(i-1, j-1) entering a row) keeps its slot from row to row,
// where the row writes it (H(i, j-1) for j in [beg, end], h1_0 at beg);
// every other cell, E and the query codes move one slot left.  Lane l of
// a group owns slots l*C .. l*C+C-1; a slot's left move is a register
// move inside the lane and, for the lane's last slot, the next lane's
// first.  The group's last lane takes the entering column: its row-0 H
// (h0 decaying along the query, 0 past qlen), E 0 and its query code.
//
// Two bodies, each run by one warp (BswGroup<32>):
//   * shear_pair_i32: int32 slots, C per lane; everything crossing lanes
//     is a shuffle or a warp reduction.  With CT = 0 (the shared-memory
//     frame) C is chosen at run time and the slot arrays lie in memory
//     (ShearSlots<V, 0>: shared memory on the card, slot c of lane l at
//     c*32 + l), for bands wider than the register buckets.
//   * shear_pair_s16: two 16-bit slots per register, for the pairs whose
//     every value fits 16 bits (the launcher's test, ops/bsw_shear_cuda.py:
//     BswShear.fits16): the DPX 16x2 forms do two cells per instruction.
//     Register r of a lane holds its slots r (low half) and R + r (high
//     half), so the F prefix runs as two chains in step (the high chain
//     enters with the low chain's carry, which pass 1 gives), the frame
//     shift moves whole registers but the last (one byte permute and one
//     shuffle), and the row maximum is __vibmax_s16x2 with the rightmost
//     tie.  Scores come from a per-row table of signed bytes, sign-
//     extended into each half by the selector (prmt's sign mode).  Band
//     masks are 0/0xffff per half, built with one DPX min and one
//     multiply each.  Its band-shrink scan takes each lane's own first E
//     (which lands in the previous lane's last slot) as a candidate, so
//     the scan need not wait for the next lane's E.
// A row, per lane, in frame slots:
//   * pass 1: M (the diagonal input; no restart through a zero H) and F's
//     gap-open term per slot, the lane's F carry; a log2(32)-step shuffle
//     scan of the carries (the F prefix max with linear decay,
//     bsw_group.cuh);
//   * pass 2: H = max(M, E, F) in the band, the lane's row maximum
//     (rightmost tie), E after the row, and the shifted frame written in
//     place: H from this row's h or the next slot's old value, E from the
//     next slot's E after the row;
//   * reductions for the row maximum and the band shrink (first non-zero
//     slot of [beg, end), last of [beg, end], in the shifted frame) and H
//     at the band's end; the slot results are turned into columns by
//     adding the frame's origin.
// The row's target base and the entering column's query code come from
// one load per lane every 32 rows, broadcast a row at a time.
//
// On the card a lane is a thread; in host C++ (the tests compile this
// source with g++) the 32 lanes are one lane vector stepped in lockstep,
// the DPX 16x2 operations computed half by half.

#pragma once

#include "bsw_group.cuh"

// Called where pair p's row loop stops early: why = 0 on a zero row
// maximum, 1 on z-drop (the host tests count them).
#ifndef SHEAR_STOP_HOOK
#define SHEAR_STOP_HOOK(p, why)
#endif

// One launch: pairs [p0, P), pair p's output row at out[p * 6]; the band
// radius Wh (>= every pair's w), the row cap Tmax and the memory frame's
// slots per lane C.  When n16 is set (a count on the card, which the host
// never reads), the 16-bit body's kernel runs pairs [p0, *n16) and the
// int32 body's [*n16, P), each launched for all of them.
struct ShearBatch {
    const int8_t *enc;
    int64_t n_enc;
    const uint8_t *ref;
    int64_t n_ref;
    int packed;
    const int *qoff, *qdir, *qlen;
    const int64_t *toff;
    const int *tdir, *tlen, *h0, *w;
    int p0, P, Wh, Tmax, C;
    BswParams sp;
    int *out;
    const int *n16;
};

#define SHEAR_G 32   // lanes per pair: one warp

// The register buckets, by rising frame: X(C, R).  C int32 slots per lane:
// a frame of 32*C slots takes band radii up to (32*C - 3) / 2 (110, 206),
// the default -w 100 and its band-doubling retry at 200; R registers of
// two 16-bit slots per lane (64*R: 256, 448) hold at least the same frame.
// Wider bands take the memory frame, whose five slot arrays (H, E, query
// codes, M, U) take 5 * 32 * C ints of shared memory: up to 363 slots per
// lane in 227 KB, band radii up to 5806.
#define SHEAR_BUCKETS(X) X(7, 4) X(13, 7)
#define SHEAR_ARRAYS 5
#define SHEAR_WIDE_MAX_C 363

// The launch for band radius Wh: returns the register bucket's C, or 0
// for the memory frame, and sets *C, the int32 slots per lane (the least
// whose frame holds 2*Wh + 3 slots); -1 when none does.
inline int shear_bucket(int Wh, int *C) {
    if (Wh < 0) return -1;
#define SHEAR_PICK(c, r)                           \
    static_assert(2 * (r) >= (c), "frame");        \
    if (2 * Wh + 3 <= SHEAR_G * (c)) {             \
        *C = (c);                                  \
        return (c);                                \
    }
    SHEAR_BUCKETS(SHEAR_PICK)
#undef SHEAR_PICK
    const int c = (2 * Wh + 3 + SHEAR_G - 1) / SHEAR_G;
    if (c > SHEAR_WIDE_MAX_C) return -1;
    *C = c;
    return 0;
}

// A pair's slot array: CT registers per lane, or for CT = 0 C slots in
// memory, `stride` apart from `base` (the launch's frame).
template <class V, int CT>
struct ShearSlots {
    V v[CT];
    BSW_D ShearSlots(V *, int) {}
    BSW_D V &operator[](int c) { return v[c]; }
};
template <class V>
struct ShearSlots<V, 0> {
    V *base;
    int stride;
    BSW_D ShearSlots(V *b, int s) : base(b), stride(s) {}
    BSW_D V &operator[](int c) { return base[c * stride]; }
};

// ---------------------------------------------------------------------
// 16x2 operations on the two signed 16-bit halves of a 32-bit word (held
// as an int): the DPX instructions on the card, half by half on the host.

BSW_D int s16_lo16(int x) { return (int)(int16_t)(x & 0xffff); }
BSW_D int s16_hi16(int x) { return (int)(int16_t)((unsigned)x >> 16); }
BSW_D int s16_pack2(int lo, int hi) {
    return (int)(((unsigned)lo & 0xffffu) | ((unsigned)hi << 16));
}
BSW_D int s16_wrap(int x) { return (int)(int16_t)(x & 0xffff); }
BSW_D int s16_addmax(int a, int b, int c) {          // max(a + b, c)
#ifdef __CUDA_ARCH__
    return (int)__viaddmax_s16x2((unsigned)a, (unsigned)b, (unsigned)c);
#else
    return s16_pack2(
        bsw_max(s16_wrap(s16_lo16(a) + s16_lo16(b)), s16_lo16(c)),
        bsw_max(s16_wrap(s16_hi16(a) + s16_hi16(b)), s16_hi16(c)));
#endif
}
BSW_D int s16_addmax_relu(int a, int b, int c) {     // max(a + b, c, 0)
#ifdef __CUDA_ARCH__
    return (int)__viaddmax_s16x2_relu((unsigned)a, (unsigned)b,
                                      (unsigned)c);
#else
    return s16_pack2(
        bsw_max(bsw_max(s16_wrap(s16_lo16(a) + s16_lo16(b)), s16_lo16(c)),
                0),
        bsw_max(bsw_max(s16_wrap(s16_hi16(a) + s16_hi16(b)), s16_hi16(c)),
                0));
#endif
}
BSW_D int s16_addmin_relu(int a, int b, int c) {  // max(min(a + b, c), 0)
#ifdef __CUDA_ARCH__
    return (int)__viaddmin_s16x2_relu((unsigned)a, (unsigned)b,
                                      (unsigned)c);
#else
    return s16_pack2(
        bsw_max(bsw_min(s16_wrap(s16_lo16(a) + s16_lo16(b)), s16_lo16(c)),
                0),
        bsw_max(bsw_min(s16_wrap(s16_hi16(a) + s16_hi16(b)), s16_hi16(c)),
                0));
#endif
}
BSW_D int s16_max3(int a, int b, int c) {
#ifdef __CUDA_ARCH__
    return (int)__vimax3_s16x2((unsigned)a, (unsigned)b, (unsigned)c);
#else
    return s16_pack2(
        bsw_max(bsw_max(s16_lo16(a), s16_lo16(b)), s16_lo16(c)),
        bsw_max(bsw_max(s16_hi16(a), s16_hi16(b)), s16_hi16(c)));
#endif
}
BSW_D int s16_min_relu(int a, int b) {               // max(min(a, b), 0)
#ifdef __CUDA_ARCH__
    return (int)__vimin_s16x2_relu((unsigned)a, (unsigned)b);
#else
    return s16_pack2(bsw_max(bsw_min(s16_lo16(a), s16_lo16(b)), 0),
                     bsw_max(bsw_min(s16_hi16(a), s16_hi16(b)), 0));
#endif
}
// prmt in its default mode: a selector nibble of 8 or more replicates the
// sign of its byte (the signed score table)
BSW_D int s16_prmt(unsigned lo, unsigned hi, int sel) {
#ifdef __CUDA_ARCH__
    unsigned r;
    asm("prmt.b32 %0, %1, %2, %3;" : "=r"(r) : "r"(lo), "r"(hi), "r"(sel));
    return (int)r;
#else
    unsigned r = 0;
    for (int n = 0; n < 4; ++n) {
        const int k = (sel >> (4 * n)) & 15;
        unsigned v = ((k & 7) < 4 ? lo >> (8 * (k & 3))
                                  : hi >> (8 * (k & 3))) & 0xffu;
        if (k & 8) v = (v & 0x80u) ? 0xffu : 0u;
        r |= v << (8 * n);
    }
    return (int)r;
#endif
}
// bytes of x (0-3) and y (4-7), selector nibbles below 8
BSW_D int s16_prmt2(int x, int y, int sel) {
    return s16_prmt((unsigned)x, (unsigned)y, sel);
}
// the running row maximum of the low and high halves: bv = max(h, bv),
// and the halves where h >= bv (the rightmost tie) take register r
BSW_D void s16_argmax(int h, int &bv, int r, int &bc_lo, int &bc_hi) {
#ifdef __CUDA_ARCH__
    bool up_hi, up_lo;
    bv = (int)__vibmax_s16x2((unsigned)h, (unsigned)bv, &up_hi, &up_lo);
#else
    const bool up_lo = s16_lo16(h) >= s16_lo16(bv);
    const bool up_hi = s16_hi16(h) >= s16_hi16(bv);
    bv = s16_max3(h, bv, bv);
#endif
    bc_lo = up_lo ? r : bc_lo;
    bc_hi = up_hi ? r : bc_hi;
}
// Packing and masks (unsigned arithmetic: a mask times 0xffff wraps).
BSW_D int s16_rep(int x) {              // x in both halves
    return (int)(((unsigned)x & 0xffffu) * 0x10001u);
}
BSW_D int s16_mask(int t) {             // 0/1 per half -> 0/0xffff
    return (int)((unsigned)t * 0xffffu);
}
BSW_D int s16_blend(int m, int x, int y) {  // x where m, else y
    return (x & m) | (y & ~m);
}
BSW_D int s16_shr(int x, int k) { return (int)((unsigned)x >> k); }

#ifndef __CUDACC__
// The host's lane vectors of packed words: each operation lane by lane.
#define S16_LANES(fn, params, args)                                      \
    static inline BswLanes<SHEAR_G> fn params {                          \
        return BswLanes<SHEAR_G>::apply([&](int l) { return fn args; }); \
    }
#define S16_V const BswLanes<SHEAR_G> &
S16_LANES(s16_addmax, (S16_V a, S16_V b, S16_V c), (a.v[l], b.v[l], c.v[l]))
S16_LANES(s16_addmax_relu, (S16_V a, S16_V b, S16_V c),
          (a.v[l], b.v[l], c.v[l]))
S16_LANES(s16_addmin_relu, (S16_V a, S16_V b, S16_V c),
          (a.v[l], b.v[l], c.v[l]))
S16_LANES(s16_max3, (S16_V a, S16_V b, S16_V c), (a.v[l], b.v[l], c.v[l]))
S16_LANES(s16_blend, (S16_V a, S16_V b, S16_V c), (a.v[l], b.v[l], c.v[l]))
S16_LANES(s16_min_relu, (S16_V a, S16_V b), (a.v[l], b.v[l]))
S16_LANES(s16_pack2, (S16_V a, S16_V b), (a.v[l], b.v[l]))
S16_LANES(s16_shr, (S16_V a, S16_V b), (a.v[l], b.v[l]))
S16_LANES(s16_rep, (S16_V a), (a.v[l]))
S16_LANES(s16_mask, (S16_V a), (a.v[l]))
S16_LANES(s16_lo16, (S16_V a), (a.v[l]))
S16_LANES(s16_hi16, (S16_V a), (a.v[l]))
S16_LANES(s16_prmt, (unsigned lo, unsigned hi, S16_V s),
          (lo, hi, s.v[l]))
S16_LANES(s16_prmt2, (S16_V x, S16_V y, int sel), (x.v[l], y.v[l], sel))
#undef S16_LANES
#undef S16_V
static inline void s16_argmax(const BswLanes<SHEAR_G> &h,
                              BswLanes<SHEAR_G> &bv, int r,
                              BswLanes<SHEAR_G> &bc_lo,
                              BswLanes<SHEAR_G> &bc_hi) {
    for (int l = 0; l < SHEAR_G; ++l)
        s16_argmax(h.v[l], bv.v[l], r, bc_lo.v[l], bc_hi.v[l]);
}
#endif

// ---------------------------------------------------------------------
// One pair's scalars: descriptors, the clamped band, the row loop's state.

struct ShearPair {
    int p, qlen, w, h0, rows, qdir, tdir;
    int64_t qoff, toff;
    int max, max_i, max_j, max_ie, gscore, max_off, beg, end;

    BSW_D ShearPair(const ShearBatch &b, int p_) : p(p_) {
        const BswParams &sp = b.sp;
        qlen = b.qlen[p];
        h0 = b.h0[p];
        qoff = b.qoff[p], toff = b.toff[p];
        qdir = b.qdir[p], tdir = b.tdir[p];
        rows = b.tlen[p] < b.Tmax ? b.tlen[p] : b.Tmax;
        // clamp the band in double, exactly as bsw.py (bandedSWA.cpp:
        // 147-156)
        int max_ins = (int)floor(
            (double)(qlen * sp.max_sc + sp.end_bonus - sp.o_ins) / sp.e_ins +
            1.0);
        int max_del = (int)floor(
            (double)(qlen * sp.max_sc + sp.end_bonus - sp.o_del) / sp.e_del +
            1.0);
        max_ins = max_ins > 1 ? max_ins : 1;
        max_del = max_del > 1 ? max_del : 1;
        w = b.w[p];
        w = w < max_ins ? w : max_ins;
        w = w < max_del ? w : max_del;
        max = h0, max_i = -1, max_j = -1, max_ie = -1, gscore = -1;
        max_off = 0, beg = 0, end = qlen;
    }
    // column j's query code (0-3 bases, 4 ambiguous or outside the query,
    // 5 a negative code)
    BSW_D int code(const ShearBatch &b, int j) const {
        if (j < 0 || j >= qlen) return 4;
        int64_t qp = qoff + (int64_t)qdir * j;
        qp = qp < 0 ? 0 : (qp > b.n_enc - 1 ? b.n_enc - 1 : qp);
        const int qc = b.enc[qp];
        return qc < 0 ? 5 : (qc < 4 ? qc : 4);
    }
    // column j's row-0 H
    BSW_D int h_init(const BswParams &sp, int j) const {
        if (j == 0) return h0;
        if (j < 0 || j > qlen) return 0;
        return bsw_max(h0 - sp.o_ins - sp.e_ins - (j - 1) * sp.e_ins, 0);
    }
    BSW_D int target(const ShearBatch &b, int i) const {
        return bsw_ref_at(b.ref, b.n_ref, b.packed, toff + (int64_t)tdir * i);
    }
    // row i's band [beg, end); returns h1_0, H at the band's start column
    BSW_D int row(const BswParams &sp, int i) {
        if (beg < i - w) beg = i - w;
        if (end > i + w + 1) end = i + w + 1;
        if (end > qlen) end = qlen;
        return beg == 0 ? bsw_max(h0 - (sp.o_del + sp.e_del * (i + 1)), 0)
                        : 0;
    }
    // the row reached the query's end with H h1 there
    BSW_D void at_end(int i, int h1) {
        max_ie = gscore > h1 ? max_ie : i;
        gscore = gscore > h1 ? gscore : h1;
    }
    // the row maximum row_m at column mj: true when the pair stops here
    BSW_D bool stop(const BswParams &sp, int i, int row_m, int mj) {
        if (row_m == 0) {
            SHEAR_STOP_HOOK(p, 0);
            return true;
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
                SHEAR_STOP_HOOK(p, 1);
                return true;
            }
        }
        return false;
    }
    // shrink the band to the non-zero region: beg to the first non-zero
    // slot of [beg, end), then end past the last of [beg_new, end] (the
    // slots of [beg, beg_new) are all zero); slots of the next frame,
    // whose slot u is column u + org + 1
    BSW_D void shrink(int first, int last, int org) {
        beg = first == BSW_FAR ? end : bsw_min(first + org + 1, end);
        end = bsw_min(bsw_max(last < 0 ? -1 : last + org + 1, beg - 1) + 2,
                      qlen);
    }
    BSW_D void write(int *out) const {
        out[0] = max;
        out[1] = max_j + 1;
        out[2] = max_i + 1;
        out[3] = max_ie + 1;
        out[4] = gscore;
        out[5] = max_off;
    }
};

// F entering each lane of the warp, from fc, the lane's F carry when it
// enters with 0: a log2(32)-step scan of the carries, decaying by `step`
// over one lane's slots.
template <class Grp>
BSW_D typename Grp::V shear_f_in(const Grp &g, typename Grp::V fc,
                                 int step) {
    BSW_UNROLL
    for (int k = 1; k < Grp::G; k <<= 1) {
        const typename Grp::V y = g.shfl_up(fc, k);
        fc = g.select(g.lane() >= k, bsw_addmax(y, -k * step, fc), fc);
    }
    return g.select(g.lane() == 0, 0, g.shfl_up(fc, 1));
}

// ---------------------------------------------------------------------
// The int32 body: pair p on warp g, CT slots per lane in registers, or
// for CT = 0 b.C slots per lane in the memory frame at mem (SHEAR_ARRAYS
// arrays of b.C slots, `stride` apart).
template <int CT, class Grp>
BSW_D void shear_pair_i32(const Grp &g, const ShearBatch &b, int p,
                          typename Grp::V *mem = nullptr, int stride = 0) {
    using V = typename Grp::V;
    using Slots = ShearSlots<V, CT>;
    constexpr int G = Grp::G;
    const int C = CT > 0 ? CT : b.C;
    const int F = G * C;
    auto frame = [&](int k) { return CT > 0 ? mem : mem + k * C * stride; };
    const BswParams &sp = b.sp;
    ShearPair s(b, p);
    const int Wh = b.Wh;

    // the row-0 frame (origin column -Wh-1)
    const V col0 = g.lane() * C;
    const V last_lane = g.lane() == G - 1;
    Slots H(frame(0), stride), E(frame(1), stride), S(frame(2), stride);
    Slots M(frame(3), stride), U(frame(4), stride);
    BSW_UNROLL
    for (int c = 0; c < C; ++c) {
        H[c] = g.map([&](int l) { return s.h_init(sp, l * C + c - Wh - 1); });
        E[c] = 0;
        S[c] = g.map(
            [&](int l) { return BSW_SEL(s.code(b, l * C + c - Wh - 1)); });
    }
    const int bias = sp.b > 1 ? sp.b : 1;
    const unsigned t_mis = (unsigned)(bias - sp.b);
    const unsigned t_amb = (unsigned)(bias - 1);
    const unsigned t_hit = (unsigned)(sp.a + bias);

    // 32 rows at a time, one per lane of each warp: the target base and
    // the query code of the column entering after the row (i + F - Wh - 1)
    auto tload = [&](int i0) {
        return g.map([&](int l) { return s.target(b, i0 + (l & 31)); });
    };
    auto qload = [&](int i0) {
        return g.map(
            [&](int l) { return BSW_SEL(s.code(b, i0 + (l & 31) + F - Wh - 1)); });
    };
    V tcur = 0, tnxt = 0, qcur = 0, qnxt = 0;
    if (s.rows > 0) {
        tcur = tload(0);
        tnxt = tload(32);
        qcur = qload(0);
        qnxt = qload(32);
    }

    for (int i = 0; i < s.rows; ++i) {
        const int r = i & 31;
        const int ti = g.broadcast(tcur, r);
        const int q_enter = g.broadcast(qcur, r);
        if (r == 31) {
            tcur = tnxt;
            tnxt = tload(i + 33);
            qcur = qnxt;
            qnxt = qload(i + 33);
        }
        const int h1_0 = s.row(sp, i);
        const unsigned tlo =
            ti < 4 ? ((t_mis * 0x01010101u) & ~(0xffu << (8 * ti)))
                         | (t_hit << (8 * ti))
                   : t_amb * 0x01010101u;
        const unsigned thi = t_amb | ((ti < 4 ? t_mis : t_amb) << 8);
        const int org = i - Wh - 1;       // the column of slot 0
        // this lane's slots c in [lo, hi) are in the band, c == hi is the
        // end slot
        const V lo = s.beg - org - col0, hi = s.end - org - col0;

        // pass 1: M and F's gap-open term U per slot (0 left of the band);
        // fc is F carried out of the lane when it enters with 0
        V fc = 0;
        BSW_UNROLL
        for (int c = 0; c < C; ++c) {
            M[c] = g.select(H[c] != 0, H[c] + g.prmt(tlo, thi, S[c]) - bias,
                            0);
            U[c] = g.select(lo <= c, bsw_addmax(M[c], -(sp.o_ins + sp.e_ins),
                                                0), 0);
            fc = bsw_addmax(fc, -sp.e_ins, U[c]);
        }
        V f = shear_f_in(g, fc, C * sp.e_ins);

        // the query codes move one slot left; the entering column's code
        // enters the last lane's last slot
        const V s_in = g.shfl_down(S[0], 1);
        BSW_UNROLL
        for (int c = 0; c + 1 < C; ++c) S[c] = S[c + 1];
        S[C - 1] = g.select(last_lane, q_enter, s_in);
        // the old H of the next lane's first slot (the last lane: the
        // entering column's row-0 H)
        const V h_in = g.select(last_lane, s.h_init(sp, i + F - Wh - 1),
                                g.shfl_down(H[0], 1));

        // pass 2: H in the band, the lane's row maximum (rightmost tie),
        // and the next row's frame in place: slot c takes row slot c+1,
        // H(i, j-1) where the row writes it ([lo, hi], h1_0 at lo) and the
        // old H elsewhere; E after the row (E(i+1, j) in the band, 0 at
        // the end slot) one slot left
        V bv = 0, bc = -1, e_first = 0;
        BSW_UNROLL
        for (int c = 0; c < C; ++c) {
            const V inb = (lo <= c) & (c < hi);
            const V h = g.select(inb, bsw_max3(M[c], E[c], f), 0);
            const V up = h >= bv;
            bv = g.select(up, h, bv);
            bc = g.select(up, col0 + c, bc);
            const V e = bsw_max(E[c] - sp.e_del,
                                bsw_addmax(M[c], -(sp.o_del + sp.e_del), 0));
            const V ea = g.select(inb, e, g.select(c == hi, 0, E[c]));
            const V hold = c + 1 < C ? H[c + 1 < C ? c + 1 : c] : h_in;
            H[c] = g.select((lo <= c + 1) & (c + 1 <= hi),
                            g.select(c + 1 == lo, h1_0, h), hold);
            if (c == 0)
                e_first = ea;
            else
                E[c - 1] = ea;
            f = bsw_addmax(f, -sp.e_ins, U[c]);
        }

        E[C - 1] = g.select(last_lane, 0, g.shfl_down(e_first, 1));

        // the row maximum (rightmost column) and, when the row reached the
        // query's end, H at the band's end (next-frame slot hi1); then the
        // stop test, before the band shrink's scan (on an H100 this order
        // takes ~7 % less time a row for a lone pair than the scan first)
        const int row_m = g.reduce_max(bv);
        const int mj = g.reduce_max(g.select(bv == row_m, bc, -1));
        const V lo1 = lo - 1, hi1 = hi - 1;
        if (s.end == s.qlen) {
            V hv = -1;
            BSW_UNROLL
            for (int c = 0; c < C; ++c) hv = g.select(hi1 == c, H[c], hv);
            s.at_end(i, g.reduce_max(hv));
        }
        if (s.stop(sp, i, row_m, mj + org)) break;
        // the band shrink's non-zero slots of the next frame, in [lo1,
        // hi1) for the first and [lo1, hi1] for the last
        V fs = BSW_FAR, ls = -1;
        if constexpr (CT > 0) {          // one bit per slot
            V bits = 0;
            BSW_UNROLL
            for (int c = 0; c < C; ++c)
                bits = bits | g.select((H[c] | E[c]) != 0, 1 << c, 0);
            const V clo = bsw_min(bsw_max(lo1, 0), C);
            const V below = (1 << clo) - 1;
            const V band = (1 << bsw_min(bsw_max(hi1, 0), C)) - 1 - below;
            const V bandE =
                (1 << bsw_min(bsw_max(hi1 + 1, 0), C)) - 1 - below;
            const V nb = bits & band, nbE = bits & bandE;
            fs = g.select(nb != 0, col0 + bsw_ctz(nb), BSW_FAR);
            ls = g.select(nbE != 0, col0 + bsw_msb(nbE), -1);
        } else {                         // a min and a max over the slots
            for (int c = 0; c < C; ++c) {
                const V in = ((H[c] | E[c]) != 0) & (lo1 <= c) & (c <= hi1);
                fs = g.select(in & (c < hi1), bsw_min(fs, col0 + c), fs);
                ls = g.select(in, col0 + c, ls);
            }
        }
        const int first = g.reduce_min(fs), last = g.reduce_max(ls);
        s.shrink(first, last, org);
    }
    if (g.leader()) s.write(b.out + (int64_t)p * 6);
}

// ---------------------------------------------------------------------
// The 16-bit body: pair p on one warp, R registers of two slots per lane
// (C = 2R slots: register r holds slot r low and slot R + r high).  Only
// for a pair whose values fit 16 bits (BswShear.fits16).
template <int R, class Grp>
BSW_D void shear_pair_s16(const Grp &g, const ShearBatch &b, int p) {
    using V = typename Grp::V;
    constexpr int G = Grp::G;
    static_assert(G == SHEAR_G, "one warp");
    constexpr int C = 2 * R;
    constexpr int F = G * C;
    const BswParams &sp = b.sp;
    ShearPair s(b, p);
    const int Wh = b.Wh;
    // a column's query code as a selector of its signed score: the low
    // byte picks the code's byte, the high byte replicates its sign
    auto sel16 = [](int code) { return code | (code | 8) << 4; };

    const V col0 = g.lane() * C;
    const V last_lane = g.lane() == G - 1;
    V H[R], E[R], S[R], M[R], U[R];
    BSW_UNROLL
    for (int r = 0; r < R; ++r) {
        H[r] = g.map([&](int l) {
            return s16_pack2(s.h_init(sp, l * C + r - Wh - 1),
                             s.h_init(sp, l * C + R + r - Wh - 1));
        });
        E[r] = 0;
        S[r] = g.map([&](int l) {
            return sel16(s.code(b, l * C + r - Wh - 1))
                   | sel16(s.code(b, l * C + R + r - Wh - 1)) << 8;
        });
    }
    // the signed score bytes: a on a match, -b on a mismatch, -1 for an
    // ambiguous base; byte 5 a negative query code
    const unsigned b_hit = (unsigned)sp.a & 0xffu;
    const unsigned b_mis = (unsigned)(-sp.b) & 0xffu;
    const unsigned b_amb = 0xffu;
    const int ONE = 0x00010001, NEG = (int)0x80008000u;
    const int n_oe_ins = s16_rep(-(sp.o_ins + sp.e_ins));
    const int n_oe_del = s16_rep(-(sp.o_del + sp.e_del));
    const int n_e_ins = s16_rep(-sp.e_ins), n_e_del = s16_rep(-sp.e_del);

    auto tload = [&](int i0) {
        return g.map([&](int l) { return s.target(b, i0 + (l & 31)); });
    };
    auto qload = [&](int i0) {
        return g.map([&](int l) { return s.code(b, i0 + (l & 31) + F - Wh - 1); });
    };
    V tcur = 0, tnxt = 0, qcur = 0, qnxt = 0;
    if (s.rows > 0) {
        tcur = tload(0);
        tnxt = tload(32);
        qcur = qload(0);
        qnxt = qload(32);
    }

    for (int i = 0; i < s.rows; ++i) {
        const int r32 = i & 31;
        const int ti = g.broadcast(tcur, r32);
        const int q_enter = g.broadcast(qcur, r32);
        if (r32 == 31) {
            tcur = tnxt;
            tnxt = tload(i + 33);
            qcur = qnxt;
            qnxt = qload(i + 33);
        }
        const int h1_0 = s.row(sp, i);
        const unsigned tlo =
            ti < 4 ? ((b_mis * 0x01010101u) & ~(0xffu << (8 * ti)))
                         | (b_hit << (8 * ti))
                   : b_amb * 0x01010101u;
        const unsigned thi = b_amb | ((ti < 4 ? b_mis : b_amb) << 8);
        const int org = i - Wh - 1;
        const V lo = s.beg - org - col0, hi = s.end - org - col0;
        const V nlo = s16_rep(1 - lo), hi2 = s16_rep(hi),
                hi2p = s16_rep(hi + 1);

        // pass 1: M = relu(H + score) where H > 0 (relu: M only meets
        // E, F >= 0 in a max), and M and E 0 left of the band, where no
        // row reads them again, so that U, h and E after the row are 0
        // there; the two chains' F carries (low: slots 0..R-1, high:
        // R..2R-1, each entering with 0)
        V fc = 0;
        BSW_UNROLL
        for (int r = 0; r < R; ++r) {
            const V sc = s16_prmt(tlo, thi, S[r]);
            const V ge =
                s16_mask(s16_addmin_relu(s16_pack2(r, R + r), nlo, ONE));
            M[r] = s16_addmax_relu(H[r], sc, 0) & ge
                   & s16_mask(s16_min_relu(H[r], ONE));
            E[r] = E[r] & ge;
            U[r] = s16_addmax_relu(M[r], n_oe_ins, 0);
            fc = s16_addmax(fc, n_e_ins, U[r]);
        }
        const V c_lo = s16_lo16(fc);
        const V fin = shear_f_in(
            g, bsw_max(s16_hi16(fc), c_lo - R * sp.e_ins), C * sp.e_ins);
        const V s_in = g.shfl_down(S[0], 1);
        V f = s16_pack2(fin, bsw_max(fin - R * sp.e_ins, c_lo));

        // the frame shift of the codes: slot R-1 low takes slot R (the
        // high half of register 0), slot 2R-1 high the next lane's slot 0
        const V s0 = S[0];
        BSW_UNROLL
        for (int r = 0; r + 1 < R; ++r) S[r] = S[r + 1];
        S[R - 1] = s16_shr(s0, 8) |
                   (g.select(last_lane, sel16(q_enter), s_in) & 0xff) << 8;
        const V h_in = g.select(last_lane, s.h_init(sp, i + F - Wh - 1),
                                g.shfl_down(H[0], 1));
        const V h_old0 = H[0];

        // pass 2 (the int32 body's, per register): h is 0 past the band's
        // end (and, from pass 1, left of it); E keeps its old value past
        // the end slot.  lt: the halves left of hi; le, left of hi + 1, is
        // the previous register's lt (slot c <= hi iff c - 1 < hi) but in
        // register 0
        V bv = 0, bc_lo = -1, bc_hi = -1, e_first = 0;
        V lt_prev = s16_mask(s16_addmin_relu(hi2p, s16_pack2(0, -R), ONE));
        BSW_UNROLL
        for (int r = 0; r < R; ++r) {
            const V le = lt_prev;
            const V lt =
                s16_mask(s16_addmin_relu(hi2, s16_pack2(-r, -(R + r)), ONE));
            lt_prev = lt;
            const V h = s16_max3(M[r], E[r], f) & lt;
            s16_argmax(h, bv, r, bc_lo, bc_hi);
            const V e = s16_addmax_relu(M[r], n_oe_del,
                                        s16_addmax(E[r], n_e_del, NEG));
            const V ea = s16_blend(le, e & lt, E[r]);
            const V hold = r + 1 < R ? H[r + 1 < R ? r + 1 : r]
                                     : s16_prmt2(h_old0, h_in, 0x5432);
            H[r] = s16_blend(lt, h, hold);
            if (r == 0)
                e_first = ea;
            else
                E[r - 1] = ea;
            f = s16_addmax(f, n_e_ins, U[r]);
        }
        // the band starts at column 0: H there (next-frame slot lo - 1,
        // written 0 above) is h1_0
        if (h1_0 != 0) {
            const V c1 = g.select(lo <= hi, lo - 1, -1);
            BSW_UNROLL
            for (int r = 0; r < R; ++r)
                H[r] = H[r] | g.select(c1 == r, h1_0, 0)
                       | g.select(c1 == R + r, h1_0 << 16, 0);
        }

        // the band shrink's non-zero slots, as the int32 body: all but
        // the high half of E[R-1] (the next lane's e_first), and the low
        // half of this lane's e_first at col0 - 1
        const V lo1 = lo - 1, hi1 = hi - 1;
        V nz = 0;
        BSW_UNROLL
        for (int r = 0; r < R; ++r) {
            const V x = H[r] | (r + 1 < R ? E[r]
                                          : s16_shr(e_first, 16));
            nz = nz | s16_min_relu(x, ONE) << r;
        }
        const V bits = (nz & 0xffff) | s16_shr(nz, 16) << R;
        const V clo = bsw_min(bsw_max(lo1, 0), C);
        const V below = (1 << clo) - 1;
        const V band = (1 << bsw_min(bsw_max(hi1, 0), C)) - 1 - below;
        const V bandE = (1 << bsw_min(bsw_max(hi1 + 1, 0), C)) - 1 - below;
        const V nb = bits & band, nbE = bits & bandE;
        V fs = g.select(nb != 0, col0 + bsw_ctz(nb), BSW_FAR);
        V ls = g.select(nbE != 0, col0 + bsw_msb(nbE), -1);
        const V e_nz = (s16_lo16(e_first) != 0) & (lo1 <= -1);
        fs = g.select(e_nz & (hi1 > -1), bsw_min(fs, col0 - 1), fs);
        ls = g.select(e_nz & (hi1 >= -1), bsw_max(ls, col0 - 1), ls);
        V hv = -1;
        const bool at_end = s.end == s.qlen;
        if (at_end) {
            BSW_UNROLL
            for (int r = 0; r < R; ++r) {
                hv = g.select(hi1 == r, s16_lo16(H[r]), hv);
                hv = g.select(hi1 == R + r, s16_hi16(H[r]), hv);
            }
        }
        // the lane's row maximum: the high halves lie right of the low
        const V m_lo = s16_lo16(bv), m_hi = s16_hi16(bv);
        const V hi_wins = m_hi >= m_lo;
        const V lane_m = bsw_max(m_lo, m_hi);
        const V lane_c = g.select(hi_wins, col0 + R + bc_hi, col0 + bc_lo);
        const int row_m = g.reduce_max(lane_m);
        const int mj = g.reduce_max(g.select(lane_m == row_m, lane_c, -1));
        const int first = g.reduce_min(fs), last = g.reduce_max(ls);
        E[R - 1] = s16_prmt2(
            e_first, g.select(last_lane, 0, g.shfl_down(e_first, 1)), 0x5432);
        if (at_end) s.at_end(i, g.reduce_max(hv));
        if (s.stop(sp, i, row_m, mj + org)) break;
        s.shrink(first, last, org);
    }
    if (g.leader()) s.write(b.out + (int64_t)p * 6);
}

// ---------------------------------------------------------------------
// The split-band form: one pair on the K warps of a block, G = 32 K lanes
// of C int32 slots each (SHEAR_BLK_BUCKETS), for launches whose pairs are
// too few to fill the card one warp a pair.  The frame and the row are
// shear_pair_i32's; a warp runs C = (its frame) / 32 K slots a row, and
// what crosses warps goes through shared memory in two exchanges a row
// (one barrier each), the rest through the warp's shuffles:
//   * after pass 1: each warp's F carry (its last lane's inclusive scan)
//     and its lane 0's old S[0] and H[0] (the previous warp's lane 31
//     takes them as the next lane's); a warp enters F with the fold of
//     the warps before it;
//   * after pass 2: each warp's row maximum and its rightmost column, H
//     at the band's end, the band shrink's first and last non-zero slot,
//     and lane 0's E after the row.  So that the shrink need not wait for
//     the next lane's E, each lane takes its own first E, which lands in
//     the previous lane's last slot, as a candidate at col0 - 1 (as
//     shear_pair_s16 does).
// The two exchanges use separate slots, so no third barrier is needed: a
// warp writes one only after every warp has passed the other's barrier.
enum {
    SHEAR_X_TOT, SHEAR_X_S0, SHEAR_X_H0,       // after pass 1
    SHEAR_X_EF, SHEAR_X_M, SHEAR_X_J, SHEAR_X_HV, SHEAR_X_FS, SHEAR_X_LS,
    SHEAR_X_SLOTS
};

// The split form's buckets, X(K, C, Wh at most): K warps a pair, C int32
// slots a lane, the frame of 32 K C slots holding 2 Wh + 3.  (K = 4, C = 2
// and 4 ran slower than K = 2 on an H100 at 64 and 512 pairs.)
#define SHEAR_BLK_BUCKETS(X) X(2, 4, 110) X(2, 7, 206)

#ifdef __CUDACC__

// The card's block of K warps: a lane is a thread, `xch` the block's
// SHEAR_X_SLOTS x K ints of shared memory.
template <int K_>
struct ShearBlock {
    static constexpr int K = K_, G = 32 * K_;
    using V = int;
    int l, wl, w;
    int *xch;
    __device__ explicit ShearBlock(int *x) : xch(x) {
        l = threadIdx.x;
        wl = l & 31;
        w = l >> 5;
    }
    BSW_D int lane() const { return l; }
    BSW_D int wlane() const { return wl; }
    BSW_D int warp() const { return w; }
    BSW_D bool leader() const { return l == 0; }
    BSW_D int shfl_up_w(int x, int k) const {
        return __shfl_up_sync(0xffffffffu, x, k);
    }
    BSW_D int shfl_down_w(int x, int k) const {
        return __shfl_down_sync(0xffffffffu, x, k);
    }
    BSW_D int broadcast(int x, int r) const {   // lane r of this warp
        return __shfl_sync(0xffffffffu, x, r);
    }
    BSW_D int wmax(int x) const { return __reduce_max_sync(0xffffffffu, x); }
    BSW_D int wmin(int x) const { return __reduce_min_sync(0xffffffffu, x); }
    // lane `src` of each warp offers x in slot k; get(k, u) after sync()
    BSW_D void put(int k, int x, int src) const {
        if (wl == src) xch[k * K + w] = x;
    }
    BSW_D void sync() const { __syncthreads(); }
    BSW_D int get(int k, int u) const { return xch[k * K + u]; }
    BSW_D int select(bool m, int a, int b) const { return m ? a : b; }
    template <class F>
    BSW_D int map(F f) const { return f(l); }
    BSW_D int prmt(unsigned lo, unsigned hi, int s) const {
        return bsw_prmt(lo, hi, s);
    }
};

#else

// The host's block: G lanes in one lane vector, the warps' shuffles and
// reductions within each run of 32.
template <int K_>
struct ShearBlock {
    static constexpr int K = K_, G = 32 * K_;
    using V = BswLanes<G>;
    int *xch;
    explicit ShearBlock(int *x) : xch(x) {}
    V lane() const { return V::apply([](int l) { return l; }); }
    V wlane() const { return V::apply([](int l) { return l & 31; }); }
    V warp() const { return V::apply([](int l) { return l >> 5; }); }
    bool leader() const { return true; }
    V shfl_up_w(const V &x, int k) const {
        return V::apply(
            [&](int l) { return (l & 31) >= k ? x.v[l - k] : x.v[l]; });
    }
    V shfl_down_w(const V &x, int k) const {
        return V::apply(
            [&](int l) { return (l & 31) + k < 32 ? x.v[l + k] : x.v[l]; });
    }
    // lane r of the first warp: the callers' values are the same in every
    // warp
    int broadcast(const V &x, int r) const { return x.v[r]; }
    V wmax(const V &x) const {
        return V::apply([&](int l) {
            int r = x.v[l & ~31];
            for (int u = 1; u < 32; ++u) r = bsw_max(r, x.v[(l & ~31) + u]);
            return r;
        });
    }
    V wmin(const V &x) const {
        return V::apply([&](int l) {
            int r = x.v[l & ~31];
            for (int u = 1; u < 32; ++u) r = bsw_min(r, x.v[(l & ~31) + u]);
            return r;
        });
    }
    void put(int k, const V &x, int src) const {
        for (int u = 0; u < K; ++u) xch[k * K + u] = x.v[32 * u + src];
    }
    void sync() const {}
    int get(int k, int u) const { return xch[k * K + u]; }
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

// The split-band body: pair p on block g (ShearBlock<K>), C int32 slots a
// lane in registers; shear_pair_i32's rows, value for value.
template <int C, class Grp>
BSW_D void shear_pair_blk(const Grp &g, const ShearBatch &b, int p) {
    using V = typename Grp::V;
    constexpr int G = Grp::G, K = Grp::K;
    constexpr int F = G * C;
    const BswParams &sp = b.sp;
    ShearPair s(b, p);
    const int Wh = b.Wh;

    const V col0 = g.lane() * C;
    const V wl = g.wlane(), wp = g.warp();
    const V last_lane = g.lane() == G - 1;
    V H[C], E[C], S[C], M[C], U[C];
    BSW_UNROLL
    for (int c = 0; c < C; ++c) {
        H[c] = g.map([&](int l) { return s.h_init(sp, l * C + c - Wh - 1); });
        E[c] = 0;
        S[c] = g.map(
            [&](int l) { return BSW_SEL(s.code(b, l * C + c - Wh - 1)); });
    }
    const int bias = sp.b > 1 ? sp.b : 1;
    const unsigned t_mis = (unsigned)(bias - sp.b);
    const unsigned t_amb = (unsigned)(bias - 1);
    const unsigned t_hit = (unsigned)(sp.a + bias);
    const int step = C * sp.e_ins;     // F's decay over one lane's slots

    auto tload = [&](int i0) {
        return g.map([&](int l) { return s.target(b, i0 + (l & 31)); });
    };
    auto qload = [&](int i0) {
        return g.map([&](int l) {
            return BSW_SEL(s.code(b, i0 + (l & 31) + F - Wh - 1));
        });
    };
    V tcur = 0, tnxt = 0, qcur = 0, qnxt = 0;
    if (s.rows > 0) {
        tcur = tload(0);
        tnxt = tload(32);
        qcur = qload(0);
        qnxt = qload(32);
    }
    // the next warp's value of slot k, for each warp's lane 31
    auto next_warp = [&](int k) {
        V x = 0;
        BSW_UNROLL
        for (int u = 0; u + 1 < K; ++u) x = g.select(wp == u, g.get(k, u + 1), x);
        return x;
    };

    for (int i = 0; i < s.rows; ++i) {
        const int r = i & 31;
        const int ti = g.broadcast(tcur, r);
        const int q_enter = g.broadcast(qcur, r);
        if (r == 31) {
            tcur = tnxt;
            tnxt = tload(i + 33);
            qcur = qnxt;
            qnxt = qload(i + 33);
        }
        const int h1_0 = s.row(sp, i);
        const unsigned tlo =
            ti < 4 ? ((t_mis * 0x01010101u) & ~(0xffu << (8 * ti)))
                         | (t_hit << (8 * ti))
                   : t_amb * 0x01010101u;
        const unsigned thi = t_amb | ((ti < 4 ? t_mis : t_amb) << 8);
        const int org = i - Wh - 1;
        const V lo = s.beg - org - col0, hi = s.end - org - col0;

        // pass 1, as shear_pair_i32
        V fc = 0;
        BSW_UNROLL
        for (int c = 0; c < C; ++c) {
            M[c] = g.select(H[c] != 0, H[c] + g.prmt(tlo, thi, S[c]) - bias,
                            0);
            U[c] = g.select(lo <= c, bsw_addmax(M[c], -(sp.o_ins + sp.e_ins),
                                                0), 0);
            fc = bsw_addmax(fc, -sp.e_ins, U[c]);
        }
        // F's scan: in the warp, then across the warps (exchange 1)
        BSW_UNROLL
        for (int k = 1; k < 32; k <<= 1) {
            const V y = g.shfl_up_w(fc, k);
            fc = g.select(wl >= k, bsw_addmax(y, -k * step, fc), fc);
        }
        g.put(SHEAR_X_TOT, fc, 31);
        g.put(SHEAR_X_S0, S[0], 0);
        g.put(SHEAR_X_H0, H[0], 0);
        g.sync();
        V fw = 0;
        {
            int acc = 0;
            BSW_UNROLL
            for (int u = 0; u + 1 < K; ++u) {
                acc = bsw_max(acc - 32 * step, g.get(SHEAR_X_TOT, u));
                fw = g.select(wp == u + 1, acc, fw);
            }
        }
        V f = bsw_max(fw - wl * step,
                      g.select(wl == 0, 0, g.shfl_up_w(fc, 1)));

        const V lane31 = wl == 31;
        const V s_in = g.select(lane31, next_warp(SHEAR_X_S0),
                                g.shfl_down_w(S[0], 1));
        BSW_UNROLL
        for (int c = 0; c + 1 < C; ++c) S[c] = S[c + 1];
        S[C - 1] = g.select(last_lane, q_enter, s_in);
        const V h_in = g.select(
            last_lane, s.h_init(sp, i + F - Wh - 1),
            g.select(lane31, next_warp(SHEAR_X_H0), g.shfl_down_w(H[0], 1)));

        // pass 2, as shear_pair_i32
        V bv = 0, bc = -1, e_first = 0;
        BSW_UNROLL
        for (int c = 0; c < C; ++c) {
            const V inb = (lo <= c) & (c < hi);
            const V h = g.select(inb, bsw_max3(M[c], E[c], f), 0);
            const V up = h >= bv;
            bv = g.select(up, h, bv);
            bc = g.select(up, col0 + c, bc);
            const V e = bsw_max(E[c] - sp.e_del,
                                bsw_addmax(M[c], -(sp.o_del + sp.e_del), 0));
            const V ea = g.select(inb, e, g.select(c == hi, 0, E[c]));
            const V hold = c + 1 < C ? H[c + 1 < C ? c + 1 : c] : h_in;
            H[c] = g.select((lo <= c + 1) & (c + 1 <= hi),
                            g.select(c + 1 == lo, h1_0, h), hold);
            if (c == 0)
                e_first = ea;
            else
                E[c - 1] = ea;
            f = bsw_addmax(f, -sp.e_ins, U[c]);
        }

        // the warp's row maximum (rightmost column), H at the band's end,
        // and the band shrink's slots: this lane's slots but E of its
        // last (the next lane's e_first), and its own e_first at col0 - 1
        const V lo1 = lo - 1, hi1 = hi - 1;
        const V wm = g.wmax(bv);
        const V wj = g.wmax(g.select(bv == wm, bc, -1));
        V hv = -1;
        BSW_UNROLL
        for (int c = 0; c < C; ++c) hv = g.select(hi1 == c, H[c], hv);
        V bits = 0;
        BSW_UNROLL
        for (int c = 0; c < C; ++c)
            bits = bits | g.select((c + 1 < C ? H[c] | E[c] : H[c]) != 0,
                                   1 << c, 0);
        const V clo = bsw_min(bsw_max(lo1, 0), C);
        const V below = (1 << clo) - 1;
        const V band = (1 << bsw_min(bsw_max(hi1, 0), C)) - 1 - below;
        const V bandE = (1 << bsw_min(bsw_max(hi1 + 1, 0), C)) - 1 - below;
        const V nb = bits & band, nbE = bits & bandE;
        V fs = g.select(nb != 0, col0 + bsw_ctz(nb), BSW_FAR);
        V ls = g.select(nbE != 0, col0 + bsw_msb(nbE), -1);
        const V e_nz = (e_first != 0) & (lo1 <= -1);
        fs = g.select(e_nz & (hi1 > -1), bsw_min(fs, col0 - 1), fs);
        ls = g.select(e_nz & (hi1 >= -1), bsw_max(ls, col0 - 1), ls);
        // exchange 2
        g.put(SHEAR_X_EF, e_first, 0);
        g.put(SHEAR_X_M, wm, 0);
        g.put(SHEAR_X_J, wj, 0);
        g.put(SHEAR_X_HV, g.wmax(hv), 0);
        g.put(SHEAR_X_FS, g.wmin(fs), 0);
        g.put(SHEAR_X_LS, g.wmax(ls), 0);
        g.sync();
        int row_m = g.get(SHEAR_X_M, 0), mj = g.get(SHEAR_X_J, 0);
        int hvr = g.get(SHEAR_X_HV, 0), first = g.get(SHEAR_X_FS, 0);
        int last = g.get(SHEAR_X_LS, 0);
        BSW_UNROLL
        for (int u = 1; u < K; ++u) {
            const int m = g.get(SHEAR_X_M, u);
            mj = m > row_m ? g.get(SHEAR_X_J, u)
                           : m == row_m ? bsw_max(mj, g.get(SHEAR_X_J, u))
                                        : mj;
            row_m = bsw_max(row_m, m);
            hvr = bsw_max(hvr, g.get(SHEAR_X_HV, u));
            first = bsw_min(first, g.get(SHEAR_X_FS, u));
            last = bsw_max(last, g.get(SHEAR_X_LS, u));
        }
        E[C - 1] = g.select(
            last_lane, 0,
            g.select(lane31, next_warp(SHEAR_X_EF), g.shfl_down_w(e_first, 1)));
        if (s.end == s.qlen) s.at_end(i, hvr);
        if (s.stop(sp, i, row_m, mj + org)) break;
        s.shrink(first, last, org);
    }
    if (g.leader()) s.write(b.out + (int64_t)p * 6);
}

// Sheared-band Smith-Waterman extension of one long pair (ksw_extend2
// semantics), run by one lane group: the body of the bsw_shear CUDA kernel
// (bsw_shear.cu).
//
// Behavioral spec: the same rows as bsw_group.cuh (bandedSWA.cpp:116-237,
// with the query and target gathered from descriptors and the arithmetic
// score), held against ops/bsw.py:bsw_shear_desc_ref, the port of
// bwamem2_tpu's _bsw_shear_dp.  A long pair (qlen up to 32768, tlen
// unbounded) only ever computes the band [i - w, i + w] of row i, so the
// DP state is a frame of band offsets instead of the query: frame slot u
// at row i holds query column j = i - Wh - 1 + u, where Wh >= w is the
// launch's band radius.  The frame has F = G*C >= 2*Wh + 3 slots, so the
// band and its end slot lie in slots 1 .. 2*Wh + 2 and the column entering
// at the right after row i (i + F - Wh - 1) is one no row has written yet
// (row i writes up to column i + w + 1).
//
// The shear.  Moving to row i+1 moves the frame one column right, so
// frame slot u of row i+1 is slot u+1 of row i.  The diagonal step
// (i-1, j-1) -> (i, j) becomes vertical: bsw_group.cuh's column-shifted H
// (H[j] = H(i-1, j-1) entering a row) keeps its slot from row to row,
// where the row writes it (H(i, j-1) for j in [beg, end], h1_0 at beg);
// every other cell, E and the query codes move one slot left.  In the
// lane group, lane l owns slots l*C .. l*C+C-1; a slot's left move is a
// register move inside the lane and, for the lane's last slot, one
// shfl_down from lane l+1.  Lane G-1's last slot takes the entering
// column: its row-0 H (h0 decaying along the query, 0 past qlen), E 0 and
// its query code.
//
// A row, per lane, in frame slots:
//   * pass 1: M (the diagonal input; no restart through a zero H) and F's
//     gap-open term per slot, the lane's F carry; a log2 G shuffle scan of
//     the carries (the F prefix max with linear decay, bsw_group.cuh);
//   * pass 2: H = max(M, E, F) in the band, the lane's row maximum
//     (rightmost tie), E after the row, and the shifted frame written in
//     place: H from this row's h or the next slot's old value, E from the
//     next slot's E after the row;
//   * reductions for the row maximum and the band shrink (first non-zero
//     slot of [beg, end), last of [beg, end], in the shifted frame) and a
//     broadcast of H at the band's end; the slot results are turned into
//     columns by adding the frame's origin.
// The row's target base and the entering column's query code come from
// one load per lane every G rows, broadcast a row at a time.
//
// Registers, for band radii up to 206: every slot loop of a register
// bucket (SHEAR_BUCKETS) runs C times, fully unrolled, and the non-zero
// scan uses one bit per slot (C <= 30).  A wider band runs the same body
// with C chosen at run time and the slot arrays in a frame in memory
// (ShearSlots<V, 0>: shared memory on the card, slot c of lane l at
// c*32 + l), its non-zero scan a min/max over the slots.

#pragma once

#include "bsw_group.cuh"

// Called where pair p's row loop stops early: why = 0 on a zero row
// maximum, 1 on z-drop (the host tests count them).
#ifndef SHEAR_STOP_HOOK
#define SHEAR_STOP_HOOK(p, why)
#endif

// One launch: P pairs, pair p's output row at out[p * 6]; the band radius
// Wh (>= every pair's w), the row cap Tmax and the slots per lane C.
struct ShearBatch {
    const int8_t *enc;
    int64_t n_enc;
    const uint8_t *ref;
    int64_t n_ref;
    int packed;
    const int *qoff, *qdir, *qlen;
    const int64_t *toff;
    const int *tdir, *tlen, *h0, *w;
    int P, Wh, Tmax, C;
    BswParams sp;
    int *out;
};

#define SHEAR_G 32   // lanes per pair: one warp

// The register instantiations, slots per lane C, by rising frame: a frame
// of 32*C slots takes band radii up to (32*C - 3) / 2 (110, 206): the
// default -w 100 and its band-doubling retry at 200.  Wider bands take the
// memory frame (template argument 0), whose five slot arrays (H, E, query
// codes, M, U) take 5 * 32 * C ints of shared memory: up to 363 slots per
// lane in 227 KB, band radii up to 5806.
#define SHEAR_BUCKETS(X) X(7) X(13)
#define SHEAR_ARRAYS 5
#define SHEAR_WIDE_MAX_C 363

// The launch for band radius Wh: returns the template argument (a
// register bucket's C, or 0 for the memory frame) and sets *C, the slots
// per lane (the least whose frame holds 2*Wh + 3 slots); -1 when none does.
inline int shear_bucket(int Wh, int *C) {
    if (Wh < 0) return -1;
#define SHEAR_PICK(c)                      \
    if (2 * Wh + 3 <= SHEAR_G * (c)) {     \
        *C = (c);                          \
        return (c);                        \
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

// Pair p of the batch in group g (G = SHEAR_G lanes), CT slots per lane
// in registers, or for CT = 0 b.C slots per lane in the memory frame at
// mem (SHEAR_ARRAYS arrays of b.C slots, `stride` apart).  The leader
// writes out (score qle tle gtle gscore max_off).
template <int CT, class Grp>
BSW_D void shear_group_pair(const Grp &g, const ShearBatch &b, int p,
                            typename Grp::V *mem = nullptr, int stride = 0) {
    using V = typename Grp::V;
    using Slots = ShearSlots<V, CT>;
    constexpr int G = Grp::G;
    const int C = CT > 0 ? CT : b.C;
    const int F = G * C;
    auto frame = [&](int k) { return CT > 0 ? mem : mem + k * C * stride; };
    const BswParams &sp = b.sp;
    const int oe_del = sp.o_del + sp.e_del, oe_ins = sp.o_ins + sp.e_ins;
    const int qlen = b.qlen[p], Wh = b.Wh;
    const int64_t qoff = b.qoff[p], toff = b.toff[p];
    const int qdir = b.qdir[p], tdir = b.tdir[p], h0 = b.h0[p];
    const int rows = b.tlen[p] < b.Tmax ? b.tlen[p] : b.Tmax;

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

    // a column's query code as a score selector (0-3 bases, 4 ambiguous or
    // outside the query, 5 a negative code) and its row-0 H
    auto qsel = [&](int j) {
        int code = 4;
        if (j >= 0 && j < qlen) {
            int64_t qp = qoff + (int64_t)qdir * j;
            qp = qp < 0 ? 0 : (qp > b.n_enc - 1 ? b.n_enc - 1 : qp);
            const int qc = b.enc[qp];
            code = qc < 0 ? 5 : (qc < 4 ? qc : 4);
        }
        return BSW_SEL(code);
    };
    auto h_init = [&](int j) {
        if (j == 0) return h0;
        if (j < 0 || j > qlen) return 0;
        return bsw_max(h0 - oe_ins - (j - 1) * sp.e_ins, 0);
    };

    // the row-0 frame (origin column -Wh-1)
    const V col0 = g.lane() * C;
    const V last_lane = g.lane() == G - 1;
    Slots H(frame(0), stride), E(frame(1), stride), S(frame(2), stride);
    Slots M(frame(3), stride), U(frame(4), stride);
    BSW_UNROLL
    for (int c = 0; c < C; ++c) {
        H[c] = g.map([&](int l) { return h_init(l * C + c - Wh - 1); });
        E[c] = 0;
        S[c] = g.map([&](int l) { return qsel(l * C + c - Wh - 1); });
    }
    const int bias = sp.b > 1 ? sp.b : 1;
    const unsigned t_mis = (unsigned)(bias - sp.b);
    const unsigned t_amb = (unsigned)(bias - 1);
    const unsigned t_hit = (unsigned)(sp.a + bias);

    // G rows at a time, one per lane: the target base and the query code
    // of the column entering after the row (i + F - Wh - 1)
    auto tload = [&](int i0) {
        return g.map([&](int l) {
            return bsw_ref_at(b.ref, b.n_ref, b.packed,
                              toff + (int64_t)tdir * (i0 + l));
        });
    };
    auto qload = [&](int i0) {
        return g.map([&](int l) { return qsel(i0 + l + F - Wh - 1); });
    };
    V tcur = 0, tnxt = 0, qcur = 0, qnxt = 0;
    if (rows > 0) {
        tcur = tload(0);
        tnxt = tload(G);
        qcur = qload(0);
        qnxt = qload(G);
    }

    int max = h0, max_i = -1, max_j = -1, max_ie = -1, gscore = -1;
    int max_off = 0, beg = 0, end = qlen;
    for (int i = 0; i < rows; ++i) {
        const int r = i & (G - 1);
        const int ti = g.broadcast(tcur, r);
        const int q_enter = g.broadcast(qcur, r);
        if (r == G - 1) {
            tcur = tnxt;
            tnxt = tload(i + 1 + G);
            qcur = qnxt;
            qnxt = qload(i + 1 + G);
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
        const int org = i - Wh - 1;       // the column of slot 0
        // this lane's slots c in [lo, hi) are in the band, c == hi is the
        // end slot
        const V lo = beg - org - col0, hi = end - org - col0;

        // pass 1: M and F's gap-open term U per slot (0 left of the band);
        // fc is F carried out of the lane when it enters with 0
        V fc = 0;
        BSW_UNROLL
        for (int c = 0; c < C; ++c) {
            M[c] = g.select(H[c] != 0, H[c] + g.prmt(tlo, thi, S[c]) - bias,
                            0);
            U[c] = g.select(lo <= c, bsw_addmax(M[c], -oe_ins, 0), 0);
            fc = bsw_addmax(fc, -sp.e_ins, U[c]);
        }
        BSW_UNROLL
        for (int k = 1; k < G; k <<= 1) {
            const V y = g.shfl_up(fc, k);
            fc = g.select(g.lane() >= k, bsw_addmax(y, -k * C * sp.e_ins, fc),
                          fc);
        }
        V f = g.shfl_up(fc, 1);
        f = g.select(g.lane() == 0, 0, f);

        // the query codes move one slot left; the entering column's code
        // enters lane G-1's last slot
        const V s_in = g.shfl_down(S[0], 1);
        BSW_UNROLL
        for (int c = 0; c + 1 < C; ++c) S[c] = S[c + 1];
        S[C - 1] = g.select(last_lane, q_enter, s_in);
        // the old H of the next lane's first slot (lane G-1: the entering
        // column's row-0 H)
        const V h_in = g.select(last_lane, h_init(i + F - Wh - 1),
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
            const V e = bsw_max(E[c] - sp.e_del, bsw_addmax(M[c], -oe_del, 0));
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

        const int row_m = g.reduce_max(bv);
        const int mj = g.reduce_max(g.select(bv == row_m, bc, -1)) + org;
        // next-frame slots: this row's column j is slot j - org - 1
        const V lo1 = lo - 1, hi1 = hi - 1;
        if (end == qlen) {               // the row reached the query's end
            V v = 0;                     // h1 = H[end], from its owner lane
            BSW_UNROLL
            for (int c = 0; c < C; ++c) v = g.select(hi1 == c, H[c], v);
            const int h1 = g.broadcast(v, (end - org - 1) / C);
            max_ie = gscore > h1 ? max_ie : i;
            gscore = gscore > h1 ? gscore : h1;
        }
        if (row_m == 0) {
            SHEAR_STOP_HOOK(p, 0);
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
                SHEAR_STOP_HOOK(p, 1);
                break;
            }
        }
        // shrink the band to the non-zero region: beg to the first
        // non-zero slot of [beg, end), then end past the last of [beg_new,
        // end] (the slots of [beg, beg_new) are all zero)
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
        const int first = g.reduce_min(fs);
        const int last = g.reduce_max(ls);
        beg = first == BSW_FAR ? end : bsw_min(first + org + 1, end);
        end = bsw_min(bsw_max(last < 0 ? -1 : last + org + 1, beg - 1) + 2,
                      qlen);
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

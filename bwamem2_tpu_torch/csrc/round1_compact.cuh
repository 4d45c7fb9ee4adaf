// round1_compact.cuh: the legacy round 1 of one read (walk, emission and
// compaction), run by one lane group: the body of the round1_compact CUDA
// kernel (round1_compact.cu), which the tests also compile as host C++.
//
// Semantics: bwamem2_tpu/ops/smem.py:round1_compact_kernel, as
// ops/smem.py:round1_compact_ref computes it.  For every end column n of
// the read, the walk fm_occ.cuh:fm_round1_walk_lut gives the leftmost
// start b(n) and the interval (k, s) of [b(n), n]; column n emits the SMEM
// [b(n), n] when
//   b(n) <= n, b(n) < b(n + 1) (taken as "always" where n + 1 >= len),
//   n - b(n) + 1 >= min_seed_len and n < len,
// and the emitted columns fill the read's `cap` slots in ascending n.  The
// count returned is the true emit count (more than cap: the caller seeds
// the read on the host oracle); slots past it get n = b = -1, s = k = 0.
//
// The lane group (smem_group.cuh:SmemGroup, on the card the lanes of a
// warp, under g++ arrays stepped in lockstep) takes the read's columns G
// at a time: lane l walks column base + l.  b(n + 1) is the next lane's
// b (a gather); the pass's last column needs the next pass's first, so
// its emission waits for that pass (its b, k and s are kept), and goes
// first there: the slots stay in column order.  Each pass's emitting
// lanes take slots by a ballot and a prefix popcount.
#pragma once

#include "fm_occ.cuh"
#include "smem_group.cuh"

// The emission rule of column n with b = b(n) and bnext = b(n + 1).
SG_HD bool r1c_emits(int n, int b, int bnext, int min_len) {
    return b <= n && b < bnext && n - b + 1 >= min_len;
}

// Slot j of one read's output: n, b int32, s int32 (clamped to 2^31 - 1),
// k int64.
SG_HD void r1c_put(int j, int *on, int *ob, int *os, int64_t *ok, int n,
                   int b, int64_t s, int64_t k) {
    on[j] = n;
    ob[j] = b;
    os[j] = s < 2147483647LL ? (int)s : 2147483647;
    ok[j] = k;
}

// One read: its grid row `row`, length len (at most the grid's width), the
// K-mer table lut (read only with LUT), slots on/ob/os/ok[cap].  Returns
// the emit count (every lane gets it).
template <bool LUT, class Gr, class V>
SG_D int r1c_read(const Gr &g, const V &f, const FmLut &lut,
                  const int8_t *row, int len, int min_len, int cap, int *on,
                  int *ob, int *os, int64_t *ok) {
    constexpr int G = Gr::G;
    int cnt = 0;
    // the previous pass's last column, waiting for b(n + 1)
    bool pend = false;
    int pn = 0, pb = 0;
    int64_t pk = 0, ps = 0;
    for (int base = 0; base < len; base += G) {
        SgLane<Gr, int> b, nxt;
        SgLane<Gr, int64_t> k, s;
        g.each([&](int l) {
            const int n = base + l;
            if (n < len)
                fm_round1_walk_lut<LUT>(f, lut, row, len, n, &b(l), &k(l),
                                        &s(l));
            else
                b(l) = n + 1;
            nxt(l) = l + 1 < G ? l + 1 : l;
        });
        if (pend) {         // n + 1 = base < len: bnext = b(base)
            if (r1c_emits(pn, pb, g.bcast(b, 0), min_len)) {
                if (g.leader() && cnt < cap)
                    r1c_put(cnt, on, ob, os, ok, pn, pb, ps, pk);
                ++cnt;
            }
        }
        const SgLane<Gr, int> bn = g.gather(b, nxt);
        const unsigned em = g.ballot([&](int l) {
            const int n = base + l;
            if (n >= len || (l == G - 1 && n + 1 < len)) return false;
            return r1c_emits(n, b(l), n + 1 >= len ? 0x7fffffff : bn(l),
                             min_len);
        });
        g.each([&](int l) {
            const int j = cnt + sg_popc(em & ((1u << l) - 1u));
            if ((em >> l & 1u) && j < cap)
                r1c_put(j, on, ob, os, ok, base + l, b(l), s(l), k(l));
        });
        cnt += sg_popc(em);
        pend = base + G < len;      // the last column's b(n + 1) is next
        if (pend) {
            pn = base + G - 1;
            pb = g.bcast(b, G - 1);
            pk = g.bcast(k, G - 1);
            ps = g.bcast(s, G - 1);
        }
    }
    // the empty slots
    g.each([&](int l) {
        for (int j = (cnt < cap ? cnt : cap) + l; j < cap; j += G)
            r1c_put(j, on, ob, os, ok, -1, -1, 0, 0);
    });
    return cnt;
}

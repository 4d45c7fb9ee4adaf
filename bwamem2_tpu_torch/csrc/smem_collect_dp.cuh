// smem_collect_dp.cuh: mem_collect_smem for one read (bwamem.cpp:626-803),
// shared by the CUDA kernel (csrc/smem_collect.cu, one thread per read) and
// the tests, which compile it as host C++.  The structure is the port's
// host oracle rt_collect_smems_reads (native/runtime.cpp, smems_one_pos):
//   round 1  pivots at next_x, min_intv = 1;
//   round 2  the split rule over a snapshot of round 1's output: a seed of
//            length >= split_len and s <= split_width re-seeds from its
//            midpoint with min_intv = s + 1;
//   round 3  forward-only seeds while max_mem_intv > 0
//            (bwtSeedStrategyAllPosOneThread);
//   then a stable per-read sort by (m, n).
// Output: per-read slots [cap] of (m, n, k, s).  A read whose seeds outrun
// the cap stops at once; its count is -1 and its backward_ext count 0 (the
// caller re-seeds it on the host).  The candidate lists live in a global
// scratch of two lists of L+1 entries per read, element i of list b at
// index (b*(L+1) + i) * stride, so neighbouring reads touch neighbouring
// words; a list never holds more than L+1 entries.
#pragma once

#include "fm_occ.cuh"

struct SmemParams {
    int min_seed_len;
    int split_len;
    int64_t split_width;
    int64_t max_mem_intv;
};

struct SmemScratch {        // this read's lists, already offset to it
    int32_t *n;
    int64_t *k, *l, *s;
    int64_t stride;
    int lcap;               // L + 1
};

struct SmemOut {            // this read's output slots, already offset
    int32_t *m, *n;
    int64_t *k, *s;
    int cap;
    int cnt;
    int64_t nbwd;           // backward_ext calls
};

FM_HD bool smem_emit(SmemOut &o, int m, int n, int64_t k, int64_t s) {
    if (o.cnt >= o.cap) return false;
    o.m[o.cnt] = m;
    o.n[o.cnt] = n;
    o.k[o.cnt] = k;
    o.s[o.cnt] = s;
    ++o.cnt;
    return true;
}

FM_HD void smem_put(const SmemScratch &sc, int list, int i, int32_t n,
                    int64_t k, int64_t l, int64_t s) {
    const int64_t at = ((int64_t)list * sc.lcap + i) * sc.stride;
    sc.n[at] = n;
    sc.k[at] = k;
    sc.l[at] = l;
    sc.s[at] = s;
}

// smems_one_pos: SMEMs through pivot x.  Returns next_x, or -1 when an
// emission outran the cap.
FM_HD int smem_one_pos(const FmView &f, const int8_t *enc, int len, int x,
                       int64_t min_intv, int msl, const SmemScratch &sc,
                       SmemOut &o) {
    int next_x = x + 1;
    const int a = enc[x];
    if (a >= 4) return next_x;
    int64_t k = f.counts[a], l = f.counts[3 - a];
    int64_t s = f.counts[a + 1] - f.counts[a];
    int n = x;
    int cur = 0, np = 0;        // list `cur` holds np candidates, m = x
    bool broke = false;
    for (int j = x + 1; j < len; ++j) {
        const int aj = enc[j];
        next_x = j + 1;
        if (aj >= 4) { broke = true; break; }
        int64_t nk, nl, ns;
        // forward extension == backward on the RC twin: swap k/l
        fm_backward_ext(f, l, k, s, 3 - aj, &nl, &nk, &ns);
        ++o.nbwd;
        if (ns != s) smem_put(sc, cur, np++, n, k, l, s);
        if (ns < min_intv) { next_x = j; broke = true; break; }
        k = nk; l = nl; s = ns; n = j;
    }
    if (!broke) next_x = len;
    if (s >= min_intv) smem_put(sc, cur, np++, n, k, l, s);
    for (int i = 0, t = np - 1; i < t; ++i, --t) {   // longest match first
        const int64_t ai = ((int64_t)cur * sc.lcap + i) * sc.stride;
        const int64_t at = ((int64_t)cur * sc.lcap + t) * sc.stride;
        int32_t tn = sc.n[ai]; sc.n[ai] = sc.n[at]; sc.n[at] = tn;
        int64_t tk = sc.k[ai]; sc.k[ai] = sc.k[at]; sc.k[at] = tk;
        int64_t tl = sc.l[ai]; sc.l[ai] = sc.l[at]; sc.l[at] = tl;
        int64_t ts = sc.s[ai]; sc.s[ai] = sc.s[at]; sc.s[at] = ts;
    }
    int m = x;
    for (int j = x - 1; j >= 0 && np > 0; --j) {
        const int aj = enc[j];
        if (aj >= 4) break;
        const int nxt = cur ^ 1;
        int nc = 0;
        int64_t curr_s = -1;
        int p = 0;
        for (; p < np; ++p) {
            const int64_t at = ((int64_t)cur * sc.lcap + p) * sc.stride;
            const int32_t cn = sc.n[at];
            int64_t nk, nl, ns;
            fm_backward_ext(f, sc.k[at], sc.l[at], sc.s[at], aj, &nk, &nl,
                            &ns);
            ++o.nbwd;
            if (ns < min_intv && (cn - m + 1) >= msl) {
                if (!smem_emit(o, m, cn, sc.k[at], sc.s[at])) return -1;
                ++p;
                break;
            }
            if (ns >= min_intv) {
                curr_s = ns;
                smem_put(sc, nxt, nc++, cn, nk, nl, ns);
                ++p;
                break;
            }
        }
        for (; p < np; ++p) {           // distinct survivors
            const int64_t at = ((int64_t)cur * sc.lcap + p) * sc.stride;
            int64_t nk, nl, ns;
            fm_backward_ext(f, sc.k[at], sc.l[at], sc.s[at], aj, &nk, &nl,
                            &ns);
            ++o.nbwd;
            if (ns >= min_intv && ns != curr_s) {
                curr_s = ns;
                smem_put(sc, nxt, nc++, sc.n[at], nk, nl, ns);
            }
        }
        cur = nxt;
        np = nc;
        m = j;
    }
    if (np > 0) {
        const int64_t at = (int64_t)cur * sc.lcap * sc.stride;
        if (sc.n[at] - m + 1 >= msl
            && !smem_emit(o, m, sc.n[at], sc.k[at], sc.s[at]))
            return -1;
    }
    return next_x;
}

// The three rounds and the sort for one read; returns false when the read
// outran the cap (o.cnt = -1, o.nbwd = 0).
FM_HD bool smem_collect_read(const FmView &f, const int8_t *enc, int len,
                             const SmemParams &p, const SmemScratch &sc,
                             SmemOut &o) {
    o.cnt = 0;
    o.nbwd = 0;
    const int msl = p.min_seed_len;
    for (int x = 0; x < len;) {                        // round 1
        x = smem_one_pos(f, enc, len, x, 1, msl, sc, o);
        if (x < 0) goto overflow;
    }
    {
        const int n1 = o.cnt;                          // round 2
        for (int i = 0; i < n1; ++i) {
            const int m = o.m[i], n = o.n[i];
            const int64_t s = o.s[i];
            if (n + 1 - m < p.split_len || s > p.split_width) continue;
            if (smem_one_pos(f, enc, len, (n + 1 + m) >> 1, s + 1, msl, sc,
                             o) < 0)
                goto overflow;
        }
    }
    if (p.max_mem_intv > 0) {                          // round 3
        const int msl1 = msl + 1;
        for (int x = 0; x < len;) {
            int next_x = x + 1;
            const int a = enc[x];
            if (a < 4) {
                int64_t k = f.counts[a], l = f.counts[3 - a];
                int64_t s = f.counts[a + 1] - f.counts[a];
                bool broke = false;
                for (int j = x + 1; j < len; ++j) {
                    next_x = j + 1;
                    const int aj = enc[j];
                    if (aj >= 4) { broke = true; break; }
                    int64_t nk, nl, ns;
                    fm_backward_ext(f, l, k, s, 3 - aj, &nl, &nk, &ns);
                    ++o.nbwd;
                    k = nk; l = nl; s = ns;
                    if (s < p.max_mem_intv && (j - x + 1) >= msl1) {
                        if (s > 0 && !smem_emit(o, x, j, k, s))
                            goto overflow;
                        broke = true;
                        break;
                    }
                }
                if (!broke) next_x = len;
            }
            x = next_x;
        }
    }
    // stable insertion sort by (m, n): ties are full-tuple duplicates
    for (int i = 1; i < o.cnt; ++i) {
        const int m = o.m[i], n = o.n[i];
        const int64_t k = o.k[i], s = o.s[i];
        int t = i - 1;
        while (t >= 0 && (o.m[t] > m || (o.m[t] == m && o.n[t] > n))) {
            o.m[t + 1] = o.m[t];
            o.n[t + 1] = o.n[t];
            o.k[t + 1] = o.k[t];
            o.s[t + 1] = o.s[t];
            --t;
        }
        o.m[t + 1] = m;
        o.n[t + 1] = n;
        o.k[t + 1] = k;
        o.s[t + 1] = s;
    }
    return true;
overflow:
    o.cnt = -1;
    o.nbwd = 0;
    return false;
}

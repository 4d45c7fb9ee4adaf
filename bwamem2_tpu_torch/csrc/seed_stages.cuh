// seed_stages.cuh: the per-read bodies of the per-stage seeding kernels
// round1_chain.cu and round3_replay.cu, the per-pivot body of
// round2_forward.cu, and the read-grid access that round 2's backward body
// (r2b_group.cuh) shares with them, for the device and for the host (the
// tests compile this header as plain C++ and hold it against the plain
// PyTorch versions in bwamem2_tpu_torch/ops/smem.py).
//
// Each body runs one read (or pivot) from its first step to its last:
// where the JAX kernels (bwamem2_tpu/ops/smem.py) step every lane in
// lockstep for a fixed count of iterations and mask the finished ones, a
// body here stops when its work does.  Every JAX lane finishes within its
// kernel's iterations (a chain takes at most 2L + 2, a walk at most L), so
// the results are the same.  Templates over the index view (fm_occ.cuh):
// FmView for the replicated index, FmShardView for the sharded one.
#pragma once

#include "fm_occ.cuh"

// the code at flat index i of the read grid, i clipped to [0, NL)
FM_HD int stage_code(const int8_t *enc, int64_t NL, int64_t i) {
    return enc[i < 0 ? 0 : (i >= NL ? NL - 1 : i)];
}

// Round 1's pivot chain of one read (round1_chain_kernel): a pivot at
// each x whose base is not N, its segment extended forward until the
// interval empties at col (next x = col), an N stops it (next x = col +
// 1) or it reaches the end.  Writes pivot j at px[min(j, cap - 1)] and
// returns the pivot count.  One flat loop (an iteration starts a segment
// or steps one), so the lanes of a warp step together whatever segment
// each is in.  Counts its backward extensions in *steps.
template <class V>
FM_HD int stage_round1_chain(const V &f, const int8_t *row, int len,
                             int cap, int *px, int64_t *steps) {
    int x = 0, col = 0, npiv = 0;
    int64_t k = 0, l = 0, s = 0;
    bool seg = false;
    while (x < len) {
        if (!seg) {
            const int c0 = row[x];
            if ((unsigned)c0 >= 4u) {
                ++x;
                continue;
            }
            px[npiv < cap ? npiv : cap - 1] = x;
            ++npiv;
            k = fm_count(f, c0);
            l = fm_count(f, 3 - c0);
            s = fm_count(f, c0 + 1) - k;
            col = x + 1;
            seg = true;
            continue;
        }
        const int c = col < len ? row[col] : 4;
        if (col >= len || (unsigned)c >= 4u) {
            x = col >= len ? len : col + 1;
            seg = false;
            continue;
        }
        int64_t nk, nl, ns;
        // forward extension: backward on the RC twin, k and l swapped
        fm_backward_ext(f, l, k, s, 3 - c, &nl, &nk, &ns);
        ++*steps;
        if (ns < 1) {
            x = col;
            seg = false;
            continue;
        }
        k = nk;
        l = nl;
        s = ns;
        ++col;
    }
    return npiv;
}

// Round 3's chain of one read (round3_replay_kernel): a segment stops at
// the first column col whose interval is below max_intv with col - x + 1
// >= min_len, emitting [x, col] with its (k, s) at slot min(j, cap - 1)
// when s > 0; next x = col + 1.  Returns the seed count.
template <class V>
FM_HD int stage_round3(const V &f, const int8_t *row, int len,
                       int64_t max_intv, int min_len, int cap, int *ox,
                       int *on, int64_t *os, int64_t *ok, int64_t *steps) {
    int x = 0, col = 0, nout = 0;
    int64_t k = 0, l = 0, s = 0;
    bool seg = false;
    while (x < len) {
        if (!seg) {
            const int c0 = row[x];
            if ((unsigned)c0 >= 4u) {
                ++x;
                continue;
            }
            k = fm_count(f, c0);
            l = fm_count(f, 3 - c0);
            s = fm_count(f, c0 + 1) - k;
            col = x + 1;
            seg = true;
            continue;
        }
        const int c = col < len ? row[col] : 4;
        if (col >= len || (unsigned)c >= 4u) {
            x = col >= len ? len : col + 1;
            seg = false;
            continue;
        }
        int64_t nk, nl, ns;
        fm_backward_ext(f, l, k, s, 3 - c, &nl, &nk, &ns);
        ++*steps;
        k = nk;
        l = nl;
        s = ns;
        if (s < max_intv && col - x + 1 >= min_len) {
            if (s > 0) {
                const int j = nout < cap ? nout : cap - 1;
                ox[j] = x;
                on[j] = col;
                os[j] = s;
                ok[j] = k;
                ++nout;
            }
            x = col + 1;
            seg = false;
            continue;
        }
        ++col;
    }
    return nout;
}

// The forward pass of one pivot (round2_forward_kernel): from the base at
// (rid, x) of the read grid enc[N, L] (NL = N * L; rid < 0: a pad pivot),
// extend forward while the interval stays >= mi, pushing the interval
// before each change of size, then the last one if it is >= mi.
// Candidate j goes to slot min(j, C - 1) of n (end offset from x), k, l,
// s; returns the candidate count.
template <class V>
FM_HD int stage_round2_forward(const V &f, const int8_t *enc, int64_t NL,
                               int L, int rid, int x, int64_t mi, int C,
                               int *cn, int64_t *ck, int64_t *cl,
                               int64_t *cs, int64_t *steps) {
    const int64_t base = (int64_t)rid * L + x;
    const int plen = rid >= 0 ? L - x : 0;
    const int a0 = stage_code(enc, NL, base);
    const bool valid = (unsigned)a0 < 4u && plen > 0;
    const int a = valid ? a0 : 0;
    int64_t k = fm_count(f, a), l = fm_count(f, 3 - a);
    int64_t s = fm_count(f, a + 1) - k;
    int n = 0, ncand = 0;
    for (int j = 1; valid && j < plen; ++j) {
        const int c = stage_code(enc, NL, base + j);
        if ((unsigned)c >= 4u) break;
        int64_t nk, nl, ns;
        fm_backward_ext(f, l, k, s, 3 - c, &nl, &nk, &ns);
        ++*steps;
        if (ns != s) {
            const int at = ncand < C ? ncand : C - 1;
            cn[at] = n;
            ck[at] = k;
            cl[at] = l;
            cs[at] = s;
            ++ncand;
        }
        if (ns < mi) break;
        k = nk;
        l = nl;
        s = ns;
        n = j;
    }
    if (valid && s >= mi) {
        const int at = ncand < C ? ncand : C - 1;
        cn[at] = n;
        ck[at] = k;
        cl[at] = l;
        cs[at] = s;
        ++ncand;
    }
    return ncand;
}

// seed_stages.cuh: the per-lane bodies of the per-stage seeding kernels
// round1_chain.cu and round3_replay.cu, and the read-grid access that
// round 2's bodies (r2f_group.cuh, r2b_group.cuh) share with them, for
// the device and for the host (the tests compile this header as plain C++
// and hold it against the plain PyTorch versions in
// bwamem2_tpu_torch/ops/smem.py).
//
// Each body runs one lane from its first step to its last: where the JAX
// kernels (bwamem2_tpu/ops/smem.py) step every lane in lockstep for a
// fixed count of iterations and mask the finished ones, a lane here stops
// when its work does.  Every JAX lane finishes within its kernel's
// iterations (a chain takes at most 2L + 2, a walk at most L), so the
// results are the same.  Templates over the index view (fm_occ.cuh):
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
// returns the pivot count.  Counts its backward extensions in *steps.
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

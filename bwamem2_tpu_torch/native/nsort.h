// klib ks_introsort (src/ksort.h:185-236) index-array port: sorts an
// int64 index array with an arbitrary Less, reproducing klib's exact tie
// permutation (comparisons and swaps happen in the same order as the
// reference's struct sorts, so output orderings are bit-identical).
// Shared by core.cpp (chain filtering) and runtime.cpp (region sorts).
#pragma once
#include <cstdint>
#include <vector>
#include <array>
#include <algorithm>

template <class Less>
static void ks_insertsort(int64_t *a, int64_t s, int64_t t, Less lt) {
    for (int64_t i = s + 1; i < t; ++i)
        for (int64_t j = i; j > s && lt(a[j], a[j - 1]); --j)
            std::swap(a[j], a[j - 1]);
}

template <class Less>
static void ks_combsort(int64_t *a, int64_t s, int64_t n, Less lt) {
    const double shrink = 1.2473309501039786540366528676643;
    int64_t gap = n;
    for (;;) {
        if (gap > 2) {
            gap = (int64_t)(gap / shrink);
            if (gap == 9 || gap == 10) gap = 11;
        }
        bool do_swap = false;
        for (int64_t i = s; i < s + n - gap; ++i) {
            int64_t j = i + gap;
            if (lt(a[j], a[i])) { std::swap(a[i], a[j]); do_swap = true; }
        }
        if (!(do_swap || gap > 2)) break;
    }
    if (gap != 1) ks_insertsort(a, s, s + n, lt);
}

template <class Less>
static void ks_introsort_idx(int64_t *a, int64_t n, Less lt) {
    if (n < 1) return;
    if (n == 2) {
        if (lt(a[1], a[0])) std::swap(a[0], a[1]);
        return;
    }
    int d = 2;
    while ((1LL << d) < n) ++d;
    d <<= 1;
    std::vector<std::array<int64_t, 3>> stack;
    int64_t s = 0, t = n - 1;
    for (;;) {
        if (s < t) {
            if (--d == 0) {
                ks_combsort(a, s, t - s + 1, lt);
                t = s;
                continue;
            }
            int64_t i = s, j = t;
            int64_t k = i + ((j - i) >> 1) + 1;
            if (lt(a[k], a[i])) {
                if (lt(a[k], a[j])) k = j;
            } else {
                k = lt(a[j], a[i]) ? i : j;
            }
            int64_t rp = a[k];
            if (k != t) std::swap(a[k], a[t]);
            for (;;) {
                do ++i; while (lt(a[i], rp));
                do --j; while (i <= j && lt(rp, a[j]));
                if (j <= i) break;
                std::swap(a[i], a[j]);
            }
            std::swap(a[i], a[t]);
            if (i - s > t - i) {
                if (i - s > 16) stack.push_back({s, i - 1, d});
                s = (t - i > 16) ? i + 1 : t;
            } else {
                if (t - i > 16) stack.push_back({i + 1, t, d});
                t = (i - s > 16) ? i - 1 : s;
            }
        } else {
            if (stack.empty()) {
                ks_insertsort(a, 0, n, lt);
                return;
            }
            auto e = stack.back();
            stack.pop_back();
            s = e[0]; t = e[1]; d = (int)e[2];
        }
    }
}

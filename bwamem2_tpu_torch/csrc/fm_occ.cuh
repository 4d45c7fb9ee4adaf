// fm_occ.cuh: FM-index occ / LF primitives over the packed 32-byte occ row,
// for the device (__popc, 16-byte loads) and for the host (the tests
// compile this header as plain C++ and hold it against the plain PyTorch
// versions in bwamem2_tpu_torch/ops/device_index.py).
//
// Row layout (ops/device_index.py): int32[nb][8] = [cp_lo[4] | code[4]],
// 64 BWT chars per row as 2-bit codes, 16 per 32-bit word, LSB first.
// occ_hi (only when has_hi): the counts' bits 32..39, one byte per base
// packed into one word, read with unsigned shifts (a hi byte >= 128 makes
// the stored int32 negative).  Semantics: GET_OCC (FMI_search.h:66-73),
// backwardExt (FMI_search.cpp:1025-1052), get_sa_entry_compressed
// (FMI_search.cpp:1103-1175), including the sentinel's phantom 'A' (its
// slot stores code 0) and the int8 sign extension of the SA high byte.
//
// Two views of the tables.  FmView holds them whole (the replicated
// index).  FmShardView holds them split by contiguous row range over up to
// FM_MAX_SHARDS shards (the genome-bucket index, parallel/shard_index.py):
// a row fetch takes its shard as row / rows and reads that shard's base
// pointer, which may lie on another card (a peer load over NVLink).  The
// primitives are templates over the view, so a kernel instantiated with
// FmView compiles to the code it has without shards.
#pragma once

#include <stdint.h>

#ifdef __CUDACC__
#define FM_HD __host__ __device__ __forceinline__
#define FM_UNROLL _Pragma("unroll")
#else
#define FM_HD static inline
#define FM_UNROLL
#endif

struct FmView {
    const int32_t *occp;    // [nb][8]
    const int32_t *occ_hi;  // [nb], read only when has_hi
    int64_t counts[5];      // cumulative char counts (+1 sentinel shift)
    int64_t sentinel;
    int has_hi;
};

#define FM_MAX_SHARDS 8

struct FmShardView {
    const int32_t *occp[FM_MAX_SHARDS];     // shard i: rows [i*rows, ...)
    const int32_t *occ_hi[FM_MAX_SHARDS];   // read only when has_hi
    const int8_t *sa_ms[FM_MAX_SHARDS];     // shard i: slots [i*sa_rows, ...)
    const uint32_t *sa_ls[FM_MAX_SHARDS];
    int64_t counts[5];
    int64_t sentinel;
    int has_hi;
    uint32_t rows;          // occ rows per shard (the last one padded)
    uint32_t sa_rows;       // SA slots per shard
};

// The view a kernel instantiation reads: FmView (0) or FmShardView (1).
template <int SHARDED> struct FmViewOf { using type = FmView; };
template <> struct FmViewOf<1> { using type = FmShardView; };

FM_HD int fm_popc(uint32_t x) {
#ifdef __CUDA_ARCH__
    return __popc(x);
#else
    return __builtin_popcount(x);
#endif
}

// counts[c] by selects: a run-time index into the view would put the
// counts in local memory on the card
template <class V>
FM_HD int64_t fm_count(const V &f, int c) {
    return c == 0 ? f.counts[0] : c == 1 ? f.counts[1]
         : c == 2 ? f.counts[2] : c == 3 ? f.counts[3] : f.counts[4];
}

// the block row of `blk`: two 16-byte loads on the device
FM_HD void fm_row(const FmView &f, int64_t blk, uint32_t r[8]) {
#ifdef __CUDA_ARCH__
    const int4 *p = reinterpret_cast<const int4 *>(f.occp) + blk * 2;
    const int4 a = __ldg(p), b = __ldg(p + 1);
    r[0] = a.x; r[1] = a.y; r[2] = a.z; r[3] = a.w;
    r[4] = b.x; r[5] = b.y; r[6] = b.z; r[7] = b.w;
#else
    for (int i = 0; i < 8; ++i) r[i] = (uint32_t)f.occp[blk * 8 + i];
#endif
}

FM_HD uint32_t fm_hi(const FmView &f, int64_t blk) {
#ifdef __CUDA_ARCH__
    return (uint32_t)__ldg(f.occ_hi + blk);
#else
    return (uint32_t)f.occ_hi[blk];
#endif
}

// shard s's pointer of a table, by selects (a run-time index into the
// view would put it in local memory on the card)
template <class T>
FM_HD const T *fm_pick(const T *const p[FM_MAX_SHARDS], uint32_t s) {
    return s == 0 ? p[0] : s == 1 ? p[1] : s == 2 ? p[2] : s == 3 ? p[3]
         : s == 4 ? p[4] : s == 5 ? p[5] : s == 6 ? p[6] : p[7];
}

// The row of `blk` from its shard.  Plain loads: the shard may be another
// card's memory, read through peer access.
FM_HD void fm_row(const FmShardView &f, int64_t blk, uint32_t r[8]) {
    const uint32_t s = (uint32_t)blk / f.rows;
    const int64_t loc = blk - (int64_t)s * f.rows;
#ifdef __CUDA_ARCH__
    const int4 *p = reinterpret_cast<const int4 *>(fm_pick(f.occp, s))
                    + loc * 2;
    const int4 a = p[0], b = p[1];
    r[0] = a.x; r[1] = a.y; r[2] = a.z; r[3] = a.w;
    r[4] = b.x; r[5] = b.y; r[6] = b.z; r[7] = b.w;
#else
    const int32_t *p = fm_pick(f.occp, s) + loc * 8;
    for (int i = 0; i < 8; ++i) r[i] = (uint32_t)p[i];
#endif
}

FM_HD uint32_t fm_hi(const FmShardView &f, int64_t blk) {
    const uint32_t s = (uint32_t)blk / f.rows;
    return (uint32_t)fm_pick(f.occ_hi, s)[blk - (int64_t)s * f.rows];
}

// The SA words of sampled slot idx (sa_ms[idx], sa_ls[idx]) from its shard
FM_HD void fm_sa_words(const FmShardView &f, int64_t idx, int *ms,
                       uint32_t *ls) {
    const uint32_t s = (uint32_t)idx / f.sa_rows;
    const int64_t loc = idx - (int64_t)s * f.sa_rows;
    *ms = fm_pick(f.sa_ms, s)[loc];
    *ls = fm_pick(f.sa_ls, s)[loc];
}

// mask over the first clip(y - 16*wi, 0, 16) chars of code word wi
FM_HD uint32_t fm_prefix_mask(int y, int wi) {
    int nf = y - 16 * wi;
    nf = nf < 0 ? 0 : (nf > 16 ? 16 : nf);
    return nf == 0 ? 0u : (0xFFFFFFFFu >> (32 - 2 * nf));
}

// checkpoint count of char c: r[c] by selects (a run-time index into the
// row would put it in local memory on the card), plus its hi byte
template <class V>
FM_HD int64_t fm_cp(const V &f, const uint32_t r[8], uint32_t hi,
                    int c) {
    int64_t v = (int64_t)(c == 0 ? r[0] : c == 1 ? r[1] : c == 2 ? r[2]
                                                                : r[3]);
    if (f.has_hi) v += (int64_t)((hi >> (8 * c)) & 0xFFu) << 32;
    return v;
}

// 1 when the sentinel slot lies inside [block start, pos)
template <class V>
FM_HD int fm_sent_in(const V &f, int64_t pos, int y) {
    return (pos - y) <= f.sentinel && f.sentinel < pos;
}

// occ(pos, c) for all 4 chars from one row
template <class V>
FM_HD void fm_occ4(const V &f, int64_t pos, int64_t out[4]) {
    const int64_t blk = pos >> 6;
    const int y = (int)(pos & 63);
    uint32_t r[8];
    fm_row(f, blk, r);
    const uint32_t hi = f.has_hi ? fm_hi(f, blk) : 0u;
    int n[4] = {0, 0, 0, 0};
    FM_UNROLL
    for (int w = 0; w < 4; ++w) {
        const uint32_t pm = fm_prefix_mask(y, w);
        const uint32_t lo = r[4 + w] & 0x55555555u;
        const uint32_t hb = (r[4 + w] >> 1) & 0x55555555u;
        const uint32_t nlo = lo ^ 0x55555555u, nhb = hb ^ 0x55555555u;
        n[0] += fm_popc(nlo & nhb & pm);
        n[1] += fm_popc(lo & nhb & pm);
        n[2] += fm_popc(nlo & hb & pm);
        n[3] += fm_popc(lo & hb & pm);
    }
    n[0] -= fm_sent_in(f, pos, y);
    for (int c = 0; c < 4; ++c) out[c] = fm_cp(f, r, hi, c) + n[c];
}

// # of chars equal to c among the first y chars of the row's code words.
// fm_inblock, fm_prefix_mask, fm_cp and fm_count are the older form of
// the round-1 walk's fm_prefix_count, fm_even_prefix, fm_occ_row and
// fm_sel4 below (the same counts in fewer instructions); the kernels that
// still use them move over one at a time, each timed (ROADMAP.md).
FM_HD int fm_inblock(const uint32_t r[8], int y, int c) {
    const uint32_t pat = (uint32_t)c * 0x55555555u;
    int n = 0;
    FM_UNROLL
    for (int w = 0; w < 4; ++w) {
        const uint32_t m = r[4 + w] ^ pat;
        n += fm_popc(~(m | (m >> 1)) & 0x55555555u & fm_prefix_mask(y, w));
    }
    return n;
}

// occ(pos, c) for one char
template <class V>
FM_HD int64_t fm_occ_one(const V &f, int64_t pos, int c) {
    const int64_t blk = pos >> 6;
    const int y = (int)(pos & 63);
    uint32_t r[8];
    fm_row(f, blk, r);
    const uint32_t hi = f.has_hi ? fm_hi(f, blk) : 0u;
    const int n = fm_inblock(r, y, c) - (c == 0 ? fm_sent_in(f, pos, y) : 0);
    return fm_cp(f, r, hi, c) + n;
}

// backwardExt's arithmetic from occ(k, .) = sp and occ(k + s, .) = ep
template <class V>
FM_HD void fm_ext_combine(const V &f, int64_t k, int64_t l, int64_t s,
                          int a, const int64_t sp[4], const int64_t ep[4],
                          int64_t *ko, int64_t *lo, int64_t *so) {
    // every char's value is formed first and then picked by a select on
    // a: a loop with `if (c == a)` lets the compiler rewrite sp[c] as
    // sp[a], a run-time index that puts sp in local memory on the card
    const int64_t sent = (k <= f.sentinel && f.sentinel < k + s) ? 1 : 0;
    const int64_t s0 = ep[0] - sp[0], s1 = ep[1] - sp[1];
    const int64_t s2 = ep[2] - sp[2], s3 = ep[3] - sp[3];
    const int64_t k0 = f.counts[0] + sp[0], k1 = f.counts[1] + sp[1];
    const int64_t k2 = f.counts[2] + sp[2], k3 = f.counts[3] + sp[3];
    *ko = a == 0 ? k0 : a == 1 ? k1 : a == 2 ? k2 : a == 3 ? k3 : 0;
    *so = a == 0 ? s0 : a == 1 ? s1 : a == 2 ? s2 : a == 3 ? s3 : 0;
    // l3: the sizes of the chars after a
    *lo = l + sent + (a < 1 ? s1 : 0) + (a < 2 ? s2 : 0) + (a < 3 ? s3 : 0);
}

// backwardExt: (k', l', s') of (k, l, s) extended by char a; two row reads
template <class V>
FM_HD void fm_backward_ext(const V &f, int64_t k, int64_t l, int64_t s,
                           int a, int64_t *ko, int64_t *lo, int64_t *so) {
    int64_t sp[4], ep[4];
    fm_occ4(f, k, sp);
    fm_occ4(f, k + s, ep);
    fm_ext_combine(f, k, l, s, a, sp, ep, ko, lo, so);
}

// LF step of one strand: (k', s') of the interval (k, s) extended
// backward by the base a (0..3), tracking no RC-twin bound: k' = C[a] +
// occ(k, a), s' = occ(k + s, a) - occ(k, a).  Two row reads
// (bwamem2_tpu/ops/device_index.py:lf_step).  The tests hold the walk's
// steps, fm_walk_step and fm_walk_single, against it.
template <class V>
FM_HD void fm_lf_step(const V &f, int64_t k, int64_t s, int a,
                      int64_t *ko, int64_t *so) {
    const int64_t sp = fm_occ_one(f, k, a);
    *ko = fm_count(f, a) + sp;
    *so = fm_occ_one(f, k + s, a) - sp;
}

// The low bits of the char pairs of the first t / 2 chars of a code word
// (t even, >= 0; 32 and up: all 16): one funnel shift on the device
FM_HD uint32_t fm_even_prefix(int t) {
#ifdef __CUDA_ARCH__
    return __funnelshift_lc(0x55555555u, 0u, (unsigned)t);
#else
    return t >= 32 ? 0x55555555u : t == 0 ? 0u : 0x55555555u >> (32 - t);
#endif
}

// # of chars equal to the base of pat (its code x 0x55555555) among the
// first y chars of row r: per code word an XOR, a shift, one three-input
// logic operation with the word's prefix, a popcount and an add
FM_HD int fm_prefix_count(const uint32_t r[8], uint32_t pat, int y) {
    int n = 0;
    FM_UNROLL
    for (int w = 0; w < 4; ++w) {
        const uint32_t x = r[4 + w] ^ pat;
        const int t = 2 * y - 32 * w;
        n += fm_popc(~(x | (x >> 1)) & fm_even_prefix(t < 0 ? 0 : t));
    }
    return n;
}

// v[a] of four values by two selects on a's bits (a in 0..3): neither a
// run-time index (local memory on the card) nor a branch chain
template <class T>
FM_HD T fm_sel4(int a, T v0, T v1, T v2, T v3) {
    return (a & 2) ? ((a & 1) ? v3 : v2) : ((a & 1) ? v1 : v0);
}

// occ(pos, a) from pos's row r (and its hi word, read only with HI): the
// checkpoint, the chars equal to a before pos in the row, less the
// sentinel's slot (it stores code 0) where it lies before pos in the block
template <bool HI, class V>
FM_HD int64_t fm_occ_row(const V &f, const uint32_t r[8], uint32_t hi,
                         int64_t pos, int a, uint32_t pat) {
    const int y = (int)(pos & 63);
    int64_t v = (int64_t)fm_sel4(a, r[0], r[1], r[2], r[3]);
    if (HI) v += (int64_t)((hi >> (8 * a)) & 0xFFu) << 32;
    const bool sent = a == 0 && (pos >> 6) == (f.sentinel >> 6)
                      && (int)(f.sentinel & 63) < y;
    return v + fm_prefix_count(r, pat, y) - (sent ? 1 : 0);
}

// The round-1 walk's LF step: fm_lf_step's (k', s') of the interval (k,
// s) extended backward by the base a, HI: the index has the count-hi
// plane.  Both rows are loaded before either is counted (the same row
// twice where both ends share a block: skipping that load split warps and
// ran slower).  The walk takes it at s > 1, and fm_walk_single at s = 1.
template <bool HI, class V>
FM_HD void fm_walk_step(const V &f, int64_t k, int64_t s, int a,
                        int64_t *ko, int64_t *so) {
    const int64_t e = k + s;
    uint32_t r[8], q[8];
    fm_row(f, k >> 6, r);
    fm_row(f, e >> 6, q);
    const uint32_t hk = HI ? fm_hi(f, k >> 6) : 0u;
    const uint32_t he = HI ? fm_hi(f, e >> 6) : 0u;
    const uint32_t pat = (uint32_t)a * 0x55555555u;
    const int64_t occk = fm_occ_row<HI>(f, r, hk, k, a, pat);
    *ko = fm_sel4(a, f.counts[0], f.counts[1], f.counts[2], f.counts[3])
          + occk;
    *so = fm_occ_row<HI>(f, q, he, e, a, pat) - occk;
}

// The LF step of an interval of one BWT position k (s = 1): s' = [char k
// == a], 0 at the sentinel (whose slot stores a 0), and k' = C[a] +
// occ(k, a), both from k's row: one row and one count.  Returns s' and
// writes k' only where s' = 1 (the walk stops at s' = 0).
template <bool HI, class V>
FM_HD int fm_walk_single(const V &f, int64_t k, int a, int64_t *ko) {
    uint32_t r[8];
    fm_row(f, k >> 6, r);
    const uint32_t hk = HI ? fm_hi(f, k >> 6) : 0u;
    const int y = (int)(k & 63);
    const uint32_t w = fm_sel4(y >> 4, r[4], r[5], r[6], r[7]);
    if ((int)((w >> (2 * (y & 15))) & 3u) != a || k == f.sentinel) return 0;
    *ko = fm_sel4(a, f.counts[0], f.counts[1], f.counts[2], f.counts[3])
          + fm_occ_row<HI>(f, r, hk, k, a, (uint32_t)a * 0x55555555u);
    return 1;
}

// The K-mer interval table of the legacy round-1 walk (index/klut.py):
// the start and size of the interval of every K-mer, code = sum of
// base(n - i) << 2i over the K bases ending at column n.
struct FmLut {
    const int64_t *start;
    const int64_t *size;
    int K;
};

// The round-1 backward walk of one (read, end column n) lane: from the
// base at n, extend backward one column at a time while the column is a
// base and the interval stays non-empty.  Writes the leftmost start b of
// the longest exact match ending at n and its interval (k, s).  A lane
// whose code is not a base, or that lies at or past the read's length,
// gets b = n + 1 and the interval of base 0.  `row` is the read's grid
// row (codes 0..4), `len` its length.  Returns the LF steps taken (the
// last one is the step that emptied the interval, if any).
// bwamem2_tpu/ops/smem.py:_round1_walk.  With LUT (a compile-time
// variant: without it the code is the walk from scratch alone), a lane
// whose K bases ending at n are all bases (n >= K - 1) and whose K-mer
// occurs (size > 0) starts from the table's interval with b = n - K + 1
// and walks on from column n - K; every other lane walks from scratch.
// HI (the index has the count-hi plane) is a compile-time variant too:
// fm_round1_walk_lut picks the body from the view's has_hi, so a warp
// runs the body of its index only.  FM_WALK_STEP_HOOK(f, k, s, c) sees
// the interval and the base before each LF step: the host tests define it
// to count the steps by class.  It is for those tests alone: no kernel
// defines it, so on the card it expands to nothing.
#ifndef FM_WALK_STEP_HOOK
#define FM_WALK_STEP_HOOK(f, k, s, c)
#endif

template <bool LUT, bool HI, class V>
FM_HD int fm_round1_walk_body(const V &f, const FmLut &lut,
                              const int8_t *row, int len, int n, int *bo,
                              int64_t *ko, int64_t *so) {
    const int a0 = row[n];
    const bool valid = (unsigned)a0 < 4u && n < len;
    const int c0 = valid ? a0 : 0;
    int64_t k = fm_count(f, c0), s = fm_count(f, c0 + 1) - k;
    int b = valid ? n : n + 1, steps = 0, start = n - 1;
    if constexpr (LUT) {
        if (valid && n >= lut.K - 1) {
            int code = 0;
            bool clean = true;
            for (int i = 0; i < lut.K; ++i) {
                const int c = row[n - i];
                clean = clean && (unsigned)c < 4u;
                code |= (c & 3) << (2 * i);
            }
            const int64_t ls = clean ? lut.size[code] : 0;
            if (ls > 0) {
                k = lut.start[code];
                s = ls;
                b = n - lut.K + 1;
                start = n - lut.K;
            }
        }
    }
    for (int col = start; valid && col >= 0; --col) {
        const int c = row[col];
        if ((unsigned)c >= 4u) break;
        FM_WALK_STEP_HOOK(f, k, s, c);
        ++steps;
        if (s == 1) {               // three steps in four
            if (!fm_walk_single<HI>(f, k, c, &k)) break;
        } else {
            int64_t k2, s2;
            fm_walk_step<HI>(f, k, s, c, &k2, &s2);
            if (s2 <= 0) break;
            k = k2;
            s = s2;
        }
        b = col;
    }
    *bo = b;
    *ko = k;
    *so = s;
    return steps;
}

// The walk of one lane: round1_compact.cuh's, and round1_walk.cu's
// through fm_round1_walk
template <bool LUT, class V>
FM_HD int fm_round1_walk_lut(const V &f, const FmLut &lut,
                             const int8_t *row, int len, int n, int *bo,
                             int64_t *ko, int64_t *so) {
    return f.has_hi
        ? fm_round1_walk_body<LUT, true>(f, lut, row, len, n, bo, ko, so)
        : fm_round1_walk_body<LUT, false>(f, lut, row, len, n, bo, ko, so);
}

// The walk from scratch (lut_k = 0): round1_walk.cu's lane.
template <class V>
FM_HD int fm_round1_walk(const V &f, const int8_t *row, int len, int n,
                         int *bo, int64_t *ko, int64_t *so) {
    return fm_round1_walk_lut<false>(f, FmLut{nullptr, nullptr, 0}, row,
                                     len, n, bo, ko, so);
}

// (BWT char at pos (4 = sentinel), occ(pos, stored code)) from pos's row
// r (and its hi word).  The code word is taken from the row's two 64-bit
// halves by a select and a shift, never by a run-time index into r.
template <class V>
FM_HD int fm_char_occ_row(const V &f, const uint32_t r[8], uint32_t hi,
                          int64_t pos, int64_t *occ) {
    const int y = (int)(pos & 63);
    const uint64_t half = (y & 32) ? ((uint64_t)r[7] << 32 | r[6])
                                   : ((uint64_t)r[5] << 32 | r[4]);
    const int code = (int)((half >> ((y & 31) * 2)) & 3u);
    const int n = fm_inblock(r, y, code)
                  - (code == 0 ? fm_sent_in(f, pos, y) : 0);
    *occ = fm_cp(f, r, hi, code) + n;
    return pos == f.sentinel ? 4 : code;
}

// A sampled slot's SA entry plus off, from its two words (sa_ms[sp >> 3]
// and sa_ls[sp >> 3]): get_sa_entry_compressed's (ms << 32) + ls with the
// int8 ms byte sign-extended, written as a product (a left shift of a
// negative value is undefined in C++17).
FM_HD int64_t fm_sa_value(int ms, uint32_t ls, int64_t off) {
    return (int64_t)ms * 4294967296LL + (int64_t)ls + off;
}

// The index as a launcher receives it from ops/seed_cuda.py:fm_table, one
// int64 array: [shards, has_hi, sentinel, counts[5], rows, sa_rows,
// occp[8], occ_hi[8], sa_ms[8], sa_ls[8], lut_start, lut_size, lut_depth]
// (pointers as integers; shards 1 is the replicated index, whose tables
// are entry 0 of each list; the K-mer table's pointers are 0 and its depth
// 0 where the index has none).
#define FM_TAB_LEN 45

inline FmView fm_view_of(const int64_t *t) {
    return FmView{(const int32_t *)t[10], (const int32_t *)t[18],
                  {t[3], t[4], t[5], t[6], t[7]}, t[2], (int)t[1]};
}

inline FmShardView fm_shard_view_of(const int64_t *t) {
    FmShardView f;
    for (int i = 0; i < FM_MAX_SHARDS; ++i) {
        f.occp[i] = (const int32_t *)t[10 + i];
        f.occ_hi[i] = (const int32_t *)t[18 + i];
        f.sa_ms[i] = (const int8_t *)t[26 + i];
        f.sa_ls[i] = (const uint32_t *)t[34 + i];
    }
    for (int c = 0; c < 5; ++c) f.counts[c] = t[3 + c];
    f.sentinel = t[2];
    f.has_hi = (int)t[1];
    f.rows = (uint32_t)t[8];
    f.sa_rows = (uint32_t)t[9];
    return f;
}

inline FmLut fm_lut_of(const int64_t *t) {
    return FmLut{(const int64_t *)t[42], (const int64_t *)t[43], (int)t[44]};
}

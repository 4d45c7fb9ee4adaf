// bwamem2_tpu native core: host-side kernels for the TPU-native aligner.
//
// Contents:
//   * sais_u8        — SA-IS suffix-array construction (Nong/Zhang/Chan 2009),
//                      int64 indices, written from the published algorithm.
//                      Behavioral spec: same suffix order as the reference's
//                      sais-lite (reference: src/sais.h, used at
//                      FMI_search.cpp:372).
//   * bsw_extend*    — banded affine-gap Smith-Waterman seed extension with
//                      z-drop / end-bonus / max_off outputs.  Behavioral spec:
//                      reference src/bandedSWA.cpp:116-237 (scalarBandedSWA)
//                      == src/ksw.cpp:432-533 (ksw_extend2).
//   * ksw_align_*    — striped local SW (Farrar) with 8/16-bit lanes,
//                      2nd-best score tracking and start-position pass.
//                      Behavioral spec: src/ksw.cpp:111-381.
//   * ksw_global     — banded global (NW) alignment + CIGAR traceback.
//                      Behavioral spec: src/ksw.cpp:558-668.
//
// All functions are exported with C linkage and driven from Python via ctypes
// (see bwamem2_tpu/native/__init__.py).  These are *fresh implementations*
// against the behavioral spec above — outputs must match bit-for-bit, which
// tests/test_native.py and golden-SAM tests enforce.

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <cstdio>
#include <vector>
#include <array>
#include <algorithm>

extern "C" {

// ---------------------------------------------------------------------------
// SA-IS suffix array
// ---------------------------------------------------------------------------

namespace {

// Generic SA-IS over a string accessed through a two-way accessor (uint8 at
// the top level, int64 for recursed reduced strings) with alphabet size K.
// SA must have room for n entries.  Internal recursion uses int64 throughout.
typedef int64_t i64;

struct SaisStr {
    const uint8_t *u8;  // top-level string, or null
    const i64 *w;       // reduced string, or null
    i64 operator[](i64 i) const { return u8 ? (i64)u8[i] : w[i]; }
};

static void sais_rec(const SaisStr &s, i64 *SA, i64 n, i64 K) {
    if (n == 0) return;
    if (n == 1) { SA[0] = 0; return; }

    // type[i]: true = S-type, false = L-type.  The virtual empty suffix is
    // the smallest, so suffix n-1 (a single char) is L-type.
    std::vector<bool> is_s(n);
    is_s[n - 1] = false;
    for (i64 i = n - 2; i >= 0; --i) {
        i64 a = s[i], b = s[i + 1];
        is_s[i] = a < b || (a == b && is_s[i + 1]);
    }
    auto is_lms = [&](i64 i) { return i > 0 && is_s[i] && !is_s[i - 1]; };

    std::vector<i64> bkt(K);
    auto bucket_count = [&]() {
        std::fill(bkt.begin(), bkt.end(), 0);
        for (i64 i = 0; i < n; ++i) bkt[s[i]]++;
    };
    auto bucket_ends = [&]() {
        i64 sum = 0;
        for (i64 c = 0; c < K; ++c) { sum += bkt[c]; bkt[c] = sum; }
    };
    auto bucket_starts = [&]() {
        i64 sum = 0;
        for (i64 c = 0; c < K; ++c) { i64 t = bkt[c]; bkt[c] = sum; sum += t; }
    };

    std::vector<i64> count_save(K);

    auto induce = [&](bool final_pass) {
        // induce L from sorted LMS/S
        bucket_count();
        std::copy(bkt.begin(), bkt.end(), count_save.begin());
        bucket_starts();
        // the suffix starting at n-1: its predecessor induction needs SA scan;
        // the virtual sentinel would induce s[n-1] first if L-type
        if (!is_s[n - 1]) SA[bkt[s[n - 1]]++] = n - 1;
        for (i64 i = 0; i < n; ++i) {
            i64 j = SA[i];
            if (j > 0 && j != -1 && !is_s[j - 1]) SA[bkt[s[j - 1]]++] = j - 1;
        }
        // induce S right-to-left
        std::copy(count_save.begin(), count_save.end(), bkt.begin());
        bucket_ends();
        for (i64 i = n - 1; i >= 0; --i) {
            i64 j = SA[i];
            if (j > 0 && j != -1 && is_s[j - 1]) SA[--bkt[s[j - 1]]] = j - 1;
        }
        (void)final_pass;
    };

    // ---- stage 1: sort LMS substrings by induced sorting ----
    std::fill(SA, SA + n, (i64)-1);
    bucket_count();
    bucket_ends();
    for (i64 i = n - 1; i >= 0; --i)   // place LMS at bucket ends
        if (is_lms(i)) SA[--bkt[s[i]]] = i;
    induce(false);

    // compact sorted LMS positions into the front of SA
    i64 n1 = 0;
    for (i64 i = 0; i < n; ++i)
        if (is_lms(SA[i])) SA[n1++] = SA[i];

    // name LMS substrings
    i64 *sub = SA + n1;                 // reuse tail of SA for names
    std::fill(sub, SA + n, (i64)-1);
    i64 name = 0, prev = -1;
    for (i64 i = 0; i < n1; ++i) {
        i64 pos = SA[i];
        bool diff = false;
        if (prev < 0) diff = true;
        else {
            for (i64 d = 0; ; ++d) {
                if (d > 0 && (is_lms(pos + d) || is_lms(prev + d))) {
                    diff = !(is_lms(pos + d) && is_lms(prev + d));
                    break;
                }
                if (pos + d >= n || prev + d >= n) { diff = true; break; }
                if (s[pos + d] != s[prev + d] || is_s[pos + d] != is_s[prev + d]) {
                    diff = true;
                    break;
                }
            }
        }
        if (diff) { ++name; prev = pos; }
        sub[pos / 2] = name - 1;
    }
    // compact names (in LMS position order) into the tail of SA
    for (i64 i = n - 1, j = n - 1; i >= n1; --i)
        if (SA[i] >= 0) SA[j--] = SA[i];

    i64 *s1 = SA + n - n1;              // reduced string
    if (name < n1) {
        // recurse on the reduced problem
        sais_rec(SaisStr{nullptr, s1}, SA, n1, name);
    } else {
        for (i64 i = 0; i < n1; ++i) SA[s1[i]] = i;
    }

    // map reduced SA back to LMS positions
    std::vector<i64> lms;
    lms.reserve(n1);
    for (i64 i = 0; i < n; ++i)
        if (is_lms(i)) lms.push_back(i);
    for (i64 i = 0; i < n1; ++i) s1[i] = lms[SA[i]];
    for (i64 i = 0; i < n1; ++i) SA[i] = s1[i];

    // ---- stage 2: induce the full SA from sorted LMS ----
    std::fill(SA + n1, SA + n, (i64)-1);
    bucket_count();
    bucket_ends();
    for (i64 i = n1 - 1; i >= 0; --i) {
        i64 j = SA[i];
        SA[i] = -1;
        SA[--bkt[s[j]]] = j;
    }
    induce(true);
}

} // namespace

// Suffix array of s[0..n): standard order, end-of-string < any character.
// (The caller prepends the implicit empty suffix itself, matching
// FMI_search.cpp:372-373 which sets suffix_array[0] = n.)
int sais_u8(const uint8_t *s, int64_t *sa, int64_t n, int64_t k) {
    if (n < 0 || k <= 0) return -1;
    if (n > 0) sais_rec(SaisStr{s, nullptr}, sa, n, k);
    return 0;
}

// ---------------------------------------------------------------------------
// Banded SW extension (seed extension kernel)
// ---------------------------------------------------------------------------

// One extension problem: query[0..qlen) vs target[0..tlen), starting score h0.
// Outputs: return best score; qle/tle = query/target end of best local score;
// gtle/gscore = target end and score of best to-end-of-query alignment;
// max_off = max band offset reached.  Spec: bandedSWA.cpp:116-237.
int bsw_extend(int qlen, const uint8_t *query, int tlen, const uint8_t *target,
               int m, const int8_t *mat, int o_del, int e_del, int o_ins,
               int e_ins, int w, int end_bonus, int zdrop, int h0, int *_qle,
               int *_tle, int *_gtle, int *_gscore, int *_max_off) {
    int oe_del = o_del + e_del, oe_ins = o_ins + e_ins;

    std::vector<int> H(qlen + 2, 0), E(qlen + 2, 0);
    std::vector<int8_t> qp((size_t)qlen * m);
    for (int a = 0, idx = 0; a < m; ++a)
        for (int j = 0; j < qlen; ++j) qp[idx++] = mat[a * m + query[j]];

    // first row
    H[0] = h0;
    H[1] = h0 > oe_ins ? h0 - oe_ins : 0;
    {
        int j = 2;
        for (; j <= qlen && H[j - 1] > e_ins; ++j) H[j] = H[j - 1] - e_ins;
    }

    // clamp the band like the reference does
    int max_sc = 0;
    for (int i = 0; i < m * m; ++i) max_sc = std::max(max_sc, (int)mat[i]);
    int max_ins = (int)((double)(qlen * max_sc + end_bonus - o_ins) / e_ins + 1.);
    max_ins = std::max(max_ins, 1);
    w = std::min(w, max_ins);
    int max_del = (int)((double)(qlen * max_sc + end_bonus - o_del) / e_del + 1.);
    max_del = std::max(max_del, 1);
    w = std::min(w, max_del);

    int max = h0, max_i = -1, max_j = -1, max_ie = -1, gscore = -1, max_off = 0;
    int beg = 0, end = qlen;
    for (int i = 0; i < tlen; ++i) {
        int f = 0, h1, row_m = 0, mj = -1;
        const int8_t *q = &qp[(size_t)target[i] * qlen];
        if (beg < i - w) beg = i - w;
        if (end > i + w + 1) end = i + w + 1;
        if (end > qlen) end = qlen;
        if (beg == 0) {
            h1 = h0 - (o_del + e_del * (i + 1));
            if (h1 < 0) h1 = 0;
        } else h1 = 0;
        int j = beg;
        for (; j < end; ++j) {
            // H[j] currently holds H(i-1,j-1); E[j] holds E(i,j);
            // f = F(i,j); h1 = H(i,j-1)
            int M = H[j], e = E[j];
            H[j] = h1;                       // store H(i,j-1) for next row
            M = M ? M + q[j] : 0;            // no restart through zero H
            int h = M > e ? M : e;
            h = h > f ? h : f;
            h1 = h;
            mj = row_m > h ? mj : j;         // rightmost tie wins
            row_m = row_m > h ? row_m : h;
            int t = M - oe_del;
            t = t > 0 ? t : 0;
            e -= e_del;
            e = e > t ? e : t;
            E[j] = e;
            t = M - oe_ins;
            t = t > 0 ? t : 0;
            f -= e_ins;
            f = f > t ? f : t;
        }
        H[end] = h1;
        E[end] = 0;
        if (j == qlen) {                     // reached the end of the query
            max_ie = gscore > h1 ? max_ie : i;
            gscore = gscore > h1 ? gscore : h1;
        }
        if (row_m == 0) break;
        if (row_m > max) {
            max = row_m, max_i = i, max_j = mj;
            int off = mj > i ? mj - i : i - mj;
            max_off = max_off > off ? max_off : off;
        } else if (zdrop > 0) {
            if (i - max_i > mj - max_j) {
                if (max - row_m - ((i - max_i) - (mj - max_j)) * e_del > zdrop) break;
            } else {
                if (max - row_m - ((mj - max_j) - (i - max_i)) * e_ins > zdrop) break;
            }
        }
        // shrink the band to the non-zero region
        for (j = beg; j < end && H[j] == 0 && E[j] == 0; ++j) {}
        beg = j;
        for (j = end; j >= beg && H[j] == 0 && E[j] == 0; --j) {}
        end = j + 2 < qlen ? j + 2 : qlen;
    }
    if (_qle) *_qle = max_j + 1;
    if (_tle) *_tle = max_i + 1;
    if (_gtle) *_gtle = max_ie + 1;
    if (_gscore) *_gscore = gscore;
    if (_max_off) *_max_off = max_off;
    return max;
}

// Batch driver: each pair i reads target refs[ref_off[i]..+ref_len[i]) and
// query qers[qer_off[i]..+qer_len[i]); writes 6 int32 outputs per pair.
void bsw_extend_batch(int64_t n, const uint8_t *refs, const int64_t *ref_off,
                      const int32_t *ref_len, const uint8_t *qers,
                      const int64_t *qer_off, const int32_t *qer_len,
                      const int32_t *h0, int32_t w, const int8_t *mat, int m,
                      int o_del, int e_del, int o_ins, int e_ins, int zdrop,
                      int end_bonus, int32_t *out) {
    for (int64_t i = 0; i < n; ++i) {
        int qle, tle, gtle, gscore, max_off;
        int score = bsw_extend(qer_len[i], qers + qer_off[i], ref_len[i],
                               refs + ref_off[i], m, mat, o_del, e_del, o_ins,
                               e_ins, w, end_bonus, zdrop, h0[i], &qle, &tle,
                               &gtle, &gscore, &max_off);
        int32_t *o = out + i * 6;
        o[0] = score; o[1] = qle; o[2] = tle; o[3] = gtle; o[4] = gscore;
        o[5] = max_off;
    }
}

// ---------------------------------------------------------------------------
// Striped local Smith-Waterman (Farrar) — mate rescue / seed re-scoring
// ---------------------------------------------------------------------------
//
// Exact lane-level emulation of the SSE2 striped kernels so the scores,
// end positions, 2nd-best tracking and overflow behavior match the reference
// (src/ksw.cpp:111-338) bit-for-bit.  Lanes are emulated with fixed arrays.

namespace {

constexpr int KSW_XBYTE = 0x10000;
constexpr int KSW_XSTOP = 0x20000;
constexpr int KSW_XSUBO = 0x40000;
constexpr int KSW_XSTART = 0x80000;

struct KswResult {
    int score, te, qe, score2, te2, tb, qb;
};

// 8-bit unsigned lanes, 16 per "register"
struct SwU8 {
    int slen, qlen;
    int shift, mdiff, maxsc;
    std::vector<uint8_t> qp;     // m * slen * 16
    static constexpr int P = 16;
};

// 16-bit signed lanes, 8 per register
struct SwI16 {
    int slen, qlen;
    int maxsc;
    std::vector<int16_t> qp;
    static constexpr int P = 8;
};

static void build_u8(SwU8 &q, int qlen, const uint8_t *query, int m,
                     const int8_t *mat) {
    const int p = 16;
    q.slen = (qlen + p - 1) / p;
    q.qlen = qlen;
    int mn = 127, mx = 0;
    for (int a = 0; a < m * m; ++a) {
        mn = std::min(mn, (int)mat[a]);
        mx = std::max(mx, (int)mat[a]);
    }
    q.maxsc = mx;
    q.shift = (uint8_t)(256 - mn);        // matches q->shift semantics
    q.mdiff = mx + q.shift;
    q.qp.assign((size_t)m * q.slen * p, 0);
    size_t t = 0;
    for (int a = 0; a < m; ++a) {
        const int8_t *ma = mat + a * m;
        int nlen = q.slen * p;
        for (int i = 0; i < q.slen; ++i)
            for (int k = i; k < nlen; k += q.slen)
                q.qp[t++] = (uint8_t)((k >= qlen ? 0 : ma[query[k]]) + q.shift);
    }
}

static void build_i16(SwI16 &q, int qlen, const uint8_t *query, int m,
                      const int8_t *mat) {
    const int p = 8;
    q.slen = (qlen + p - 1) / p;
    q.qlen = qlen;
    int mx = 0;
    for (int a = 0; a < m * m; ++a) mx = std::max(mx, (int)mat[a]);
    q.maxsc = mx;
    q.qp.assign((size_t)m * q.slen * p, 0);
    size_t t = 0;
    for (int a = 0; a < m; ++a) {
        const int8_t *ma = mat + a * m;
        int nlen = q.slen * p;
        for (int i = 0; i < q.slen; ++i)
            for (int k = i; k < nlen; k += q.slen)
                q.qp[t++] = (int16_t)(k >= qlen ? 0 : ma[query[k]]);
    }
}

static inline uint8_t addsu8(uint8_t a, uint8_t b) {
    int v = (int)a + b;
    return v > 255 ? 255 : (uint8_t)v;
}
static inline uint8_t subsu8(uint8_t a, uint8_t b) { return a > b ? a - b : 0; }
static inline int16_t addsi16(int16_t a, int16_t b) {
    int v = (int)a + b;
    if (v > 32767) v = 32767;
    if (v < -32768) v = -32768;
    return (int16_t)v;
}
static inline uint16_t subsu16(uint16_t a, uint16_t b) { return a > b ? a - b : 0; }

static KswResult ksw_run_u8(const SwU8 &q, int tlen, const uint8_t *target,
                            int o_del, int e_del, int o_ins, int e_ins,
                            int xtra) {
    const int P = 16;
    const int slen = q.slen;
    KswResult r{0, -1, -1, -1, -1, -1, -1};
    int minsc = (xtra & KSW_XSUBO) ? (xtra & 0xffff) : 0x10000;
    int endsc = (xtra & KSW_XSTOP) ? (xtra & 0xffff) : 0x10000;
    uint8_t oe_del = (uint8_t)(o_del + e_del), ev_del = (uint8_t)e_del;
    uint8_t oe_ins = (uint8_t)(o_ins + e_ins), ev_ins = (uint8_t)e_ins;
    uint8_t shift = (uint8_t)q.shift;

    std::vector<uint8_t> H0v((size_t)slen * P, 0), H1v((size_t)slen * P, 0),
        Ev((size_t)slen * P, 0), Hmax((size_t)slen * P, 0);
    uint8_t *H0 = H0v.data(), *H1 = H1v.data(), *E = Ev.data();

    std::vector<uint64_t> b;
    int gmax = 0, te = -1;
    for (int i = 0; i < tlen; ++i) {
        uint8_t f[P] = {0}, maxv[P] = {0}, h[P];
        const uint8_t *S = q.qp.data() + (size_t)target[i] * slen * P;
        // h = H0[slen-1] shifted left one lane
        const uint8_t *last = H0 + (size_t)(slen - 1) * P;
        h[0] = 0;
        for (int l = 1; l < P; ++l) h[l] = last[l - 1];
        for (int j = 0; j < slen; ++j) {
            const uint8_t *Sj = S + (size_t)j * P;
            uint8_t *Ej = E + (size_t)j * P, *H1j = H1 + (size_t)j * P;
            for (int l = 0; l < P; ++l) {
                uint8_t hh = subsu8(addsu8(h[l], Sj[l]), shift);
                uint8_t ee = Ej[l];
                hh = std::max(hh, ee);
                hh = std::max(hh, f[l]);
                maxv[l] = std::max(maxv[l], hh);
                H1j[l] = hh;
                ee = subsu8(ee, ev_del);
                uint8_t t = subsu8(hh, oe_del);
                Ej[l] = std::max(ee, t);
                f[l] = subsu8(f[l], ev_ins);
                t = subsu8(hh, oe_ins);
                f[l] = std::max(f[l], t);
            }
            const uint8_t *H0j = H0 + (size_t)j * P;
            for (int l = 0; l < P; ++l) h[l] = H0j[l];
        }
        // lazy-F loop
        bool done = false;
        for (int k = 0; k < P && !done; ++k) {
            // f <<= one lane
            for (int l = P - 1; l > 0; --l) f[l] = f[l - 1];
            f[0] = 0;
            for (int j = 0; j < slen; ++j) {
                uint8_t *H1j = H1 + (size_t)j * P;
                bool all_le = true;
                for (int l = 0; l < P; ++l) {
                    uint8_t hh = std::max(H1j[l], f[l]);
                    H1j[l] = hh;
                    hh = subsu8(hh, oe_ins);
                    f[l] = subsu8(f[l], ev_ins);
                    if (subsu8(f[l], hh) != 0) all_le = false;
                }
                if (all_le) { done = true; break; }
            }
        }
        int imax = 0;
        for (int l = 0; l < P; ++l) imax = std::max(imax, (int)maxv[l]);
        if (imax >= minsc) {
            if (b.empty() || (int32_t)b.back() + 1 != i) {
                b.push_back((uint64_t)imax << 32 | (uint32_t)i);
            } else if ((int)(b.back() >> 32) < imax) {
                b.back() = (uint64_t)imax << 32 | (uint32_t)i;
            }
        }
        if (imax > gmax) {
            gmax = imax;
            te = i;
            std::memcpy(Hmax.data(), H1, (size_t)slen * P);
            if (gmax + q.shift >= 255 || gmax >= endsc) break;
        }
        std::swap(H0, H1);
    }
    r.score = gmax + q.shift < 255 ? gmax : 255;
    r.te = te;
    if (r.score != 255) {
        int mx = -1, qlen_t = slen * 16;
        const uint8_t *t = Hmax.data();
        for (int i = 0; i < qlen_t; ++i, ++t) {
            if ((int)*t > mx) {
                mx = *t;
                r.qe = i / 16 + i % 16 * slen;
            } else if ((int)*t == mx) {
                int tmp = i / 16 + i % 16 * slen;
                if (tmp < r.qe) r.qe = tmp;
            }
        }
        if (!b.empty()) {
            int i2 = (r.score + q.maxsc - 1) / q.maxsc;
            int low = te - i2, high = te + i2;
            for (size_t i = 0; i < b.size(); ++i) {
                int e = (int32_t)b[i];
                if ((e < low || e > high) && (int)(b[i] >> 32) > r.score2) {
                    r.score2 = (int)(b[i] >> 32);
                    r.te2 = e;
                }
            }
        }
    }
    return r;
}

static KswResult ksw_run_i16(const SwI16 &q, int tlen, const uint8_t *target,
                             int o_del, int e_del, int o_ins, int e_ins,
                             int xtra) {
    const int P = 8;
    const int slen = q.slen;
    KswResult r{0, -1, -1, -1, -1, -1, -1};
    int minsc = (xtra & KSW_XSUBO) ? (xtra & 0xffff) : 0x10000;
    int endsc = (xtra & KSW_XSTOP) ? (xtra & 0xffff) : 0x10000;
    int16_t oe_del = (int16_t)(o_del + e_del), ev_del = (int16_t)e_del;
    int16_t oe_ins = (int16_t)(o_ins + e_ins), ev_ins = (int16_t)e_ins;

    std::vector<int16_t> H0v((size_t)slen * P, 0), H1v((size_t)slen * P, 0),
        Ev((size_t)slen * P, 0), Hmax((size_t)slen * P, 0);
    int16_t *H0 = H0v.data(), *H1 = H1v.data(), *E = Ev.data();

    std::vector<uint64_t> b;
    int gmax = 0, te = -1;
    for (int i = 0; i < tlen; ++i) {
        int16_t f[P] = {0}, maxv[P] = {0}, h[P];
        const int16_t *S = q.qp.data() + (size_t)target[i] * slen * P;
        const int16_t *last = H0 + (size_t)(slen - 1) * P;
        h[0] = 0;
        for (int l = 1; l < P; ++l) h[l] = last[l - 1];
        for (int j = 0; j < slen; ++j) {
            const int16_t *Sj = S + (size_t)j * P;
            int16_t *Ej = E + (size_t)j * P, *H1j = H1 + (size_t)j * P;
            for (int l = 0; l < P; ++l) {
                int16_t hh = addsi16(h[l], Sj[l]);
                int16_t ee = Ej[l];
                hh = std::max(hh, ee);
                hh = std::max(hh, f[l]);
                maxv[l] = std::max(maxv[l], hh);
                H1j[l] = hh;
                ee = (int16_t)subsu16((uint16_t)ee, (uint16_t)ev_del);
                int16_t t = (int16_t)subsu16((uint16_t)hh, (uint16_t)oe_del);
                Ej[l] = std::max(ee, t);
                f[l] = (int16_t)subsu16((uint16_t)f[l], (uint16_t)ev_ins);
                t = (int16_t)subsu16((uint16_t)hh, (uint16_t)oe_ins);
                f[l] = std::max(f[l], t);
            }
            const int16_t *H0j = H0 + (size_t)j * P;
            for (int l = 0; l < P; ++l) h[l] = H0j[l];
        }
        bool done = false;
        for (int k = 0; k < 16 && !done; ++k) {
            for (int l = P - 1; l > 0; --l) f[l] = f[l - 1];
            f[0] = 0;
            for (int j = 0; j < slen; ++j) {
                int16_t *H1j = H1 + (size_t)j * P;
                bool any_gt = false;
                for (int l = 0; l < P; ++l) {
                    int16_t hh = std::max(H1j[l], f[l]);
                    H1j[l] = hh;
                    hh = (int16_t)subsu16((uint16_t)hh, (uint16_t)oe_ins);
                    f[l] = (int16_t)subsu16((uint16_t)f[l], (uint16_t)ev_ins);
                    if (f[l] > hh) any_gt = true;
                }
                if (!any_gt) { done = true; break; }
            }
        }
        int imax = 0;
        for (int l = 0; l < P; ++l) imax = std::max(imax, (int)maxv[l]);
        if (imax >= minsc) {
            if (b.empty() || (int32_t)b.back() + 1 != i) {
                b.push_back((uint64_t)imax << 32 | (uint32_t)i);
            } else if ((int)(b.back() >> 32) < imax) {
                b.back() = (uint64_t)imax << 32 | (uint32_t)i;
            }
        }
        if (imax > gmax) {
            gmax = imax;
            te = i;
            std::memcpy(Hmax.data(), H1, (size_t)slen * P * 2);
            if (gmax >= endsc) break;
        }
        std::swap(H0, H1);
    }
    r.score = gmax;
    r.te = te;
    {
        int mx = -1, qlen_t = slen * 8;
        const int16_t *t = Hmax.data();
        r.qe = -1;
        for (int i = 0; i < qlen_t; ++i, ++t) {
            if ((int)*t > mx) {
                mx = *t;
                r.qe = i / 8 + i % 8 * slen;
            } else if ((int)*t == mx) {
                int tmp = i / 8 + i % 8 * slen;
                if (tmp < r.qe) r.qe = tmp;
            }
        }
        if (!b.empty()) {
            int i2 = (r.score + q.maxsc - 1) / q.maxsc;
            int low = te - i2, high = te + i2;
            for (size_t i = 0; i < b.size(); ++i) {
                int e = (int32_t)b[i];
                if ((e < low || e > high) && (int)(b[i] >> 32) > r.score2) {
                    r.score2 = (int)(b[i] >> 32);
                    r.te2 = e;
                }
            }
        }
    }
    return r;
}

static KswResult ksw_once(int size, int qlen, const uint8_t *query, int tlen,
                          const uint8_t *target, int m, const int8_t *mat,
                          int o_del, int e_del, int o_ins, int e_ins, int xtra) {
    if (size == 1) {
        SwU8 q;
        build_u8(q, qlen, query, m, mat);
        return ksw_run_u8(q, tlen, target, o_del, e_del, o_ins, e_ins, xtra);
    }
    SwI16 q;
    build_i16(q, qlen, query, m, mat);
    return ksw_run_i16(q, tlen, target, o_del, e_del, o_ins, e_ins, xtra);
}

} // namespace

// Local SW with optional start-position recovery (reverse pass).
// out: score, te, qe, score2, te2, tb, qb.  Spec: ksw.cpp:347-381.
void ksw_align(int qlen, const uint8_t *query_c, int tlen,
               const uint8_t *target_c, int m, const int8_t *mat, int o_del,
               int e_del, int o_ins, int e_ins, int xtra, int32_t *out) {
    int size = (xtra & KSW_XBYTE) ? 1 : 2;
    KswResult r =
        ksw_once(size, qlen, query_c, tlen, target_c, m, mat, o_del, e_del,
                 o_ins, e_ins, xtra);
    bool want_start =
        (xtra & KSW_XSTART) && !((xtra & KSW_XSUBO) && r.score < (xtra & 0xffff));
    if (want_start) {
        std::vector<uint8_t> qr(query_c, query_c + r.qe + 1);
        std::vector<uint8_t> tr(target_c, target_c + r.te + 1);
        std::reverse(qr.begin(), qr.end());
        std::reverse(tr.begin(), tr.end());
        KswResult rr = ksw_once(size, r.qe + 1, qr.data(), tlen, tr.data(), m,
                                mat, o_del, e_del, o_ins, e_ins,
                                KSW_XSTOP | r.score);
        if (r.score == rr.score) {
            r.tb = r.te - rr.te;
            r.qb = r.qe - rr.qe;
        }
    }
    out[0] = r.score; out[1] = r.te; out[2] = r.qe; out[3] = r.score2;
    out[4] = r.te2; out[5] = r.tb; out[6] = r.qb;
}

void ksw_align_batch(int64_t n, const uint8_t *qs, const int64_t *q_off,
                     const int32_t *q_len, const uint8_t *ts,
                     const int64_t *t_off, const int32_t *t_len,
                     int m, const int8_t *mat, int o_del, int e_del, int o_ins,
                     int e_ins, const int32_t *xtra, int32_t *out) {
    for (int64_t i = 0; i < n; ++i)
        ksw_align(q_len[i], qs + q_off[i], t_len[i], ts + t_off[i], m, mat,
                  o_del, e_del, o_ins, e_ins, xtra[i], out + i * 7);
}

// ---------------------------------------------------------------------------
// Banded global alignment + CIGAR (for final CIGAR/NM/MD)
// ---------------------------------------------------------------------------

// Returns score; writes CIGAR ops (len<<4|op, MID = 0/1/2) to cigar_buf and
// the count to *n_cigar.  cigar_buf must have room for qlen+tlen entries.
// Pass n_cigar = NULL for score-only mode.  Spec: ksw.cpp:558-668.
int ksw_global(int qlen, const uint8_t *query, int tlen, const uint8_t *target,
               int m, const int8_t *mat, int o_del, int e_del, int o_ins,
               int e_ins, int w, int32_t *n_cigar, uint32_t *cigar_buf) {
    constexpr int MINUS_INF = -0x40000000;
    int oe_del = o_del + e_del, oe_ins = o_ins + e_ins;
    if (n_cigar) *n_cigar = 0;

    int n_col = std::min(qlen, 2 * w + 1);
    std::vector<uint8_t> z;
    bool tb = n_cigar != nullptr && cigar_buf != nullptr;
    if (tb) z.resize((size_t)n_col * tlen);

    std::vector<int8_t> qp((size_t)qlen * m);
    for (int a = 0, idx = 0; a < m; ++a)
        for (int j = 0; j < qlen; ++j) qp[idx++] = mat[a * m + query[j]];

    std::vector<int32_t> H(qlen + 1), E(qlen + 1);
    H[0] = 0;
    E[0] = MINUS_INF;
    int j = 1;
    for (; j <= qlen && j <= w; ++j) {
        H[j] = -(o_ins + e_ins * j);
        E[j] = MINUS_INF;
    }
    for (; j <= qlen; ++j) H[j] = E[j] = MINUS_INF;

    for (int i = 0; i < tlen; ++i) {
        int32_t f = MINUS_INF, h1;
        const int8_t *q = &qp[(size_t)target[i] * qlen];
        int beg = i > w ? i - w : 0;
        int end = i + w + 1 < qlen ? i + w + 1 : qlen;
        h1 = beg == 0 ? -(o_del + e_del * (i + 1)) : MINUS_INF;
        uint8_t *zi = tb ? &z[(size_t)i * n_col] : nullptr;
        for (j = beg; j < end; ++j) {
            int32_t mm = H[j], e = E[j];
            H[j] = h1;
            mm += q[j];
            if (tb) {
                uint8_t d = mm >= e ? 0 : 1;
                int32_t h = mm >= e ? mm : e;
                d = h >= f ? d : 2;
                h = h >= f ? h : f;
                h1 = h;
                int32_t t = mm - oe_del;
                e -= e_del;
                d |= e > t ? 1 << 2 : 0;
                e = e > t ? e : t;
                E[j] = e;
                t = mm - oe_ins;
                f -= e_ins;
                d |= f > t ? 2 << 4 : 0;
                f = f > t ? f : t;
                zi[j - beg] = d;
            } else {
                int32_t h = mm >= e ? mm : e;
                h = h >= f ? h : f;
                h1 = h;
                int32_t t = mm - oe_del;
                e -= e_del;
                e = e > t ? e : t;
                E[j] = e;
                t = mm - oe_ins;
                f -= e_ins;
                f = f > t ? f : t;
            }
        }
        H[end] = h1;
        E[end] = MINUS_INF;
    }
    int score = H[qlen];

    if (tb) {
        // traceback
        int nc = 0;
        auto push = [&](int op, int len) {
            if (nc == 0 || op != (int)(cigar_buf[nc - 1] & 0xf)) {
                cigar_buf[nc++] = (uint32_t)(len << 4 | op);
            } else {
                cigar_buf[nc - 1] += (uint32_t)(len << 4);
            }
        };
        int i = tlen - 1;
        int k = (i + w + 1 < qlen ? i + w + 1 : qlen) - 1;
        int which = 0;
        while (i >= 0 && k >= 0) {
            which = z[(size_t)i * n_col + (k - (i > w ? i - w : 0))] >> (which << 1) & 3;
            if (which == 0) { push(0, 1); --i; --k; }
            else if (which == 1) { push(2, 1); --i; }
            else { push(1, 1); --k; }
        }
        if (i >= 0) push(2, i + 1);
        if (k >= 0) push(1, k + 1);
        std::reverse(cigar_buf, cigar_buf + nc);
        *n_cigar = nc;
    }
    return score;
}

} // extern "C"


// ---------------------------------------------------------------------------
// Seed chaining (mem_chain_seeds, bwamem.cpp:806-974; test_and_merge
// :357-399).  Exact port of align/chain.py:chain_seeds (the golden-tested
// python spec): chains kept sorted by position with bisect_right insertion
// (the kbtree in-order equivalent), seeds merged into the closest chain at
// or left of rbeg, repeat fraction from >max_occ SMEM coverage in float32.
// ---------------------------------------------------------------------------

extern "C" void chain_seeds_batch(
    int64_t n_reads, const int32_t *lseq,
    const int64_t *smem_off,                    // n_reads+1
    const int32_t *smem_m, const int32_t *smem_n, const int64_t *smem_s,
    const int64_t *occ_off,                     // n_smems+1
    const int64_t *occ_rbeg,                    // consumption order
    int64_t l_pac, int32_t n_contigs, const int64_t *ctg_off,
    const uint8_t *ctg_alt,
    int32_t opt_w, int32_t max_chain_gap, int32_t max_occ,
    int32_t min_seed_len,
    // outputs; capacities: chains <= n_occ, seeds <= n_occ (flat)
    int64_t *chain_off,                         // n_reads+1
    int64_t *chain_pos, int32_t *chain_rid, uint8_t *chain_alt,
    float *chain_frac, int32_t *chain_nseeds,
    int64_t *seed_rbeg, int32_t *seed_qbeg, int32_t *seed_len) {

    struct CSeed { int64_t rbeg; int32_t qbeg, len; };
    struct CChain { int64_t pos; int32_t rid; bool alt;
                    std::vector<CSeed> seeds; };

    auto pos2rid = [&](int64_t pos_f) -> int32_t {
        if (pos_f >= l_pac) return -1;
        int64_t lo = 0, hi = n_contigs;   // bisect_right(offsets) - 1
        while (lo < hi) {
            int64_t mid = (lo + hi) >> 1;
            if (ctg_off[mid] <= pos_f) lo = mid + 1; else hi = mid;
        }
        return (int32_t)(lo - 1);
    };
    auto depos = [&](int64_t pos) -> int64_t {
        return pos >= l_pac ? (l_pac << 1) - 1 - pos : pos;
    };
    auto intv2rid = [&](int64_t rb, int64_t re) -> int32_t {
        if (rb < l_pac && l_pac < re) return -2;
        int32_t rid_b = pos2rid(depos(rb));
        int32_t rid_e = rb < re ? pos2rid(depos(re - 1)) : rid_b;
        return rid_b == rid_e ? rid_b : -1;
    };

    int64_t cw = 0, sw = 0;  // output write cursors
    chain_off[0] = 0;
    std::vector<CChain> chains;
    for (int64_t r = 0; r < n_reads; ++r) {
        chains.clear();
        int64_t s0 = smem_off[r], s1 = smem_off[r + 1];
        if (s1 > s0 && lseq[r] >= min_seed_len) {
            // repeat fraction: coverage of the read by >max_occ SMEMs
            int64_t b = 0, e = 0, l_rep = 0;
            for (int64_t i = s0; i < s1; ++i) {
                if (smem_s[i] <= max_occ) continue;
                int64_t sb = smem_m[i], se = (int64_t)smem_n[i] + 1;
                if (sb > e) { l_rep += e - b; b = sb; e = se; }
                else if (se > e) e = se;
            }
            l_rep += e - b;
            float frac_rep = (float)l_rep / (float)lseq[r];

            for (int64_t i = s0; i < s1; ++i) {
                int32_t slen = smem_n[i] + 1 - smem_m[i];
                for (int64_t o = occ_off[i]; o < occ_off[i + 1]; ++o) {
                    int64_t rbeg = occ_rbeg[o];
                    int32_t rid = intv2rid(rbeg, rbeg + slen);
                    if (rid < 0) continue;
                    CSeed seed{rbeg, smem_m[i], slen};
                    bool to_add = true;
                    if (!chains.empty()) {
                        int64_t lo = 0, hi = (int64_t)chains.size();
                        while (lo < hi) {   // bisect_right(poslist, rbeg)
                            int64_t mid = (lo + hi) >> 1;
                            if (chains[mid].pos <= rbeg) lo = mid + 1;
                            else hi = mid;
                        }
                        int64_t ci = lo - 1;
                        if (ci >= 0) {
                            // test_and_merge (bwamem.cpp:357-399)
                            CChain &c = chains[ci];
                            const CSeed &last = c.seeds.back();
                            const CSeed &first = c.seeds.front();
                            int64_t qend = (int64_t)last.qbeg + last.len;
                            int64_t rend = last.rbeg + last.len;
                            if (rid == c.rid) {
                                if (seed.qbeg >= first.qbeg
                                        && seed.qbeg + seed.len <= qend
                                        && seed.rbeg >= first.rbeg
                                        && seed.rbeg + seed.len <= rend) {
                                    to_add = false;  // contained: drop
                                } else if (!((last.rbeg < l_pac
                                              || first.rbeg < l_pac)
                                             && seed.rbeg >= l_pac)) {
                                    int64_t x = seed.qbeg - last.qbeg;
                                    int64_t y = seed.rbeg - last.rbeg;
                                    if (y >= 0 && x - y <= opt_w
                                            && y - x <= opt_w
                                            && x - last.len < max_chain_gap
                                            && y - last.len < max_chain_gap) {
                                        c.seeds.push_back(seed);
                                        to_add = false;
                                    }
                                }
                            }
                        }
                    }
                    if (to_add) {
                        int64_t lo = 0, hi = (int64_t)chains.size();
                        while (lo < hi) {
                            int64_t mid = (lo + hi) >> 1;
                            if (chains[mid].pos <= rbeg) lo = mid + 1;
                            else hi = mid;
                        }
                        CChain nc;
                        nc.pos = rbeg;
                        nc.rid = rid;
                        nc.alt = ctg_alt[rid] != 0;
                        nc.seeds.push_back(seed);
                        chains.insert(chains.begin() + lo, std::move(nc));
                    }
                }
            }
            for (const CChain &c : chains) {
                chain_pos[cw] = c.pos;
                chain_rid[cw] = c.rid;
                chain_alt[cw] = c.alt ? 1 : 0;
                chain_frac[cw] = frac_rep;
                chain_nseeds[cw] = (int32_t)c.seeds.size();
                ++cw;
                for (const CSeed &sd : c.seeds) {
                    seed_rbeg[sw] = sd.rbeg;
                    seed_qbeg[sw] = sd.qbeg;
                    seed_len[sw] = sd.len;
                    ++sw;
                }
            }
        }
        chain_off[r + 1] = cw;
    }
}


// ---------------------------------------------------------------------------
// Chain filtering (mem_chain_flt, bwamem.cpp:506-624) with klib
// ks_introsort's exact tie permutation (src/ksort.h:185-236) — port of the
// golden-tested python spec (align/chain.py:chain_filter + utils/ksort.py).
// ---------------------------------------------------------------------------

#include "nsort.h"

extern "C" void chain_filter_batch(
    int64_t n_reads,
    const int64_t *chain_off,                   // n_reads+1 (chain_seeds out)
    const uint8_t *chain_alt, const int32_t *chain_nseeds,
    const int64_t *seed_rbeg, const int32_t *seed_qbeg,
    const int32_t *seed_len,                    // flat, chain-major
    int32_t min_chain_weight, int32_t max_chain_gap,
    int32_t max_chain_extend, int32_t min_seed_len,
    float mask_level, float drop_ratio,
    // outputs: surviving chains per read, in final (sorted) order
    int64_t *out_off,                           // n_reads+1
    int64_t *out_idx,                           // global chain index
    int32_t *out_w, uint8_t *out_kept) {

    // per-chain seed start offsets (prefix over nseeds)
    int64_t total_chains = chain_off[n_reads];
    std::vector<int64_t> soff(total_chains + 1, 0);
    for (int64_t c = 0; c < total_chains; ++c)
        soff[c + 1] = soff[c] + chain_nseeds[c];

    auto chain_weight = [&](int64_t c) -> int32_t {
        int64_t w = 0, end = 0;
        for (int64_t s = soff[c]; s < soff[c + 1]; ++s) {
            int64_t qb = seed_qbeg[s], l = seed_len[s];
            if (qb >= end) w += l;
            else if (qb + l > end) w += qb + l - end;
            if (qb + l > end) end = qb + l;
        }
        int64_t tmp = w; w = 0; end = 0;
        for (int64_t s = soff[c]; s < soff[c + 1]; ++s) {
            int64_t rb = seed_rbeg[s], l = seed_len[s];
            if (rb >= end) w += l;
            else if (rb + l > end) w += rb + l - end;
            if (rb + l > end) end = rb + l;
        }
        if (w > tmp) w = tmp;
        return (int32_t)(w < (1 << 30) - 1 ? w : (1 << 30) - 1);
    };

    int64_t ow = 0;
    out_off[0] = 0;
    std::vector<int64_t> a;
    std::vector<int32_t> w;
    std::vector<int32_t> first_;
    std::vector<uint8_t> kept;
    std::vector<int64_t> chains_idx;
    for (int64_t r = 0; r < n_reads; ++r) {
        a.clear();
        std::vector<int32_t> wcache(chain_off[r + 1] - chain_off[r]);
        for (int64_t c = chain_off[r]; c < chain_off[r + 1]; ++c) {
            wcache[c - chain_off[r]] = chain_weight(c);
            if (wcache[c - chain_off[r]] >= min_chain_weight) a.push_back(c);
        }
        if (a.empty()) { out_off[r + 1] = ow; continue; }
        auto W = [&](int64_t c) { return wcache[c - chain_off[r]]; };
        ks_introsort_idx(a.data(), (int64_t)a.size(),
                         [&](int64_t x, int64_t y) { return W(x) > W(y); });
        int64_t n = (int64_t)a.size();
        w.assign(n, 0);
        first_.assign(n, -1);
        kept.assign(n, 0);
        for (int64_t i = 0; i < n; ++i) w[i] = W(a[i]);
        auto qb0 = [&](int64_t i) { return seed_qbeg[soff[a[i]]]; };
        auto qeL = [&](int64_t i) {
            int64_t s = soff[a[i] + 1] - 1;
            return (int64_t)seed_qbeg[s] + seed_len[s];
        };
        chains_idx.assign(1, 0);
        kept[0] = 3;
        for (int64_t i = 1; i < n; ++i) {
            bool large_ovlp = false, broke = false;
            for (int64_t jj : chains_idx) {
                int64_t b_max = std::max((int64_t)qb0(jj), (int64_t)qb0(i));
                int64_t e_min = std::min(qeL(jj), qeL(i));
                if (e_min > b_max
                        && (!chain_alt[a[jj]] || chain_alt[a[i]])) {
                    int64_t li = qeL(i) - qb0(i);
                    int64_t lj = qeL(jj) - qb0(jj);
                    int64_t min_l = std::min(li, lj);
                    if ((float)(e_min - b_max)
                                >= (float)min_l * mask_level
                            && min_l < max_chain_gap) {
                        large_ovlp = true;
                        if (first_[jj] < 0) first_[jj] = (int32_t)i;
                        if ((float)w[i] < (float)w[jj] * drop_ratio
                                && w[jj] - w[i] >= (min_seed_len << 1)) {
                            broke = true;
                            break;
                        }
                    }
                }
            }
            if (!broke) {
                chains_idx.push_back(i);
                kept[i] = large_ovlp ? 2 : 3;
            }
        }
        for (int64_t jj : chains_idx)
            if (first_[jj] >= 0) kept[first_[jj]] = 1;
        // cap extended chains (bwamem.cpp:597-603)
        int64_t kcnt = 0, i = 0;
        for (; i < n; ++i) {
            if (kept[i] == 1 || kept[i] == 2) {
                if (++kcnt >= max_chain_extend) break;
            }
        }
        for (int64_t i2 = i; i2 < n; ++i2)
            if (kept[i2] < 3) kept[i2] = 0;
        for (int64_t i2 = 0; i2 < n; ++i2) {
            if (kept[i2] == 0) continue;
            out_idx[ow] = a[i2];
            out_w[ow] = w[i2];
            out_kept[ow] = kept[i2];
            ++ow;
        }
        out_off[r + 1] = ow;
    }
}

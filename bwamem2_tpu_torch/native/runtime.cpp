// bwamem2_tpu native host runtime: post-extension region processing and SAM
// text generation, batched over a whole chunk with flat SoA arrays.
//
// This replaces the per-read Python of align/finalize.py (and, for PE,
// align/pairing.py) on the hot path.  The *behavioral spec* is that Python —
// itself golden-tested bit-identical against the reference binary:
//   sort_dedup_patch / patch_reg     bwamem.cpp:292-353 / 175-225
//   mem_mark_primary_se (+_core)     bwamem.cpp:1392-1464
//   mem_approx_mapq_se               bwamem.cpp:1470-1494
//   mem_reorder_primary5             bwamem.cpp:1496-1518
//   mem_reg2aln + bwa_gen_cigar2     bwamem.cpp:1732-1805, bwa.cpp:260-347
//   mem_aln2sam / mem_reg2sam        bwamem.cpp:1592-1730 / 1521-1577
//   mem_gen_alt (XA)                 bwamem_extra.cpp:122-183
//   mem_pair / mem_matesw / sam_pe   bwamem_pair.cpp:285-346/150-283/353-551
//
// Design notes (this file is NOT a transliteration of the reference):
//   * chunk-batched flat arrays in, one SAM byte blob out — the data layout
//     follows this repo's chain_seeds_batch/chain_filter_batch style, not
//     the reference's per-thread kv vectors;
//   * all float comparisons that the reference does in C `float` are done in
//     float here (Python needed numpy.float32 shims for the same effect);
//   * klib introsort tie permutations via nsort.h (shared with core.cpp).

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <cstdio>
#include <cmath>
#include <string>
#include <vector>
#include <algorithm>

#include "nsort.h"

typedef int64_t i64;
typedef int32_t i32;
typedef uint64_t u64;
typedef uint8_t u8;

// scalar kernels from core.cpp (same shared library)
extern "C" int ksw_global(int qlen, const uint8_t *query, int tlen,
                          const uint8_t *target, int m, const int8_t *mat,
                          int o_del, int e_del, int o_ins, int e_ins, int w,
                          int32_t *n_cigar, uint32_t *cigar);
extern "C" void ksw_align(int qlen, const uint8_t *query, int tlen,
                          const uint8_t *target, int m, const int8_t *mat,
                          int o_del, int e_del, int o_ins, int e_ins,
                          int xtra, int32_t *out7);

namespace {

constexpr i32 INT_MAX_C = 2147483647;
constexpr double MEM_MAPQ_COEF = 30.0;
constexpr float PATCH_MAX_R_BW = 0.05f;
constexpr double PATCH_MIN_SC_RATIO = 0.90;

// option mirror of options.MemOptions (mem_opt_t, bwamem.h:76-108); field
// order must match the ctypes.Structure in native/__init__.py
struct MemOptC {
    i32 a, b, o_del, e_del, o_ins, e_ins;
    i32 pen_unpaired, pen_clip5, pen_clip3;
    i32 w, zdrop, T, flag, min_seed_len;
    i32 max_matesw, max_XA_hits, max_XA_hits_alt, mapQ_coef_fac;
    i32 max_chain_gap, max_ins, verbose;
    float mask_level, drop_ratio, XA_drop_ratio, mask_level_redun,
          mapQ_coef_len;
    int8_t mat[25];
};

// flag bits (bwamem.h:62-73)
constexpr i32 MEM_F_PE = 0x2, MEM_F_NOPAIRING = 0x4, MEM_F_ALL = 0x8,
              MEM_F_NO_MULTI = 0x10, MEM_F_NO_RESCUE = 0x20,
              MEM_F_REF_HDR = 0x100, MEM_F_SOFTCLIP = 0x200,
              MEM_F_PRIMARY5 = 0x800, MEM_F_KEEP_SUPP_MAPQ = 0x1000;

// reference metadata view (bntseq_t analog; see index/io.py:BntSeq)
struct BnsC {
    i64 l_pac;
    i32 n_anns;
    const i64 *ann_off;
    const i64 *ann_len;
    const u8 *ann_alt;
    const char *name_blob; const i64 *name_off;   // n_anns+1 offsets
    const char *anno_blob; const i64 *anno_off;   // n_anns+1 offsets
    const u8 *ref;                                // doubled genome .0123
};

// read batch view (bseq1_t analog)
struct ReadsC {
    i64 n;
    const char *name_blob;    const i64 *name_off;
    const char *seq_blob;     const i64 *seq_off;
    const char *qual_blob;    const i64 *qual_off;
    const char *comment_blob; const i64 *comment_off;
};

// flat alignment regions, read-major (mem_alnreg_t analog, mutable)
struct RegsC {
    i64 *off;            // n_reads+1
    i64 *rb, *re;
    i32 *qb, *qe, *rid, *score, *truesc, *sub, *alt_sc, *csub, *sub_n,
        *w, *seedcov, *secondary, *secondary_all, *seedlen0, *n_comp,
        *is_alt;
    float *frac_rep;
};

struct AlnReg {
    i64 rb, re;
    i32 qb, qe, rid, score, truesc, sub, alt_sc, csub, sub_n, w, seedcov,
        secondary, secondary_all, seedlen0, n_comp, is_alt;
    float frac_rep;
    u64 hash;
};

struct Aln {   // mem_aln_t analog (finalize.py:Aln)
    i64 pos = -1;
    i32 rid = -1, flag = 0, mapq = 0, NM = -1, score = -1, sub = -1,
        alt_sc = 0;
    bool is_rev = false, is_alt = false;
    std::vector<uint32_t> cigar;   // len<<4|op, op: M I D S H = 0..4
    std::string MD;
    std::string XA;                // empty = none
    bool has_XA = false;
};

static u64 hash_64(u64 key) {           // utils.h:117-128
    key = key + ~(key << 32);
    key ^= key >> 22;
    key = key + ~(key << 13);
    key ^= key >> 8;
    key = key + (key << 3);
    key ^= key >> 15;
    key = key + ~(key << 27);
    key ^= key >> 31;
    return key;
}

static i64 bns_depos(const BnsC &bns, i64 pos, bool *is_rev) {
    *is_rev = pos >= bns.l_pac;
    return *is_rev ? (bns.l_pac << 1) - 1 - pos : pos;
}

static i32 bns_pos2rid(const BnsC &bns, i64 pos_f) {
    if (pos_f >= bns.l_pac) return -1;
    i32 lo = 0, hi = bns.n_anns;   // upper_bound over ann_off
    while (lo < hi) {
        i32 mid = (lo + hi) >> 1;
        if (bns.ann_off[mid] <= pos_f) lo = mid + 1; else hi = mid;
    }
    return lo - 1;
}

// bns_get_seq_v2 semantics (bwamem.cpp:1851-1888): direct slice of the
// doubled genome, empty when bridging the strand boundary
static const u8 *bns_get_seq(const BnsC &bns, i64 beg, i64 end, i64 *len) {
    if (end < beg) std::swap(beg, end);
    if (end > bns.l_pac << 1) end = bns.l_pac << 1;
    if (beg < 0) beg = 0;
    if (beg >= bns.l_pac || end <= bns.l_pac) { *len = end - beg; return bns.ref + beg; }
    *len = 0;
    return bns.ref;
}

static const char *ann_name(const BnsC &bns, i32 rid, i64 *len) {
    *len = bns.name_off[rid + 1] - bns.name_off[rid];
    return bns.name_blob + bns.name_off[rid];
}

// ---- text building helpers -------------------------------------------------

static inline void put_str(std::string &o, const char *s, i64 n) {
    o.append(s, (size_t)n);
}
static inline void put_c(std::string &o, char c) { o.push_back(c); }
static inline void put_int(std::string &o, i64 v) {
    char buf[24];
    int n = snprintf(buf, sizeof buf, "%lld", (long long)v);
    o.append(buf, n);
}

static const char CIGAR_CHR[] = "MIDSH";
static const char INT2BASE_F[] = "ACGTN";
static const char INT2BASE_R[] = "TGCAN";

// ---- bwa_gen_cigar2 (finalize.py:gen_cigar; bwa.cpp:260-347) ---------------

struct CigarRes {
    bool ok = false;
    i32 score = 0;
    std::vector<uint32_t> cigar;
    i32 NM = -1;
    std::string MD;
};

static void gen_cigar(const BnsC &bns, const MemOptC &opt, i32 l_query,
                      const u8 *query_in, i64 rb, i64 re, i32 w_,
                      bool want_cigar, CigarRes &out) {
    out.ok = false;
    out.cigar.clear();
    out.MD.clear();
    out.NM = -1;
    if (l_query <= 0 || rb >= re || (rb < bns.l_pac && bns.l_pac < re))
        return;
    i64 rlen = 0;
    const u8 *rseq_p = bns_get_seq(bns, rb, re, &rlen);
    if (re - rb != rlen) return;
    // reverse both on the reverse strand so indels left-shift on fwd
    std::vector<u8> qbuf, rbuf;
    const u8 *query = query_in;
    if (rb >= bns.l_pac) {
        qbuf.assign(query_in, query_in + l_query);
        std::reverse(qbuf.begin(), qbuf.end());
        rbuf.assign(rseq_p, rseq_p + rlen);
        std::reverse(rbuf.begin(), rbuf.end());
        query = qbuf.data();
        rseq_p = rbuf.data();
    }
    i32 score;
    i32 n_cigar = 0;
    if (l_query == re - rb && w_ == 0) {
        out.cigar.push_back(((uint32_t)l_query << 4) | 0);
        n_cigar = 1;
        score = 0;
        for (i32 i = 0; i < l_query; ++i)
            score += opt.mat[rseq_p[i] * 5 + query[i]];
    } else {
        i32 max_ins = (i32)((double)(((l_query + 1) >> 1) * opt.mat[0]
                                     - opt.o_ins) / opt.e_ins + 1.0);
        i32 max_del = (i32)((double)(((l_query + 1) >> 1) * opt.mat[0]
                                     - opt.o_del) / opt.e_del + 1.0);
        i32 max_gap = std::max(std::max(max_ins, max_del), 1);
        i32 w = (max_gap + (i32)std::llabs(rlen - l_query) + 1) >> 1;
        w = std::min(w, w_);
        i32 min_w = (i32)std::llabs(rlen - l_query) + 3;
        w = std::max(w, min_w);
        if (want_cigar) {
            out.cigar.resize((size_t)(l_query + rlen + 2));
            i32 nc = 0;
            score = ksw_global(l_query, query, (i32)rlen, rseq_p, 5, opt.mat,
                               opt.o_del, opt.e_del, opt.o_ins, opt.e_ins, w,
                               &nc, out.cigar.data());
            out.cigar.resize(nc);
            n_cigar = nc;
        } else {
            uint32_t dummy;
            score = ksw_global(l_query, query, (i32)rlen, rseq_p, 5, opt.mat,
                               opt.o_del, opt.e_del, opt.o_ins, opt.e_ins, w,
                               nullptr, &dummy);
            out.ok = true;
            out.score = score;
            return;
        }
    }
    if (!want_cigar) { out.ok = true; out.score = score; return; }
    // NM + MD (bwa.cpp:309-339)
    if (n_cigar) {
        const char *int2base = rb < bns.l_pac ? INT2BASE_F : INT2BASE_R;
        i64 x = 0, y = 0;
        i32 u = 0, n_mm = 0, n_gap = 0;
        std::string &md = out.MD;
        for (i32 k = 0; k < n_cigar; ++k) {
            i32 ln = (i32)(out.cigar[k] >> 4), op = out.cigar[k] & 0xF;
            if (op == 0) {
                for (i32 i = 0; i < ln; ++i) {
                    if (query[x + i] != rseq_p[y + i]) {
                        put_int(md, u);
                        md.push_back(int2base[rseq_p[y + i]]);
                        u = 0;
                        ++n_mm;
                    } else ++u;
                }
                x += ln; y += ln;
            } else if (op == 2) {
                if (k > 0 && k < n_cigar - 1) {
                    put_int(md, u);
                    md.push_back('^');
                    for (i32 i = 0; i < ln; ++i)
                        md.push_back(int2base[rseq_p[y + i]]);
                    u = 0;
                    n_gap += ln;
                }
                y += ln;
            } else if (op == 1) { x += ln; n_gap += ln; }
        }
        put_int(md, u);
        out.NM = n_mm + n_gap;
    }
    out.ok = true;
    out.score = score;
}

// ---- mem_patch_reg + mem_sort_dedup_patch (finalize.py:123-210) ------------

static bool patch_reg(const BnsC &bns, const MemOptC &opt, const u8 *query,
                      const AlnReg &a, const AlnReg &b, i32 *score_out,
                      i32 *w_out) {
    if (!query) return false;
    if (a.rb < bns.l_pac && b.rb >= bns.l_pac) return false;
    if (a.qb >= b.qb || a.qe >= b.qe || a.re >= b.re) return false;
    i32 w = (i32)std::llabs((a.re - b.rb) - (i64)(a.qe - b.qb));
    double r = std::fabs((double)(a.re - b.rb) / (b.re - a.rb)
                         - (double)(a.qe - b.qb) / (b.qe - a.qb));
    if (opt.verbose >= 4)   // bwamem.cpp:191-195 debug dump, verbatim
        fprintf(stderr, "* potential hit merge between [%d,%d)<=>[%ld,%ld) "
                "and [%d,%d)<=>[%ld,%ld), @ %.*s; w=%d, r=%.4g\n",
                a.qb, a.qe, (long)a.rb, (long)a.re, b.qb, b.qe,
                (long)b.rb, (long)b.re,
                (int)(bns.name_off[a.rid + 1] - bns.name_off[a.rid]),
                bns.name_blob + bns.name_off[a.rid], w, r);
    if (a.re < b.rb || a.qe < b.qb) {
        if (w > opt.w << 1 || r >= PATCH_MAX_R_BW) return false;
    } else if (w > opt.w << 2 || r >= PATCH_MAX_R_BW * 2) return false;
    w += a.w + b.w;
    w = std::min(w, opt.w << 2);
    if (opt.verbose >= 4)   // bwamem.cpp:206-207
        fprintf(stderr, "* test potential hit merge with global alignment; "
                "w=%d\n", w);
    CigarRes cr;
    gen_cigar(bns, opt, b.qe - a.qb, query + a.qb, a.rb, b.re, w, false, cr);
    if (!cr.ok) return false;
    i32 q_s = (i32)((double)(b.qe - a.qb) / ((b.qe - b.qb) + (a.qe - a.qb))
                    * (b.score + a.score) + 0.499);
    i32 r_s = (i32)((double)(b.re - a.rb) / ((b.re - b.rb) + (a.re - a.rb))
                    * (b.score + a.score) + 0.499);
    if (opt.verbose >= 4)   // bwamem.cpp:219-220
        fprintf(stderr, "* score=%d;(%d,%d)\n", cr.score, q_s, r_s);
    if ((double)cr.score / std::max(q_s, r_s) < PATCH_MIN_SC_RATIO)
        return false;
    *score_out = cr.score;
    *w_out = w;
    return true;
}

static void sort_dedup_patch(const BnsC &bns, const MemOptC &opt,
                             const u8 *query, std::vector<AlnReg> &regs) {
    i64 n = (i64)regs.size();
    if (n <= 1) return;
    // mem_ars2 sort: by END coordinate, klib tie permutation
    std::vector<i64> idx(n);
    for (i64 i = 0; i < n; ++i) idx[i] = i;
    ks_introsort_idx(idx.data(), n, [&](i64 x, i64 y) {
        return regs[x].re < regs[y].re;
    });
    std::vector<AlnReg> a(n);
    for (i64 i = 0; i < n; ++i) a[i] = regs[idx[i]];
    for (auto &r : a) r.n_comp = 1;
    for (i64 i = 1; i < n; ++i) {
        AlnReg &p = a[i];
        if (p.rid != a[i - 1].rid || p.rb >= a[i - 1].re + opt.max_chain_gap)
            continue;
        for (i64 j = i - 1; j >= 0; --j) {
            AlnReg &q = a[j];
            if (p.rid != q.rid || p.rb >= q.re + opt.max_chain_gap) break;
            if (q.qe == q.qb) continue;
            i64 or_ = q.re - p.rb;
            i64 oq = q.qb < p.qb ? q.qe - p.qb : p.qe - q.qb;
            i64 mr = std::min(q.re - q.rb, p.re - p.rb);
            i64 mq = std::min(q.qe - q.qb, p.qe - p.qb);
            if ((float)or_ > (float)mr * opt.mask_level_redun
                    && (float)oq > (float)mq * opt.mask_level_redun) {
                if (p.score < q.score) { p.qe = p.qb; break; }
                q.qe = q.qb;
            } else if (q.rb < p.rb && query) {
                i32 score, w;
                if (patch_reg(bns, opt, query, q, p, &score, &w)) {
                    p.n_comp += q.n_comp + 1;
                    p.seedcov = std::max(p.seedcov, q.seedcov);
                    p.sub = std::max(p.sub, q.sub);
                    p.csub = std::max(p.csub, q.csub);
                    p.qb = q.qb; p.rb = q.rb;
                    p.truesc = p.score = score;
                    p.w = w;
                    q.qb = q.qe;
                }
            }
        }
    }
    std::vector<AlnReg> b;
    b.reserve(n);
    for (auto &r : a) if (r.qe > r.qb) b.push_back(r);
    i64 m = (i64)b.size();
    idx.resize(m);
    for (i64 i = 0; i < m; ++i) idx[i] = i;
    // alnreg_slt: score desc, then rb asc, then qb asc (klib permutation)
    ks_introsort_idx(idx.data(), m, [&](i64 x, i64 y) {
        const AlnReg &p = b[x], &q = b[y];
        return p.score > q.score
            || (p.score == q.score
                && (p.rb < q.rb || (p.rb == q.rb && p.qb < q.qb)));
    });
    std::vector<AlnReg> c(m);
    for (i64 i = 0; i < m; ++i) c[i] = b[idx[i]];
    for (i64 i = 1; i < m; ++i)
        if (c[i].score == c[i - 1].score && c[i].rb == c[i - 1].rb
                && c[i].qb == c[i - 1].qb)
            c[i].qe = c[i].qb;
    regs.clear();
    if (m) regs.push_back(c[0]);
    for (i64 i = 1; i < m; ++i)
        if (c[i].qe > c[i].qb) regs.push_back(c[i]);
}

// ---- mem_mark_primary_se (finalize.py:217-282) -----------------------------

static void mark_primary_core(const MemOptC &opt, std::vector<AlnReg> &a,
                              i64 n) {
    i32 tmp = std::max({opt.a + opt.b, opt.o_del + opt.e_del,
                        opt.o_ins + opt.e_ins});
    std::vector<i64> z;
    z.push_back(0);
    for (i64 i = 1; i < n; ++i) {
        i64 matched = -1;
        for (i64 k : z) {
            i32 b_max = std::max(a[k].qb, a[i].qb);
            i32 e_min = std::min(a[k].qe, a[i].qe);
            if (e_min > b_max) {
                i32 min_l = std::min(a[i].qe - a[i].qb, a[k].qe - a[k].qb);
                if ((float)(e_min - b_max) >= (float)min_l * opt.mask_level) {
                    if (a[k].sub == 0) a[k].sub = a[i].score;
                    if (a[k].score - a[i].score <= tmp
                            && (a[k].is_alt || !a[i].is_alt))
                        ++a[k].sub_n;
                    matched = k;
                    break;
                }
            }
        }
        if (matched < 0) z.push_back(i);
        else a[i].secondary = (i32)matched;
    }
}

static i64 mark_primary(const MemOptC &opt, std::vector<AlnReg> &regs,
                        i64 read_id) {
    i64 n = (i64)regs.size();
    if (n == 0) return 0;
    i64 n_pri = 0;
    for (i64 i = 0; i < n; ++i) {
        AlnReg &r = regs[i];
        r.sub = r.alt_sc = 0;
        r.secondary = r.secondary_all = -1;
        r.hash = hash_64((u64)(read_id + i));
        if (!r.is_alt) ++n_pri;
    }
    // alnreg_hlt: score desc, is_alt asc, hash asc (hash ties ~impossible;
    // stable keeps the Python spec's `sorted` semantics regardless)
    std::stable_sort(regs.begin(), regs.end(),
                     [](const AlnReg &x, const AlnReg &y) {
        if (x.score != y.score) return x.score > y.score;
        if (x.is_alt != y.is_alt) return x.is_alt < y.is_alt;
        return x.hash < y.hash;
    });
    mark_primary_core(opt, regs, n);
    for (i64 i = 0; i < n; ++i) {
        regs[i].secondary_all = (i32)i;
        if (!regs[i].is_alt && regs[i].secondary >= 0
                && regs[regs[i].secondary].is_alt)
            regs[i].alt_sc = regs[regs[i].secondary].score;
    }
    if (n_pri >= 0 && n_pri < n) {
        std::vector<i32> z(n);
        if (n_pri > 0)   // alnreg_hlt2: is_alt asc, score desc, hash asc
            std::stable_sort(regs.begin(), regs.end(),
                             [](const AlnReg &x, const AlnReg &y) {
                if (x.is_alt != y.is_alt) return x.is_alt < y.is_alt;
                if (x.score != y.score) return x.score > y.score;
                return x.hash < y.hash;
            });
        for (i64 i = 0; i < n; ++i) z[regs[i].secondary_all] = (i32)i;
        for (i64 i = 0; i < n; ++i) {
            if (regs[i].secondary >= 0) {
                regs[i].secondary_all = z[regs[i].secondary];
                if (regs[i].is_alt) regs[i].secondary = INT_MAX_C;
            } else regs[i].secondary_all = -1;
        }
        if (n_pri > 0) {
            for (i64 i = 0; i < n_pri; ++i) {
                regs[i].sub = 0;
                regs[i].secondary = -1;
            }
            mark_primary_core(opt, regs, n_pri);
        }
    } else {
        for (auto &r : regs) r.secondary_all = r.secondary;
    }
    return n_pri;
}

// ---- mem_approx_mapq_se (finalize.py:285-308) ------------------------------

static i32 approx_mapq(const MemOptC &opt, const AlnReg &a) {
    i32 sub = a.sub ? a.sub : opt.min_seed_len * opt.a;
    sub = std::max(a.csub, sub);
    if (sub >= a.score) return 0;
    i64 ln = std::max((i64)(a.qe - a.qb), a.re - a.rb);
    double identity = 1.0 - (double)(ln * opt.a - a.score)
                            / (opt.a + opt.b) / ln;
    i32 mapq;
    if (a.score == 0) mapq = 0;
    else if (opt.mapQ_coef_len > 0) {
        double tmp = ln < opt.mapQ_coef_len
            ? 1.0 : (double)opt.mapQ_coef_fac / std::log((double)ln);
        tmp *= identity * identity;
        mapq = (i32)(6.02 * (a.score - sub) / opt.a * tmp * tmp + 0.499);
    } else {
        mapq = (i32)(MEM_MAPQ_COEF * (1.0 - (double)sub / a.score)
                     * std::log((double)a.seedcov) + 0.499);
        if (identity < 0.95)
            mapq = (i32)(mapq * identity * identity + 0.499);
    }
    if (a.sub_n > 0)
        mapq -= (i32)(4.343 * std::log(a.sub_n + 1.0) + 0.499);
    mapq = std::min(mapq, 60);
    mapq = std::max(mapq, 0);
    return (i32)(mapq * (1.0 - a.frac_rep) + 0.499);
}

// ---- mem_reorder_primary5 (finalize.py:311-335) ----------------------------

static void reorder_primary5(i32 T, std::vector<AlnReg> &a) {
    i64 n_pri = 0;
    for (auto &p : a)
        if (p.secondary < 0 && !p.is_alt && p.score >= T) ++n_pri;
    if (n_pri <= 1) return;
    i32 left_st = INT_MAX_C;
    i64 left_k = -1;
    for (i64 k = 0; k < (i64)a.size(); ++k) {
        const AlnReg &p = a[k];
        if (p.secondary >= 0 || p.is_alt || p.score < T) continue;
        if (p.qb < left_st) { left_st = p.qb; left_k = k; }
    }
    if (left_k == 0) return;
    std::swap(a[0], a[left_k]);
    for (i64 k = 1; k < (i64)a.size(); ++k) {
        AlnReg &p = a[k];
        if (p.secondary == 0) p.secondary = (i32)left_k;
        else if (p.secondary == (i32)left_k) p.secondary = 0;
        if (p.secondary_all == 0) p.secondary_all = (i32)left_k;
        else if (p.secondary_all == (i32)left_k) p.secondary_all = 0;
    }
}

// ---- mem_reg2aln (finalize.py:360-426) -------------------------------------

static i32 infer_bw(i32 l1, i32 l2, i32 score, i32 a, i32 q, i32 r) {
    if (l1 == l2 && l1 * a - score < (q + r - a) << 1) return 0;
    i32 w = (i32)((double)(std::min(l1, l2) * a - score - q) / r + 2.0);
    return std::max(w, std::abs(l1 - l2));
}

static void reg2aln(const BnsC &bns, const MemOptC &opt, i32 l_query,
                    const u8 *query, const AlnReg *ar, Aln &a) {
    a = Aln();
    if (!ar || ar->rb < 0 || ar->re < 0) {
        a.rid = -1; a.pos = -1; a.flag = 0x4;
        a.score = 0; a.sub = 0; a.NM = 0;
        return;
    }
    i32 qb = ar->qb, qe = ar->qe;
    i64 rb = ar->rb, re = ar->re;
    a.mapq = ar->secondary < 0 ? approx_mapq(opt, *ar) : 0;
    if (ar->secondary >= 0) a.flag |= 0x100;
    i32 w2 = std::max(
        infer_bw(qe - qb, (i32)(re - rb), ar->truesc, opt.a, opt.o_del,
                 opt.e_del),
        infer_bw(qe - qb, (i32)(re - rb), ar->truesc, opt.a, opt.o_ins,
                 opt.e_ins));
    if (opt.verbose >= 4)   // bwamem.cpp:1755
        fprintf(stderr, "* Band width: inferred=%d, cmd_opt=%d, alnreg=%d\n",
                w2, opt.w, ar->w);
    if (w2 > opt.w) w2 = std::min(w2, ar->w);
    i32 last_sc = -(1 << 30);
    i32 i = 0;
    CigarRes cr;
    for (;;) {
        w2 = std::min(w2, opt.w << 2);
        gen_cigar(bns, opt, qe - qb, query + qb, rb, re, w2, true, cr);
        if (opt.verbose >= 4)   // bwamem.cpp:1762
            fprintf(stderr, "* Final alignment: w2=%d, global_sc=%d, "
                    "local_sc=%d\n", w2, cr.score, ar->truesc);
        if (cr.score == last_sc || w2 == opt.w << 2) break;
        last_sc = cr.score;
        w2 <<= 1;
        ++i;
        if (!(i < 3 && cr.score < ar->truesc - opt.a)) break;
    }
    bool is_rev;
    i64 pos_f = bns_depos(bns, rb < bns.l_pac ? rb : re - 1, &is_rev);
    a.is_rev = is_rev;
    std::vector<uint32_t> &cigar = cr.cigar;
    if (!cigar.empty()) {
        if ((cigar.front() & 0xF) == 2) {          // leading deletion
            pos_f += cigar.front() >> 4;
            cigar.erase(cigar.begin());
        } else if ((cigar.back() & 0xF) == 2) {
            cigar.pop_back();
        }
    }
    if (qb != 0 || qe != l_query) {                // soft clipping
        i32 clip5 = is_rev ? l_query - qe : qb;
        i32 clip3 = is_rev ? qb : l_query - qe;
        if (clip5)
            cigar.insert(cigar.begin(), ((uint32_t)clip5 << 4) | 3);
        if (clip3)
            cigar.push_back(((uint32_t)clip3 << 4) | 3);
    }
    a.rid = bns_pos2rid(bns, pos_f);
    a.pos = pos_f - bns.ann_off[a.rid];
    a.cigar = std::move(cigar);
    a.NM = cr.NM;
    a.MD = std::move(cr.MD);
    a.score = ar->score;
    a.sub = std::max(ar->sub, ar->csub);
    a.is_alt = ar->is_alt != 0;
    a.alt_sc = ar->alt_sc;
}

// ---- mem_gen_alt XA strings (finalize.py:433-477) --------------------------

static void gen_alt(const BnsC &bns, const MemOptC &opt,
                    const std::vector<AlnReg> &regs, i32 l_query,
                    const u8 *query, std::vector<std::string> &XA,
                    std::vector<bool> &has_XA) {
    i64 n = (i64)regs.size();
    XA.assign(n, std::string());
    has_XA.assign(n, false);
    // get_pri_idx: XA_drop_ratio widened to double exactly like the C call
    auto pri_idx = [&](i64 i) -> i64 {
        i64 k = regs[i].secondary_all;
        if (k >= 0 && (double)regs[i].score
                >= (double)regs[k].score * (double)opt.XA_drop_ratio)
            return k;
        return -1;
    };
    std::vector<i32> cnt(n, 0);
    std::vector<bool> hasalt(n, false);
    i64 tot = 0;
    for (i64 i = 0; i < n; ++i) {
        i64 r = pri_idx(i);
        if (r >= 0) {
            ++cnt[r];
            ++tot;
            if (regs[i].is_alt) hasalt[r] = true;
        }
    }
    if (tot == 0) return;
    Aln t;
    for (i64 i = 0; i < n; ++i) {
        i64 r = pri_idx(i);
        if (r < 0) continue;
        if (cnt[r] > opt.max_XA_hits_alt
                || (!hasalt[r] && cnt[r] > opt.max_XA_hits))
            continue;
        reg2aln(bns, opt, l_query, query, &regs[i], t);
        std::string &s = XA[r];
        i64 nl;
        const char *nm = ann_name(bns, t.rid, &nl);
        put_str(s, nm, nl);
        put_c(s, ',');
        put_c(s, t.is_rev ? '-' : '+');
        put_int(s, t.pos + 1);
        put_c(s, ',');
        for (uint32_t c : t.cigar) {
            put_int(s, c >> 4);
            put_c(s, "MIDSHN"[c & 0xF]);
        }
        put_c(s, ',');
        put_int(s, t.NM);
        put_c(s, ';');
        has_XA[r] = true;
    }
}

// ---- mem_aln2sam (finalize.py:484-610) -------------------------------------

static i32 get_rlen(const std::vector<uint32_t> &cigar) {
    i32 l = 0;
    for (uint32_t c : cigar) {
        i32 op = c & 0xF;
        if (op == 0 || op == 2) l += c >> 4;
    }
    return l;
}

static void put_cigar_str(std::string &o, const MemOptC &opt, const Aln &p,
                          i32 which) {
    if (p.cigar.empty()) { put_c(o, '*'); return; }
    for (uint32_t c : p.cigar) {
        i32 op = c & 0xF;
        if (!(opt.flag & MEM_F_SOFTCLIP) && !p.is_alt
                && (op == 3 || op == 4))
            op = which ? 4 : 3;
        put_int(o, c >> 4);
        put_c(o, CIGAR_CHR[op]);
    }
}

static const char *RC_TABLE_INIT() {
    static char t[256];
    for (int i = 0; i < 256; ++i) t[i] = 'N';
    t['A'] = 'T'; t['C'] = 'G'; t['G'] = 'C'; t['T'] = 'A'; t['N'] = 'N';
    return t;
}
static const char *RC_TABLE = RC_TABLE_INIT();

struct ReadView {
    const char *name; i64 l_name;
    const char *seq;  i64 l_seq;
    const char *qual; i64 l_qual;      // 0 = absent
    const char *comment; i64 l_comment;  // 0 = absent
};

static void aln2sam(const BnsC &bns, const MemOptC &opt, const ReadView &rd,
                    i32 n, const std::vector<Aln> &alns, i32 which,
                    const Aln *m_, const char *rg_id, i64 l_rg,
                    std::string &out) {
    Aln p = alns[which];          // local copies: flag mutations below
    Aln mcopy;
    Aln *m = nullptr;
    if (m_) { mcopy = *m_; m = &mcopy; }
    p.flag |= m ? 0x1 : 0;
    p.flag |= p.rid < 0 ? 0x4 : 0;
    p.flag |= (m && m->rid < 0) ? 0x8 : 0;
    if (p.rid < 0 && m && m->rid >= 0) {
        p.rid = m->rid; p.pos = m->pos; p.is_rev = m->is_rev;
        p.cigar.clear();
    }
    if (m && m->rid < 0 && p.rid >= 0) {
        m->rid = p.rid; m->pos = p.pos; m->is_rev = p.is_rev;
        m->cigar.clear();
    }
    p.flag |= p.is_rev ? 0x10 : 0;
    p.flag |= (m && m->is_rev) ? 0x20 : 0;

    put_str(out, rd.name, rd.l_name);
    put_c(out, '\t');
    put_int(out, (p.flag & 0xFFFF) | ((p.flag & 0x10000) ? 0x100 : 0));
    if (p.rid >= 0) {
        i64 nl;
        const char *nm = ann_name(bns, p.rid, &nl);
        put_c(out, '\t');
        put_str(out, nm, nl);
        put_c(out, '\t');
        put_int(out, p.pos + 1);
        put_c(out, '\t');
        put_int(out, p.mapq);
        put_c(out, '\t');
        put_cigar_str(out, opt, p, which);
    } else {
        out.append("\t*\t0\t0\t*");
    }
    // mate position
    if (m && m->rid >= 0) {
        put_c(out, '\t');
        if (p.rid == m->rid) put_c(out, '=');
        else {
            i64 nl;
            const char *nm = ann_name(bns, m->rid, &nl);
            put_str(out, nm, nl);
        }
        put_c(out, '\t');
        put_int(out, m->pos + 1);
        put_c(out, '\t');
        if (p.rid == m->rid) {
            i64 p0 = p.pos + (p.is_rev ? get_rlen(p.cigar) - 1 : 0);
            i64 p1 = m->pos + (m->is_rev ? get_rlen(m->cigar) - 1 : 0);
            if (m->cigar.empty() || p.cigar.empty()) put_c(out, '0');
            else
                put_int(out, -(p0 - p1 + (p0 > p1 ? 1 : p0 < p1 ? -1 : 0)));
        } else put_c(out, '0');
    } else {
        out.append("\t*\t0\t0");
    }
    put_c(out, '\t');

    // SEQ / QUAL
    if (p.flag & 0x100) {
        out.append("*\t*");
    } else {
        i64 qb = 0, qe = rd.l_seq;
        bool clip_ok = !p.cigar.empty() && which
            && !(opt.flag & MEM_F_SOFTCLIP) && !p.is_alt;
        if (!p.is_rev) {
            if (clip_ok) {
                i32 op0 = p.cigar.front() & 0xF;
                i32 opn = p.cigar.back() & 0xF;
                if (op0 == 3 || op0 == 4) qb += p.cigar.front() >> 4;
                if (opn == 3 || opn == 4) qe -= p.cigar.back() >> 4;
            }
            put_str(out, rd.seq + qb, qe - qb);
            put_c(out, '\t');
            if (rd.l_qual) put_str(out, rd.qual + qb, qe - qb);
            else put_c(out, '*');
        } else {
            if (clip_ok) {
                i32 op0 = p.cigar.front() & 0xF;
                i32 opn = p.cigar.back() & 0xF;
                if (op0 == 3 || op0 == 4) qe -= p.cigar.front() >> 4;
                if (opn == 3 || opn == 4) qb += p.cigar.back() >> 4;
            }
            for (i64 i = qe - 1; i >= qb; --i)
                put_c(out, RC_TABLE[(u8)rd.seq[i]]);
            put_c(out, '\t');
            if (rd.l_qual)
                for (i64 i = qe - 1; i >= qb; --i) put_c(out, rd.qual[i]);
            else put_c(out, '*');
        }
    }

    // tags
    char buf[64];
    if (!p.cigar.empty()) {
        out.append("\tNM:i:");
        put_int(out, p.NM);
        out.append("\tMD:Z:");
        out.append(p.MD);
    }
    if (m && !m->cigar.empty()) {
        out.append("\tMC:Z:");
        put_cigar_str(out, opt, *m, which);
    }
    if (p.score >= 0) { out.append("\tAS:i:"); put_int(out, p.score); }
    if (p.sub >= 0) { out.append("\tXS:i:"); put_int(out, p.sub); }
    if (rg_id && l_rg) { out.append("\tRG:Z:"); put_str(out, rg_id, l_rg); }
    if (!(p.flag & 0x100)) {
        bool any = false;
        for (i32 i = 0; i < n; ++i)
            if (i != which && !(alns[i].flag & 0x100)) { any = true; break; }
        if (any) {
            out.append("\tSA:Z:");
            for (i32 i = 0; i < n; ++i) {
                if (i == which || (alns[i].flag & 0x100)) continue;
                const Aln &r = alns[i];
                i64 nl;
                const char *nm = ann_name(bns, r.rid, &nl);
                put_str(out, nm, nl);
                put_c(out, ',');
                put_int(out, r.pos + 1);
                put_c(out, ',');
                put_c(out, r.is_rev ? '-' : '+');
                put_c(out, ',');
                for (uint32_t c : r.cigar) {
                    put_int(out, c >> 4);
                    put_c(out, CIGAR_CHR[c & 0xF]);
                }
                put_c(out, ',');
                put_int(out, r.mapq);
                put_c(out, ',');
                put_int(out, r.NM);
                put_c(out, ';');
            }
        }
        if (p.alt_sc > 0) {
            int l = snprintf(buf, sizeof buf, "\tpa:f:%.3f",
                             (double)p.score / p.alt_sc);
            out.append(buf, l);
        }
    }
    if (p.has_XA) {
        out.append("\tXA:Z:");
        out.append(p.XA);
    }
    if (rd.l_comment) {
        put_c(out, '\t');
        put_str(out, rd.comment, rd.l_comment);
    }
    if ((opt.flag & MEM_F_REF_HDR) && p.rid >= 0
            && bns.anno_off[p.rid + 1] > bns.anno_off[p.rid]) {
        out.append("\tXR:Z:");
        for (i64 i = bns.anno_off[p.rid]; i < bns.anno_off[p.rid + 1]; ++i) {
            char c = bns.anno_blob[i];
            put_c(out, c == '\t' ? ' ' : c);
        }
    }
    put_c(out, '\n');
}

// ---- mem_reg2sam (finalize.py:613-648) -------------------------------------

static void reg2sam(const BnsC &bns, const MemOptC &opt, const ReadView &rd,
                    const u8 *query, i32 l_query, std::vector<AlnReg> &regs,
                    i32 extra_flag, const Aln *m_, const char *rg_id,
                    i64 l_rg, std::string &out) {
    std::vector<std::string> XA;
    std::vector<bool> has_XA;
    bool use_XA = !(opt.flag & MEM_F_ALL);
    if (use_XA) gen_alt(bns, opt, regs, l_query, query, XA, has_XA);
    std::vector<Aln> aa;
    for (i64 k = 0; k < (i64)regs.size(); ++k) {
        AlnReg &p = regs[k];
        if (p.score < opt.T) continue;
        if (p.secondary >= 0 && (p.is_alt || !(opt.flag & MEM_F_ALL)))
            continue;
        if (p.secondary >= 0 && p.secondary < INT_MAX_C
                && (float)p.score
                   < (float)regs[p.secondary].score * opt.drop_ratio)
            continue;
        aa.emplace_back();
        Aln &q = aa.back();
        reg2aln(bns, opt, l_query, query, &p, q);
        if (use_XA && has_XA[k]) { q.XA = XA[k]; q.has_XA = true; }
        q.flag |= extra_flag;
        if (p.secondary >= 0) q.sub = -1;
        if (aa.size() > 1 && p.secondary < 0)
            q.flag |= (opt.flag & MEM_F_NO_MULTI) ? 0x10000 : 0x800;
        if (!(opt.flag & MEM_F_KEEP_SUPP_MAPQ) && aa.size() > 1 && !p.is_alt
                && q.mapq > aa[0].mapq)
            q.mapq = aa[0].mapq;
    }
    if (aa.empty()) {
        std::vector<Aln> t(1);
        reg2aln(bns, opt, l_query, query, nullptr, t[0]);
        t[0].flag |= extra_flag;
        aln2sam(bns, opt, rd, 1, t, 0, m_, rg_id, l_rg, out);
        return;
    }
    for (i32 k = 0; k < (i32)aa.size(); ++k)
        aln2sam(bns, opt, rd, (i32)aa.size(), aa, k, m_, rg_id, l_rg, out);
}

// ---- marshalling helpers ---------------------------------------------------

static void load_regs(const RegsC &R, i64 i, std::vector<AlnReg> &out) {
    out.clear();
    for (i64 j = R.off[i]; j < R.off[i + 1]; ++j) {
        AlnReg r;
        r.rb = R.rb[j]; r.re = R.re[j];
        r.qb = R.qb[j]; r.qe = R.qe[j]; r.rid = R.rid[j];
        r.score = R.score[j]; r.truesc = R.truesc[j];
        r.sub = R.sub[j]; r.alt_sc = R.alt_sc[j]; r.csub = R.csub[j];
        r.sub_n = R.sub_n[j]; r.w = R.w[j]; r.seedcov = R.seedcov[j];
        r.secondary = R.secondary[j]; r.secondary_all = R.secondary_all[j];
        r.seedlen0 = R.seedlen0[j]; r.n_comp = R.n_comp[j];
        r.is_alt = R.is_alt[j]; r.frac_rep = R.frac_rep[j];
        r.hash = 0;
        out.push_back(r);
    }
}

static void store_regs(RegsC &R, i64 j0, const std::vector<AlnReg> &in) {
    for (i64 t = 0; t < (i64)in.size(); ++t) {
        const AlnReg &r = in[t];
        i64 j = j0 + t;
        R.rb[j] = r.rb; R.re[j] = r.re;
        R.qb[j] = r.qb; R.qe[j] = r.qe; R.rid[j] = r.rid;
        R.score[j] = r.score; R.truesc[j] = r.truesc;
        R.sub[j] = r.sub; R.alt_sc[j] = r.alt_sc; R.csub[j] = r.csub;
        R.sub_n[j] = r.sub_n; R.w[j] = r.w; R.seedcov[j] = r.seedcov;
        R.secondary[j] = r.secondary; R.secondary_all[j] = r.secondary_all;
        R.seedlen0[j] = r.seedlen0; R.n_comp[j] = r.n_comp;
        R.is_alt[j] = r.is_alt; R.frac_rep[j] = r.frac_rep;
    }
}

static u8 NT4[256];
static bool nt4_init_done = [] {
    for (int i = 0; i < 256; ++i) NT4[i] = 4;
    NT4['A'] = NT4['a'] = 0; NT4['C'] = NT4['c'] = 1;
    NT4['G'] = NT4['g'] = 2; NT4['T'] = NT4['t'] = 3;
    NT4['-'] = 5;
    return true;
}();

static void encode_read(const char *seq, i64 n, std::vector<u8> &enc) {
    enc.resize(n);
    for (i64 i = 0; i < n; ++i) enc[i] = NT4[(u8)seq[i]];
}

// ---------------------------------------------------------------------------
// FM-index scalar ops + per-pivot SMEM enumeration (align/seeding.py spec;
// FMI_search.cpp:496-670).  Used as the overflow fallback for the device
// seeding kernels — a pivot whose candidate count exceeds the device cap is
// re-enumerated here exactly.
// ---------------------------------------------------------------------------

struct FmiC {
    const i64 *counts;    // int64[5], cumulative (+1 sentinel applied)
    const i64 *cp_count;  // int64[nblocks][4]
    const u64 *one_hot;   // uint64[nblocks][4], bit 63 = first char
    i64 sentinel;
};

static inline i64 fmi_occ(const FmiC &f, i64 pos, i32 c) {
    i64 blk = pos >> 6;
    i64 y = pos & 63;
    i64 base = f.cp_count[blk * 4 + c];
    if (y == 0) return base;
    u64 mask = (~0ull) << (64 - y);
    return base + (i64)__builtin_popcountll(f.one_hot[blk * 4 + c] & mask);
}

// backwardExt (fmindex.py:backward_ext; FMI_search.cpp:1025-1052)
static void fmi_backward_ext(const FmiC &f, i64 k, i64 l, i64 s, i32 a,
                             i64 *ko, i64 *lo, i64 *so) {
    i64 kk[4], ss[4], ll[4];
    for (i32 b = 0; b < 4; ++b) {
        i64 sp = fmi_occ(f, k, b);
        i64 ep = fmi_occ(f, k + s, b);
        kk[b] = f.counts[b] + sp;
        ss[b] = ep - sp;
    }
    i64 sent = (k <= f.sentinel && f.sentinel < k + s) ? 1 : 0;
    ll[3] = l + sent;
    ll[2] = ll[3] + ss[3];
    ll[1] = ll[2] + ss[2];
    ll[0] = ll[1] + ss[1];
    *ko = kk[a];
    *lo = ll[a];
    *so = ss[a];
}

struct SmemTuple { i32 rid, m, n; i64 k, l, s; };

// smems_one_pos (align/seeding.py:23-100): enumerate SMEMs through pivot x
static i64 smems_one_pos(const FmiC &f, const u8 *enc, i64 readlength,
                         i32 rid, i64 x, i64 min_intv, i32 min_seed_len,
                         std::vector<SmemTuple> &out) {
    i64 next_x = x + 1;
    i32 a = enc[x];
    if (a >= 4) return next_x;
    i64 k = f.counts[a];
    i64 l = f.counts[3 - a];
    i64 s = f.counts[a + 1] - f.counts[a];
    i64 m = x, n = x;
    struct Cand { i64 m, n, k, l, s; };
    std::vector<Cand> prev, curr;
    bool broke = false;
    i64 j;
    for (j = x + 1; j < readlength; ++j) {
        i32 aj = enc[j];
        next_x = j + 1;
        if (aj >= 4) { broke = true; break; }
        i64 nk, nl, ns;
        // forward extension == backward on the RC index: swap k/l
        fmi_backward_ext(f, l, k, s, 3 - aj, &nk, &nl, &ns);
        std::swap(nk, nl);
        if (ns != s) prev.push_back({m, n, k, l, s});
        if (ns < min_intv) { next_x = j; broke = true; break; }
        k = nk; l = nl; s = ns; n = j;
    }
    if (!broke) next_x = readlength;
    if (s >= min_intv) prev.push_back({m, n, k, l, s});
    std::reverse(prev.begin(), prev.end());   // longest-match first

    for (j = x - 1; j >= 0; --j) {
        if (prev.empty()) break;
        i32 aj = enc[j];
        if (aj >= 4) break;
        curr.clear();
        i64 curr_s = -1;
        size_t p = 0;
        for (; p < prev.size(); ++p) {
            const Cand &c = prev[p];
            i64 nk, nl, ns;
            fmi_backward_ext(f, c.k, c.l, c.s, aj, &nk, &nl, &ns);
            if (ns < min_intv && (c.n - c.m + 1) >= min_seed_len) {
                out.push_back({rid, (i32)c.m, (i32)c.n, c.k, c.l, c.s});
                ++p;
                break;
            }
            if (ns >= min_intv && ns != curr_s) {
                curr_s = ns;
                curr.push_back({j, c.n, nk, nl, ns});
                ++p;
                break;
            }
        }
        for (; p < prev.size(); ++p) {   // distinct survivors
            const Cand &c = prev[p];
            i64 nk, nl, ns;
            fmi_backward_ext(f, c.k, c.l, c.s, aj, &nk, &nl, &ns);
            if (ns >= min_intv && ns != curr_s) {
                curr_s = ns;
                curr.push_back({j, c.n, nk, nl, ns});
            }
        }
        std::swap(prev, curr);
        if (prev.empty()) break;
    }
    if (!prev.empty()) {
        const Cand &c = prev[0];
        if (c.n - c.m + 1 >= min_seed_len)
            out.push_back({rid, (i32)c.m, (i32)c.n, c.k, c.l, c.s});
    }
    return next_x;
}

// ---------------------------------------------------------------------------
// Paired-end: mem_pair / mem_matesw / mem_sam_pe (align/pairing.py spec;
// bwamem_pair.cpp:58-551)
// ---------------------------------------------------------------------------

constexpr double MIN_RATIO_PE = 0.8;
constexpr i32 KSW_XBYTE = 0x10000, KSW_XSUBO = 0x40000, KSW_XSTART = 0x80000;
constexpr double M_SQRT1_2_C = 0.70710678118654752440;

struct PEStatC {            // mem_pestat_t (pairing.py:PEStat)
    i32 low, high, failed;
    double avg, std;
};

// mem_infer_dir (pairing.py:44-49): orientation FF/FR/RF/RR + distance
static i32 infer_dir(i64 l_pac, i64 b1, i64 b2, i64 *dist) {
    bool r1 = b1 >= l_pac, r2 = b2 >= l_pac;
    i64 p2 = (r1 == r2) ? b2 : (l_pac << 1) - 1 - b2;
    *dist = p2 > b1 ? p2 - b1 : b1 - p2;
    return (r1 == r2 ? 0 : 1) ^ (p2 > b1 ? 0 : 3);
}

// bns_fetch_seq_v2 (fmindex.py:fetch_seq): clamp [beg,end) to mid's contig
static const u8 *fetch_seq(const BnsC &bns, i64 beg, i64 mid, i64 end,
                           i32 *rid, i64 *beg_o, i64 *end_o, i64 *len) {
    if (end < beg) std::swap(beg, end);
    bool is_rev;
    i64 pos_f = bns_depos(bns, mid, &is_rev);
    *rid = bns_pos2rid(bns, pos_f);
    i64 far_beg = bns.ann_off[*rid];
    i64 far_end = far_beg + bns.ann_len[*rid];
    if (is_rev) {
        i64 nb = (bns.l_pac << 1) - far_end;
        far_end = (bns.l_pac << 1) - far_beg;
        far_beg = nb;
    }
    beg = std::max(beg, far_beg);
    end = std::min(end, far_end);
    *beg_o = beg;
    *end_o = end;
    return bns_get_seq(bns, beg, end, len);
}

// rescue window geometry (pairing.py:matesw_window)
static void matesw_window(const PEStatC *pes, i32 r, i64 a_rb, i32 l_ms,
                          i64 l_pac, i64 *rb, i64 *re, bool *is_rev) {
    *is_rev = ((r >> 1) != (r & 1));
    bool is_larger = !(r >> 1);
    if (!*is_rev) {
        *rb = is_larger ? a_rb + pes[r].low : a_rb - pes[r].high;
        *re = (is_larger ? a_rb + pes[r].high : a_rb - pes[r].low) + l_ms;
    } else {
        *rb = (is_larger ? a_rb + pes[r].low : a_rb - pes[r].high) - l_ms;
        *re = is_larger ? a_rb + pes[r].high : a_rb - pes[r].low;
    }
    *rb = std::max(*rb, (i64)0);
    *re = std::min(*re, l_pac << 1);
}

// pre-batched device rescue results keyed (pair, end, anchor_j, r)
struct RescueMap {
    i64 n = 0;
    const i32 *key_p = nullptr, *key_end = nullptr, *key_j = nullptr,
              *key_r = nullptr;
    const i32 *res = nullptr;  // n x 7 kswr tuples
    mutable i64 host_sw = 0;   // rescue SWs that found no result here
    // simple open-addressed map built once per chunk
    std::vector<i64> table;    // index+1, 0 = empty
    u64 mask = 0;
    static u64 pack(i64 p, i32 end, i32 j, i32 r) {
        return ((u64)p << 18) | ((u64)end << 17) | ((u64)j << 2) | (u64)r;
    }
    void build() {
        u64 cap = 16;
        while (cap < (u64)n * 2 + 1) cap <<= 1;
        table.assign(cap, 0);
        mask = cap - 1;
        for (i64 i = 0; i < n; ++i) {
            u64 k = pack(key_p[i], key_end[i], key_j[i], key_r[i]);
            u64 h = hash_64(k) & mask;
            while (table[h]) h = (h + 1) & mask;
            table[h] = i + 1;
        }
    }
    const i32 *find(i64 p, i32 end, i32 j, i32 r) const {
        if (!n) return nullptr;
        u64 k = pack(p, end, j, r);
        u64 h = hash_64(k) & mask;
        while (table[h]) {
            i64 i = table[h] - 1;
            if (key_p[i] == p && key_end[i] == end && key_j[i] == j
                    && key_r[i] == r)
                return res + i * 7;
            h = (h + 1) & mask;
        }
        return nullptr;
    }
};

// mem_matesw for one anchor (pairing.py:130-190); returns #windows tried
static i32 matesw(const BnsC &bns, const MemOptC &opt, const PEStatC *pes,
                  const AlnReg &anchor, i32 l_ms, const u8 *ms,
                  std::vector<AlnReg> &ma, const RescueMap &rescue,
                  i64 rp, i32 rend, i32 rj) {
    i64 l_pac = bns.l_pac;
    bool skip[4];
    for (i32 r = 0; r < 4; ++r) skip[r] = pes[r].failed != 0;
    for (const AlnReg &reg : ma) {
        i64 dist;
        i32 r = infer_dir(l_pac, anchor.rb, reg.rb, &dist);
        if (pes[r].low <= dist && dist <= pes[r].high) skip[r] = true;
    }
    if (skip[0] && skip[1] && skip[2] && skip[3]) return 0;
    i32 n = 0;
    std::vector<u8> seqbuf;
    for (i32 r = 0; r < 4; ++r) {
        if (skip[r]) continue;
        i64 rb, re;
        bool is_rev;
        matesw_window(pes, r, anchor.rb, l_ms, l_pac, &rb, &re, &is_rev);
        i32 rid = -1;
        const u8 *ref = nullptr;
        i64 rlen = 0;
        if (rb < re)
            ref = fetch_seq(bns, rb, (rb + re) >> 1, re, &rid, &rb, &re,
                            &rlen);
        if (anchor.rid == rid && re - rb >= opt.min_seed_len) {
            const i32 *pre = rescue.find(rp, rend, rj, r);
            i32 res[7];
            if (pre) {
                memcpy(res, pre, sizeof res);
            } else {
                ++rescue.host_sw;
                const u8 *seq = ms;
                if (is_rev) {
                    seqbuf.resize(l_ms);
                    for (i32 i = 0; i < l_ms; ++i) {
                        u8 c = ms[l_ms - 1 - i];
                        seqbuf[i] = c < 4 ? 3 - c : 4;
                    }
                    seq = seqbuf.data();
                }
                i32 xtra = KSW_XSUBO | KSW_XSTART
                    | (l_ms * opt.a < 250 ? KSW_XBYTE : 0)
                    | (opt.min_seed_len * opt.a);
                ksw_align(l_ms, seq, (i32)rlen, ref, 5, opt.mat, opt.o_del,
                          opt.e_del, opt.o_ins, opt.e_ins, xtra, res);
            }
            i32 score = res[0], te = res[1], qe = res[2], score2 = res[3],
                tb = res[5], qb = res[6];
            if (score >= opt.min_seed_len && qb >= 0) {
                AlnReg b = AlnReg();
                b.rid = anchor.rid;
                b.is_alt = anchor.is_alt;
                b.score = score;
                b.csub = score2;
                b.secondary = -1;
                b.sub = b.alt_sc = b.sub_n = b.w = b.seedlen0 = 0;
                b.truesc = 0; b.secondary_all = 0; b.frac_rep = 0.0f;
                b.n_comp = 1; b.hash = 0;
                b.qb = is_rev ? l_ms - (qe + 1) : qb;
                b.qe = is_rev ? l_ms - qb : qe + 1;
                b.rb = is_rev ? (l_pac << 1) - (rb + te + 1) : rb + tb;
                b.re = is_rev ? (l_pac << 1) - (rb + tb) : rb + te + 1;
                b.seedcov = (i32)(std::min(b.re - b.rb,
                                           (i64)(b.qe - b.qb)) >> 1);
                size_t ins = ma.size();
                for (size_t i = 0; i < ma.size(); ++i)
                    if (ma[i].score < b.score) { ins = i; break; }
                ma.insert(ma.begin() + ins, b);
            }
            ++n;
        }
        if (n) sort_dedup_patch(bns, opt, nullptr, ma);
    }
    return n;
}

// mem_pair (pairing.py:269-326)
static void mem_pair(const BnsC &bns, const MemOptC &opt, const PEStatC *pes,
                     const std::vector<AlnReg> a[2], i64 read_id,
                     const i64 n_pri[2], i32 *o_out, i32 *subo_out,
                     i32 *n_sub_out, i64 z[2]) {
    i64 l_pac = bns.l_pac;
    std::vector<std::pair<u64, u64>> v;
    for (i32 r = 0; r < 2; ++r)
        for (i64 i = 0; i < n_pri[r]; ++i) {
            const AlnReg &e = a[r][i];
            i64 x = e.rb < l_pac ? e.rb : (l_pac << 1) - 1 - e.rb;
            u64 key_x = ((u64)e.rid << 32) | (u64)(x - bns.ann_off[e.rid]);
            u64 key_y = ((u64)e.score << 32) | ((u64)i << 2)
                | ((u64)(e.rb >= l_pac) << 1) | (u64)r;
            v.push_back({key_x, key_y});
        }
    std::sort(v.begin(), v.end());
    i64 y[4] = {-1, -1, -1, -1};
    std::vector<std::pair<u64, u64>> u;
    for (i64 i = 0; i < (i64)v.size(); ++i) {
        for (i32 r = 0; r < 2; ++r) {
            i32 dr = (r << 1) | ((v[i].second >> 1) & 1);
            if (pes[dr].failed) continue;
            i32 which = (r << 1) | ((v[i].second & 1) ^ 1);
            if (y[which] < 0) continue;
            for (i64 k = y[which]; k >= 0; --k) {
                if ((i32)(v[k].second & 3) != which) continue;
                i64 dist = (i64)(v[i].first - v[k].first);
                if (dist > pes[dr].high) break;
                if (dist < pes[dr].low) continue;
                double ns = (dist - pes[dr].avg) / pes[dr].std;
                i64 q = (i64)((double)(v[i].second >> 32)
                              + (double)(v[k].second >> 32)
                              + 0.721 * std::log(2.0 * std::erfc(
                                    std::fabs(ns) * M_SQRT1_2_C))
                                * opt.a + 0.499);
                if (q < 0) q = 0;
                u64 uy = ((u64)k << 32) | (u64)i;
                u64 ux = ((u64)q << 32)
                    | (hash_64(uy ^ ((u64)read_id << 8)) & 0xFFFFFFFFull);
                u.push_back({ux, uy});
            }
        }
        y[v[i].second & 3] = i;
    }
    if (u.empty()) {
        *o_out = *subo_out = *n_sub_out = 0;
        z[0] = z[1] = -1;
        return;
    }
    i32 tmp = std::max({opt.a + opt.b, opt.o_del + opt.e_del,
                        opt.o_ins + opt.e_ins});
    std::sort(u.begin(), u.end());
    i64 i = (i64)(u.back().second >> 32);
    i64 k = (i64)(u.back().second & 0xFFFFFFFFull);
    z[0] = z[1] = -1;
    z[v[i].second & 1] = (i64)((v[i].second & 0xFFFFFFFFull) >> 2);
    z[v[k].second & 1] = (i64)((v[k].second & 0xFFFFFFFFull) >> 2);
    *o_out = (i32)(u.back().first >> 32);
    i32 sub = u.size() > 1 ? (i32)(u[u.size() - 2].first >> 32) : 0;
    i32 n_sub = 0;
    for (i64 i2 = (i64)u.size() - 2; i2 >= 0; --i2)
        if (sub - (i32)(u[i2].first >> 32) <= tmp) ++n_sub;
    *subo_out = sub;
    *n_sub_out = n_sub;
}

static i32 raw_mapq(i32 diff, i32 a) {
    return (i32)(6.02 * diff / a + 0.499);
}

// mem_sam_pe for one pair (pairing.py:342-471)
static void sam_pe_one(const BnsC &bns, const MemOptC &opt,
                       const PEStatC *pes, i64 pair_id,
                       const ReadView rd[2], const u8 *enc[2],
                       const i32 l_enc[2], std::vector<AlnReg> a[2],
                       const RescueMap &rescue, i64 pair_idx,
                       const char *rg_id, i64 l_rg, std::string out[2]) {
    i32 extra_flag = 1;
    if (!(opt.flag & MEM_F_NO_RESCUE)) {
        // anchors snapshotted for BOTH ends before rescue mutates either
        std::vector<AlnReg> b[2];
        for (i32 i = 0; i < 2; ++i)
            if (!a[i].empty())
                for (const AlnReg &reg : a[i])
                    if (reg.score >= a[i][0].score - opt.pen_unpaired)
                        b[i].push_back(reg);
        for (i32 i = 0; i < 2; ++i)
            for (i64 j = 0; j < (i64)b[i].size(); ++j) {
                if (j >= opt.max_matesw) break;
                matesw(bns, opt, pes, b[i][j], l_enc[!i], enc[!i], a[!i],
                       rescue, pair_idx, i, (i32)j);
            }
    }
    i64 n_pri[2];
    for (i32 i = 0; i < 2; ++i)
        n_pri[i] = mark_primary(opt, a[i], (pair_id << 1) | i);
    if (opt.flag & MEM_F_PRIMARY5) {
        reorder_primary5(opt.T, a[0]);
        reorder_primary5(opt.T, a[1]);
    }

    if (!(opt.flag & MEM_F_NOPAIRING) && n_pri[0] && n_pri[1]) {
        i32 o, subo, n_sub;
        i64 z[2];
        mem_pair(bns, opt, pes, a, pair_id, n_pri, &o, &subo, &n_sub, z);
        if (o > 0) {
            bool is_multi[2] = {false, false};
            for (i32 i = 0; i < 2; ++i)
                for (i64 j = 1; j < n_pri[i]; ++j)
                    if (a[i][j].secondary < 0 && a[i][j].score >= opt.T) {
                        is_multi[i] = true;
                        break;
                    }
            if (!is_multi[0] && !is_multi[1]) {
                i32 score_un = a[0][0].score + a[1][0].score
                    - opt.pen_unpaired;
                subo = std::max(subo, score_un);
                i32 q_pe = raw_mapq(o - subo, opt.a);
                if (n_sub > 0)
                    q_pe -= (i32)(4.343 * std::log(n_sub + 1.0) + 0.499);
                q_pe = std::min(std::max(q_pe, 0), 60);
                q_pe = (i32)(q_pe * (1.0 - 0.5 * (a[0][0].frac_rep
                                                  + a[1][0].frac_rep))
                             + 0.499);
                i32 q_se[2];
                if (o > score_un) {   // paired alignment preferred
                    AlnReg *c[2] = {&a[0][z[0]], &a[1][z[1]]};
                    for (i32 i = 0; i < 2; ++i) {
                        if (c[i]->secondary >= 0) {
                            c[i]->sub = a[i][c[i]->secondary].score;
                            c[i]->secondary = -2;
                        }
                        q_se[i] = approx_mapq(opt, *c[i]);
                    }
                    for (i32 i = 0; i < 2; ++i) {
                        q_se[i] = q_se[i] > q_pe
                            ? q_se[i] : std::min(q_pe, q_se[i] + 40);
                        i32 cap = raw_mapq(c[i]->score - c[i]->csub, opt.a);
                        q_se[i] = std::min(q_se[i], cap);
                    }
                    extra_flag |= 2;
                } else {
                    z[0] = z[1] = 0;
                    q_se[0] = approx_mapq(opt, a[0][0]);
                    q_se[1] = approx_mapq(opt, a[1][0]);
                }
                // swap secondary and primary if both non-ALT
                for (i32 i = 0; i < 2; ++i) {
                    i32 k = a[i][z[i]].secondary_all;
                    if (0 <= k && k < n_pri[i]) {
                        for (i64 j = 0; j < (i64)a[i].size(); ++j)
                            if (a[i][j].secondary_all == k || j == k)
                                a[i][j].secondary_all = (i32)z[i];
                        a[i][z[i]].secondary_all = -1;
                    }
                }
                std::vector<std::string> XA[2];
                std::vector<bool> hasXA[2];
                if (!(opt.flag & MEM_F_ALL))
                    for (i32 i = 0; i < 2; ++i)
                        gen_alt(bns, opt, a[i], l_enc[i], enc[i], XA[i],
                                hasXA[i]);
                std::vector<Aln> aa[2];
                for (i32 i = 0; i < 2; ++i) {
                    aa[i].emplace_back();
                    reg2aln(bns, opt, l_enc[i], enc[i], &a[i][z[i]],
                            aa[i][0]);
                    aa[i][0].mapq = q_se[i];
                    aa[i][0].flag |= (0x40 << i) | extra_flag;
                    if (!XA[i].empty() && hasXA[i][z[i]]) {
                        aa[i][0].XA = XA[i][z[i]];
                        aa[i][0].has_XA = true;
                    }
                    if (n_pri[i] < (i64)a[i].size()) {
                        const AlnReg &p = a[i][n_pri[i]];
                        if (p.score >= opt.T && p.secondary < 0
                                && p.is_alt) {
                            aa[i].emplace_back();
                            reg2aln(bns, opt, l_enc[i], enc[i], &p,
                                    aa[i][1]);
                            aa[i][1].flag |= 0x800 | (0x40 << i)
                                | extra_flag;
                            if (!XA[i].empty() && hasXA[i][n_pri[i]]) {
                                aa[i][1].XA = XA[i][n_pri[i]];
                                aa[i][1].has_XA = true;
                            }
                        }
                    }
                }
                for (i32 i = 0; i < (i32)aa[0].size(); ++i)
                    aln2sam(bns, opt, rd[0], (i32)aa[0].size(), aa[0], i,
                            &aa[1][0], rg_id, l_rg, out[0]);
                for (i32 i = 0; i < (i32)aa[1].size(); ++i)
                    aln2sam(bns, opt, rd[1], (i32)aa[1].size(), aa[1], i,
                            &aa[0][0], rg_id, l_rg, out[1]);
                return;
            }
        }
    }

    // no_pairing path
    Aln h[2];
    for (i32 i = 0; i < 2; ++i) {
        i64 which = -1;
        if (!a[i].empty()) {
            if (a[i][0].score >= opt.T) which = 0;
            else if (n_pri[i] < (i64)a[i].size()
                     && a[i][n_pri[i]].score >= opt.T)
                which = n_pri[i];
        }
        reg2aln(bns, opt, l_enc[i], enc[i],
                which >= 0 ? &a[i][which] : nullptr, h[i]);
    }
    if (!(opt.flag & MEM_F_NOPAIRING) && h[0].rid == h[1].rid
            && h[0].rid >= 0 && !a[0].empty() && !a[1].empty()) {
        i64 dist;
        i32 d = infer_dir(bns.l_pac, a[0][0].rb, a[1][0].rb, &dist);
        if (!pes[d].failed && pes[d].low <= dist && dist <= pes[d].high)
            extra_flag |= 2;
    }
    reg2sam(bns, opt, rd[0], enc[0], l_enc[0], a[0], 0x41 | extra_flag,
            &h[1], rg_id, l_rg, out[0]);
    reg2sam(bns, opt, rd[1], enc[1], l_enc[1], a[1], 0x81 | extra_flag,
            &h[0], rg_id, l_rg, out[1]);
}

} // namespace

// ---------------------------------------------------------------------------
// exported entry points
// ---------------------------------------------------------------------------

extern "C" {

// get_sa_entry_compressed over a batch (FMI_search.cpp:1103-1175): the
// host-side SA resolution used by the fused-seeding patch path
// (ops/backend._patch_chunk) so rare capacity-overflow repairs never cost
// a device round trip.  Matches ops/salookup.py exactly, including the
// sentinel-walk case and the int8 sign-extension of the ms byte.
void rt_sa_entries(const FmiC *f, const int8_t *sa_ms,
                   const uint32_t *sa_ls,
                   const i64 *pos, i64 n, i64 *out) {
    for (i64 i = 0; i < n; ++i) {
        i64 sp = pos[i], off = 0;
        bool sent = false;
        while (sp & 7) {
            i64 blk = sp >> 6;
            u64 bit = 1ull << (63 - (sp & 63));
            i32 b = 4;
            for (i32 c = 0; c < 4; ++c)
                if (f->one_hot[blk * 4 + c] & bit) { b = c; break; }
            if (b == 4) { sent = true; break; }   // sentinel slot
            sp = f->counts[b] + fmi_occ(*f, sp, b);
            ++off;
        }
        out[i] = sent ? off
                      : ((((i64)sa_ms[sp >> 3]) << 32)
                         + (i64)sa_ls[sp >> 3]) + off;
    }
}

// Batched mem_sort_dedup_patch + ALT marking over a chunk (the tail of
// worker_aln, bwamem.cpp:1141-1169).  Rewrites the reg arrays and offsets
// in place (region count can only shrink).  Input regions must already have
// qe > qb (caller filters sentinels).
void rt_dedup_patch_batch(const BnsC *bns, const MemOptC *opt,
                          const ReadsC *reads, RegsC *R) {
    std::vector<AlnReg> regs;
    std::vector<u8> enc;
    i64 w = 0;
    for (i64 i = 0; i < reads->n; ++i) {
        load_regs(*R, i, regs);   // reads old off[i]..off[i+1]
        i64 nseq = reads->seq_off[i + 1] - reads->seq_off[i];
        encode_read(reads->seq_blob + reads->seq_off[i], nseq, enc);
        sort_dedup_patch(*bns, *opt, enc.data(), regs);
        for (auto &r : regs)
            if (r.rid >= 0 && bns->ann_alt[r.rid]) r.is_alt = 1;
        // compaction only shifts left (w <= old off[i]), so the write never
        // clobbers read i+1's still-unread input slots
        store_regs(*R, w, regs);
        R->off[i] = w;            // new start; old off[i] no longer needed
        w += (i64)regs.size();
    }
    R->off[reads->n] = w;
}

// Batched SE finalization: mem_mark_primary_se + mem_reg2sam for every read
// of a chunk (worker_sam SE path, bwamem.cpp:1323-1334).  Returns one
// malloc'd SAM text blob (caller frees with rt_free); per_len[i] is read
// i's SAM byte length (records are concatenated in read order).
char *rt_finalize_se_batch(const BnsC *bns, const MemOptC *opt,
                           const ReadsC *reads, RegsC *R, i64 n_processed,
                           const char *rg_id, i64 l_rg, i64 *per_len,
                           i64 *out_len) {
    std::string out;
    out.reserve((size_t)reads->n * 256);
    std::vector<AlnReg> regs;
    std::vector<u8> enc;
    for (i64 i = 0; i < reads->n; ++i) {
        size_t pos0 = out.size();
        load_regs(*R, i, regs);
        mark_primary(*opt, regs, n_processed + i);
        if (opt->flag & MEM_F_PRIMARY5) reorder_primary5(opt->T, regs);
        i64 nseq = reads->seq_off[i + 1] - reads->seq_off[i];
        encode_read(reads->seq_blob + reads->seq_off[i], nseq, enc);
        ReadView rd;
        rd.name = reads->name_blob + reads->name_off[i];
        rd.l_name = reads->name_off[i + 1] - reads->name_off[i];
        rd.seq = reads->seq_blob + reads->seq_off[i];
        rd.l_seq = nseq;
        rd.qual = reads->qual_blob + reads->qual_off[i];
        rd.l_qual = reads->qual_off[i + 1] - reads->qual_off[i];
        rd.comment = reads->comment_blob + reads->comment_off[i];
        rd.l_comment = reads->comment_off[i + 1] - reads->comment_off[i];
        reg2sam(*bns, *opt, rd, enc.data(), (i32)nseq, regs, 0, nullptr,
                rg_id, l_rg, out);
        per_len[i] = (i64)(out.size() - pos0);
    }
    char *buf = (char *)malloc(out.size() + 1);
    memcpy(buf, out.data(), out.size());
    buf[out.size()] = 0;
    *out_len = (i64)out.size();
    return buf;
}

void rt_free(void *p) { free(p); }

// Batched mem_pestat (pairing.py:63-113, bwamem_pair.cpp:81-148) over the
// chunk's flat regions.  out holds 6 doubles per orientation d:
// {failed, low, high, avg, std, n_raw}; the caller prints the [PE] lines
// (for d with n_raw >= 10) and applies nothing else — the
// max-count-ratio failure pass is already applied here.
void rt_pestat_batch(const BnsC *bns, const MemOptC *opt, const RegsC *R,
                     i64 n_reads, double *out) {
    constexpr i32 MIN_DIR_CNT = 10;
    constexpr double MIN_DIR_RATIO = 0.05, OUTLIER = 2.0, MAPPING = 3.0,
                     MAX_STDDEV = 4.0;
    std::vector<i64> isize[4];
    auto cal_sub = [&](i64 s, i64 e) -> i32 {
        // _cal_sub: first hit overlapping the best (pairing.py:52-60)
        for (i64 j = s + 1; j < e; ++j) {
            i32 b_max = std::max(R->qb[j], R->qb[s]);
            i32 e_min = std::min(R->qe[j], R->qe[s]);
            if (e_min > b_max) {
                i32 min_l = std::min(R->qe[j] - R->qb[j],
                                     R->qe[s] - R->qb[s]);
                if ((float)(e_min - b_max)
                        >= (float)min_l * opt->mask_level)
                    return R->score[j];
            }
        }
        return opt->min_seed_len * opt->a;
    };
    for (i64 p = 0; p < n_reads >> 1; ++p) {
        i64 s0 = R->off[p << 1], e0 = R->off[(p << 1) + 1];
        i64 s1 = e0, e1 = R->off[(p << 1) + 2];
        if (s0 == e0 || s1 == e1) continue;
        if (cal_sub(s0, e0) > MIN_RATIO_PE * R->score[s0]) continue;
        if (cal_sub(s1, e1) > MIN_RATIO_PE * R->score[s1]) continue;
        if (R->rid[s0] != R->rid[s1]) continue;
        i64 dist;
        i32 d = infer_dir(bns->l_pac, R->rb[s0], R->rb[s1], &dist);
        if (dist && dist <= opt->max_ins) isize[d].push_back(dist);
    }
    PEStatC pes[4];
    for (i32 d = 0; d < 4; ++d) {
        double *o = out + d * 6;
        auto &q = isize[d];
        o[5] = (double)q.size();
        if ((i64)q.size() < MIN_DIR_CNT) {
            pes[d].failed = 1;
            o[0] = 1; o[1] = o[2] = o[3] = o[4] = 0;
            continue;
        }
        std::sort(q.begin(), q.end());
        i64 n = (i64)q.size();
        i64 p25 = q[(i64)(0.25 * n + 0.499)];
        i64 p50 = q[(i64)(0.50 * n + 0.499)];
        (void)p50;
        i64 p75 = q[(i64)(0.75 * n + 0.499)];
        i32 low = std::max((i32)(p25 - OUTLIER * (p75 - p25) + 0.499), 1);
        i32 high = (i32)(p75 + OUTLIER * (p75 - p25) + 0.499);
        i64 sum = 0, cnt = 0;
        for (i64 x : q)
            if (low <= x && x <= high) { sum += x; ++cnt; }
        double avg = (double)sum / cnt;
        double var = 0;
        for (i64 x : q)
            if (low <= x && x <= high) var += (x - avg) * (x - avg);
        double std_ = std::sqrt(var / cnt);
        low = (i32)(p25 - MAPPING * (p75 - p25) + 0.499);
        high = (i32)(p75 + MAPPING * (p75 - p25) + 0.499);
        if (low > avg - MAX_STDDEV * std_)
            low = (i32)(avg - MAX_STDDEV * std_ + 0.499);
        if (high < avg + MAX_STDDEV * std_)
            high = (i32)(avg + MAX_STDDEV * std_ + 0.499);
        if (low < 1) low = 1;
        pes[d].failed = 0;
        o[0] = 0; o[1] = low; o[2] = high; o[3] = avg; o[4] = std_;
    }
    i64 mx = 0;
    for (i32 d = 0; d < 4; ++d)
        mx = std::max(mx, (i64)isize[d].size());
    for (i32 d = 0; d < 4; ++d)
        if (pes[d].failed == 0 && (double)isize[d].size()
                < mx * MIN_DIR_RATIO)
            out[d * 6] = 1;
}

// layout of the SMEM batch returned by rt_smems_pivots
struct SmemsOut {
    i64 n;
    i32 *rid, *m, *nn;
    i64 *k, *l, *s;
};

// Full 3-round SMEM collection for whole reads (mem_collect_smem,
// bwamem.cpp:626-803): round-1 pivot chain, round-2 re-seeding of long
// low-occurrence SMEMs, round-3 forward-only seeds, then the per-read
// (m, n) sort.  This is the ultra-long-read path (reads beyond the device
// kernels' int16 coordinate range) and the whole-read fallback.
// Free the result with rt_free.
SmemsOut *rt_collect_smems_reads(const FmiC *fmi, const u8 *enc_blob,
                                 const i64 *enc_off, i64 n_reads,
                                 const i32 *rids, i32 min_seed_len,
                                 i32 split_len, i64 split_width,
                                 i64 max_mem_intv) {
    std::vector<SmemTuple> out;
    for (i64 i = 0; i < n_reads; ++i) {
        const u8 *enc = enc_blob + enc_off[i];
        i64 len = enc_off[i + 1] - enc_off[i];
        i32 rid = rids[i];
        size_t base = out.size();
        // round 1: all positions, min_intv = 1 (smems_all_pos)
        i64 x = 0;
        while (x < len)
            x = smems_one_pos(*fmi, enc, len, rid, x, 1, min_seed_len, out);
        // round 2: re-seed long low-occ SMEMs from their midpoint
        size_t n1 = out.size();
        for (size_t j = base; j < n1; ++j) {
            SmemTuple t = out[j];   // by value: smems_one_pos reallocs out
            if ((i64)(t.n + 1 - t.m) < split_len || t.s > split_width)
                continue;
            smems_one_pos(*fmi, enc, len, rid, (t.n + 1 + t.m) >> 1,
                          t.s + 1, min_seed_len, out);
        }
        // round 3: forward-only seeds capped by max_mem_intv
        // (seed_strategy_all_pos; bwtSeedStrategyAllPosOneThread)
        if (max_mem_intv > 0) {
            i32 msl1 = min_seed_len + 1;
            i64 x3 = 0;
            while (x3 < len) {
                i64 next_x = x3 + 1;
                i32 a = enc[x3];
                if (a < 4) {
                    i64 k = fmi->counts[a];
                    i64 l = fmi->counts[3 - a];
                    i64 s = fmi->counts[a + 1] - fmi->counts[a];
                    i64 m = x3;
                    bool broke = false;
                    for (i64 j = x3 + 1; j < len; ++j) {
                        next_x = j + 1;
                        i32 aj = enc[j];
                        if (aj >= 4) { broke = true; break; }
                        i64 nk, nl, ns;
                        fmi_backward_ext(*fmi, l, k, s, 3 - aj,
                                         &nk, &nl, &ns);
                        std::swap(nk, nl);
                        k = nk; l = nl; s = ns;
                        if (s < max_mem_intv && (j - m + 1) >= msl1) {
                            if (s > 0)
                                out.push_back({rid, (i32)m, (i32)j,
                                               k, l, s});
                            broke = true;
                            break;
                        }
                    }
                    if (!broke) next_x = len;
                }
                x3 = next_x;
            }
        }
        // per-read (m, n) sort (sortSMEMs + mem_intv1 introsort; ties are
        // full-tuple duplicates, so stable order matches the spec)
        std::stable_sort(out.begin() + base, out.end(),
                         [](const SmemTuple &a, const SmemTuple &b) {
            return a.m != b.m ? a.m < b.m : a.n < b.n;
        });
    }
    i64 n = (i64)out.size();
    size_t bytes = sizeof(SmemsOut) + n * (4 * 3 + 8 * 3) + 64;
    char *blk = (char *)malloc(bytes);
    SmemsOut *so = (SmemsOut *)blk;
    char *cur = blk + sizeof(SmemsOut);
    auto take = [&](size_t sz) { char *p = cur; cur += sz; return p; };
    so->n = n;
    so->rid = (i32 *)take(n * 4);
    so->m = (i32 *)take(n * 4);
    so->nn = (i32 *)take(n * 4);
    so->k = (i64 *)take(n * 8);
    so->l = (i64 *)take(n * 8);
    so->s = (i64 *)take(n * 8);
    for (i64 i = 0; i < n; ++i) {
        so->rid[i] = out[i].rid;
        so->m[i] = out[i].m;
        so->nn[i] = out[i].n;
        so->k[i] = out[i].k;
        so->l[i] = out[i].l;
        so->s[i] = out[i].s;
    }
    return so;
}

// Batched smems_one_pos over a pivot list: the exact-oracle fallback for
// pivots whose candidate count overflows the device kernel cap (and for
// any host-side re-enumeration).  enc_blob/enc_off: per-read nt4 codes.
// Free the result with rt_free.
SmemsOut *rt_smems_pivots(const FmiC *fmi, const u8 *enc_blob,
                          const i64 *enc_off, i64 n_pivots,
                          const i32 *prid, const i32 *px,
                          const i64 *min_intv, i32 min_seed_len) {
    std::vector<SmemTuple> out;
    for (i64 i = 0; i < n_pivots; ++i) {
        i32 r = prid[i];
        const u8 *enc = enc_blob + enc_off[r];
        i64 len = enc_off[r + 1] - enc_off[r];
        smems_one_pos(*fmi, enc, len, r, px[i], min_intv[i], min_seed_len,
                      out);
    }
    i64 n = (i64)out.size();
    size_t bytes = sizeof(SmemsOut) + n * (4 * 3 + 8 * 3) + 64;
    char *blk = (char *)malloc(bytes);
    SmemsOut *so = (SmemsOut *)blk;
    char *cur = blk + sizeof(SmemsOut);
    auto take = [&](size_t sz) { char *p = cur; cur += sz; return p; };
    so->n = n;
    so->rid = (i32 *)take(n * 4);
    so->m = (i32 *)take(n * 4);
    so->nn = (i32 *)take(n * 4);
    so->k = (i64 *)take(n * 8);
    so->l = (i64 *)take(n * 8);
    so->s = (i64 *)take(n * 8);
    for (i64 i = 0; i < n; ++i) {
        so->rid[i] = out[i].rid;
        so->m[i] = out[i].m;
        so->nn[i] = out[i].n;
        so->k[i] = out[i].k;
        so->l[i] = out[i].l;
        so->s[i] = out[i].s;
    }
    return so;
}

// layout of the rescue-problem batch returned by rt_rescue_pre_batch
struct RescueOut {
    i64 n;
    i32 *key_p, *key_end, *key_j, *key_r;
    i64 *qoff;
    i32 *qdir;
    u8 *qcomp;
    i32 *qlen;
    i64 *toff;
    i32 *tlen;
    u8 *u8c;
};

// mem_sam_pe_batch_pre / mem_matesw_batch_pre analog (pairing.py:193-266,
// bwamem_pair.cpp:553-602): collect a SUPERSET of the chunk's mate-rescue
// SW problems as device-kernel descriptors.  Free with rt_rescue_out_free.
RescueOut *rt_rescue_pre_batch(const BnsC *bns, const MemOptC *opt,
                               const ReadsC *reads, const RegsC *R,
                               const double *pes6, i64 L) {
    PEStatC pes[4];
    for (i32 d = 0; d < 4; ++d) {
        pes[d].failed = (i32)pes6[d * 6];
        pes[d].low = (i32)pes6[d * 6 + 1];
        pes[d].high = (i32)pes6[d * 6 + 2];
        pes[d].avg = pes6[d * 6 + 3];
        pes[d].std = pes6[d * 6 + 4];
    }
    std::vector<i32> kp, ke, kj, kr, qdir, qlen, tlen;
    std::vector<i64> qoff, toff;
    std::vector<u8> qcomp, u8c;
    bool all_failed = pes[0].failed && pes[1].failed && pes[2].failed
        && pes[3].failed;
    if (!(opt->flag & MEM_F_NO_RESCUE) && !all_failed) {
        std::vector<AlnReg> a[2], b[2];
        for (i64 p = 0; p < reads->n >> 1; ++p) {
            load_regs(*R, p << 1, a[0]);
            load_regs(*R, (p << 1) | 1, a[1]);
            if (a[0].empty() && a[1].empty()) continue;
            for (i32 i = 0; i < 2; ++i) {
                b[i].clear();
                if (!a[i].empty())
                    for (const AlnReg &reg : a[i])
                        if (reg.score >= a[i][0].score - opt->pen_unpaired)
                            b[i].push_back(reg);
            }
            for (i32 i = 0; i < 2; ++i) {
                i64 mate_row = (p << 1) | (i == 0 ? 1 : 0);
                i32 l_ms = (i32)(reads->seq_off[mate_row + 1]
                                 - reads->seq_off[mate_row]);
                for (i64 j = 0; j < (i64)b[i].size(); ++j) {
                    if (j >= opt->max_matesw) break;
                    bool skip[4];
                    for (i32 r = 0; r < 4; ++r)
                        skip[r] = pes[r].failed != 0;
                    for (const AlnReg &reg : a[i == 0 ? 1 : 0]) {
                        i64 dist;
                        i32 r = infer_dir(bns->l_pac, b[i][j].rb, reg.rb,
                                          &dist);
                        if (pes[r].low <= dist && dist <= pes[r].high)
                            skip[r] = true;
                    }
                    for (i32 r = 0; r < 4; ++r) {
                        if (skip[r]) continue;
                        i64 rb, re;
                        bool is_rev;
                        matesw_window(pes, r, b[i][j].rb, l_ms, bns->l_pac,
                                      &rb, &re, &is_rev);
                        if (rb >= re) continue;
                        i32 rid;
                        i64 rlen;
                        fetch_seq(*bns, rb, (rb + re) >> 1, re, &rid, &rb,
                                  &re, &rlen);
                        if (b[i][j].rid != rid
                                || re - rb < opt->min_seed_len)
                            continue;
                        kp.push_back((i32)p);
                        ke.push_back(i);
                        kj.push_back((i32)j);
                        kr.push_back(r);
                        qoff.push_back(mate_row * L
                                       + (is_rev ? l_ms - 1 : 0));
                        qdir.push_back(is_rev ? -1 : 1);
                        qcomp.push_back(is_rev ? 1 : 0);
                        qlen.push_back(l_ms);
                        toff.push_back(rb);
                        tlen.push_back((i32)(re - rb));
                        u8c.push_back((i64)l_ms * opt->a < 250 ? 1 : 0);
                    }
                }
            }
        }
    }
    i64 n = (i64)kp.size();
    size_t bytes = sizeof(RescueOut) + n * (4 * 4 + 8 + 4 + 1 + 4 + 8 + 4
                                            + 1) + 64;
    char *blk = (char *)malloc(bytes);
    RescueOut *ro = (RescueOut *)blk;
    char *cur = blk + sizeof(RescueOut);
    auto take = [&](size_t sz) { char *p = cur; cur += sz; return p; };
    ro->n = n;
    ro->key_p = (i32 *)take(n * 4);
    ro->key_end = (i32 *)take(n * 4);
    ro->key_j = (i32 *)take(n * 4);
    ro->key_r = (i32 *)take(n * 4);
    ro->qoff = (i64 *)take(n * 8);
    ro->qdir = (i32 *)take(n * 4);
    ro->qcomp = (u8 *)take(n);
    ro->qlen = (i32 *)take(n * 4);
    ro->toff = (i64 *)take(n * 8);
    ro->tlen = (i32 *)take(n * 4);
    ro->u8c = (u8 *)take(n);
    if (n) {
        memcpy(ro->key_p, kp.data(), n * 4);
        memcpy(ro->key_end, ke.data(), n * 4);
        memcpy(ro->key_j, kj.data(), n * 4);
        memcpy(ro->key_r, kr.data(), n * 4);
        memcpy(ro->qoff, qoff.data(), n * 8);
        memcpy(ro->qdir, qdir.data(), n * 4);
        memcpy(ro->qcomp, qcomp.data(), n);
        memcpy(ro->qlen, qlen.data(), n * 4);
        memcpy(ro->toff, toff.data(), n * 8);
        memcpy(ro->tlen, tlen.data(), n * 4);
        memcpy(ro->u8c, u8c.data(), n);
    }
    return ro;
}

// Batched mem_sam_pe over the chunk's pairs (worker_sam PE path,
// bwamem.cpp:1256-1268 + mem_sam_pe_batch_post consumption).  `res7` holds
// the device kswv results for the rescue problems keyed by the rt_rescue_
// pre_batch key arrays (n_rescue == 0 -> all rescues run the scalar kernel
// here).  Returns the SAM blob; per_len[i] = read i's byte length;
// *n_host_sw = the rescue SWs run here by the scalar kernel because `res7`
// had no result for them.
char *rt_sam_pe_batch(const BnsC *bns, const MemOptC *opt,
                      const ReadsC *reads, RegsC *R, const double *pes6,
                      i64 n_processed_pairs, i64 n_rescue, const i32 *key_p,
                      const i32 *key_end, const i32 *key_j,
                      const i32 *key_r, const i32 *res7, const char *rg_id,
                      i64 l_rg, i64 *per_len, i64 *out_len,
                      i64 *n_host_sw) {
    PEStatC pes[4];
    for (i32 d = 0; d < 4; ++d) {
        pes[d].failed = (i32)pes6[d * 6];
        pes[d].low = (i32)pes6[d * 6 + 1];
        pes[d].high = (i32)pes6[d * 6 + 2];
        pes[d].avg = pes6[d * 6 + 3];
        pes[d].std = pes6[d * 6 + 4];
    }
    RescueMap rm;
    rm.n = n_rescue;
    rm.key_p = key_p;
    rm.key_end = key_end;
    rm.key_j = key_j;
    rm.key_r = key_r;
    rm.res = res7;
    if (n_rescue) rm.build();
    std::string blob;
    blob.reserve((size_t)reads->n * 256);
    std::vector<AlnReg> a[2];
    std::vector<u8> encbuf[2];
    for (i64 p = 0; p < reads->n >> 1; ++p) {
        ReadView rd[2];
        const u8 *enc[2];
        i32 l_enc[2];
        for (i32 i = 0; i < 2; ++i) {
            i64 row = (p << 1) | i;
            load_regs(*R, row, a[i]);
            rd[i].name = reads->name_blob + reads->name_off[row];
            rd[i].l_name = reads->name_off[row + 1] - reads->name_off[row];
            rd[i].seq = reads->seq_blob + reads->seq_off[row];
            rd[i].l_seq = reads->seq_off[row + 1] - reads->seq_off[row];
            rd[i].qual = reads->qual_blob + reads->qual_off[row];
            rd[i].l_qual = reads->qual_off[row + 1] - reads->qual_off[row];
            rd[i].comment = reads->comment_blob + reads->comment_off[row];
            rd[i].l_comment = reads->comment_off[row + 1]
                - reads->comment_off[row];
            encode_read(rd[i].seq, rd[i].l_seq, encbuf[i]);
            enc[i] = encbuf[i].data();
            l_enc[i] = (i32)rd[i].l_seq;
        }
        if (rd[0].l_name != rd[1].l_name
                || memcmp(rd[0].name, rd[1].name, rd[0].l_name) != 0) {
            *out_len = -1;       // paired reads have different names
            return nullptr;
        }
        std::string out2[2];
        sam_pe_one(*bns, *opt, pes, n_processed_pairs + p, rd, enc, l_enc,
                   a, rm, p, rg_id, l_rg, out2);
        per_len[p << 1] = (i64)out2[0].size();
        per_len[(p << 1) | 1] = (i64)out2[1].size();
        blob += out2[0];
        blob += out2[1];
    }
    char *buf = (char *)malloc(blob.size() + 1);
    memcpy(buf, blob.data(), blob.size());
    buf[blob.size()] = 0;
    *out_len = (i64)blob.size();
    *n_host_sw = rm.host_sw;
    return buf;
}

} // extern "C"

// ---------------------------------------------------------------------------
// Extension stage: mem_chain2aln_across_reads_V2 (align/extend.py spec;
// bwamem.cpp:2069-2994) as a handle-based state machine.  The caller drives
// the band-doubling rounds: rt_ext_pending exposes the in-cap pairs of the
// current round as device-kernel descriptors, the device scores come back
// through rt_ext_apply (over-cap pairs are scored right here with the
// scalar bsw_extend), and rt_ext_finish runs the seed-contained purge and
// writes the surviving regions into the chunk's flat SoA.
// ---------------------------------------------------------------------------

extern "C" int bsw_extend(int qlen, const uint8_t *query, int tlen,
                          const uint8_t *target, int m, const int8_t *mat,
                          int o_del, int e_del, int o_ins, int e_ins, int w,
                          int end_bonus, int zdrop, int h0, int *qle,
                          int *tle, int *gtle, int *gscore, int *max_off);

namespace {

constexpr i32 MAX_BAND_TRY = 2;
constexpr i32 H0_NULL = -99;     // "not yet extended" sentinel (macro.h:44)

struct ExtPair {        // SeqPair analog (bandedSWA.h:90-99)
    i64 qoff, toff;     // descriptor walk starts (absolute; qoff read-local)
    i32 qdir, tdir, qlen, tlen, h0, regid, seqid;
};

struct ExtReg {         // AlnReg under construction
    i64 rb, re;
    i32 qb, qe, rid, score, truesc, w, seedcov, seedlen0;
    i32 chain;          // owning chain (for seedcov + purge)
    float frac_rep;
};

struct ExtState {
    const BnsC *bns;
    const MemOptC *opt;
    const ReadsC *reads;
    // flat chain/seed views (surviving, post-filter order)
    const i64 *chain_off;
    const i32 *chain_rid;
    const u8 *chain_alt;
    const float *chain_frac;
    const i32 *chain_nseeds;
    const i64 *soff;
    const i64 *seed_rbeg;
    const i32 *seed_qbeg;
    const i32 *seed_len;
    i32 qcap, tcap;
    std::vector<ExtReg> regs;
    std::vector<i32> reg_read;        // owning read of each reg
    std::vector<i64> srt;             // per-chain seed order (flat, soff-indexed)
    std::vector<i32> seed_aln;        // seed -> regid
    std::vector<ExtPair> pairs[2];    // 0 = left, 1 = right
    std::vector<i64> pending[2];
    std::vector<i64> pend_dev;        // in-cap subset of current round
    i32 round[2] = {0, 0};
    bool right_ready = false;
    std::vector<u8> encs;             // nt4 codes, reads->seq_off layout
};

static i32 cal_max_gap(const MemOptC &o, i32 qlen) {
    i32 l_del = (i32)((double)(qlen * o.a - o.o_del) / o.e_del + 1.0);
    i32 l_ins = (i32)((double)(qlen * o.a - o.o_ins) / o.e_ins + 1.0);
    i32 l = std::max(std::max(l_del, l_ins), 1);
    return std::min(l, o.w << 1);
}

// seedcov: bases of chain seeds contained in [qb,qe) x [rb,re)
static i32 ext_seedcov(const ExtState &st, i32 ci, const ExtReg &a) {
    i32 cov = 0;
    for (i64 s = st.soff[ci]; s < st.soff[ci + 1]; ++s)
        if (st.seed_qbeg[s] >= a.qb
                && st.seed_qbeg[s] + st.seed_len[s] <= a.qe
                && st.seed_rbeg[s] >= a.rb
                && st.seed_rbeg[s] + st.seed_len[s] <= a.re)
            cov += st.seed_len[s];
    return cov;
}

// score one over-cap pair with the scalar kernel (the reference's scalar
// tail class), materializing the sequences from the read codes / ref
static void ext_host_score(const ExtState &st, const ExtPair &p, i32 w,
                           i32 end_bonus, i32 out[6]) {
    const MemOptC &o = *st.opt;
    std::vector<u8> q((size_t)p.qlen), t((size_t)p.tlen);
    const u8 *enc = st.encs.data() + st.reads->seq_off[p.seqid];
    for (i32 i = 0; i < p.qlen; ++i)
        q[i] = enc[p.qoff + (i64)p.qdir * i];
    for (i32 i = 0; i < p.tlen; ++i)
        t[i] = st.bns->ref[p.toff + (i64)p.tdir * i];
    int qle, tle, gtle, gscore, max_off;
    int sc = bsw_extend(p.qlen, q.data(), p.tlen, t.data(), 5, o.mat,
                        o.o_del, o.e_del, o.o_ins, o.e_ins, w, end_bonus,
                        o.zdrop, p.h0, &qle, &tle, &gtle, &gscore,
                        &max_off);
    out[0] = sc; out[1] = qle; out[2] = tle; out[3] = gtle;
    out[4] = gscore; out[5] = max_off;
}

} // namespace

extern "C" {

// Build the extension state: rmax spans, seed processing order, one AlnReg
// per seed, and the left/right SeqPair descriptor lists
// (bwamem.cpp:2144-2434).
void *rt_ext_begin(const BnsC *bns, const MemOptC *opt, const ReadsC *reads,
                   const i64 *chain_off, const i32 *chain_rid,
                   const u8 *chain_alt, const float *chain_frac,
                   const i32 *chain_nseeds, const i64 *soff,
                   const i64 *seed_rbeg, const i32 *seed_qbeg,
                   const i32 *seed_len, i32 qcap, i32 tcap) {
    ExtState *st = new ExtState();
    st->bns = bns;
    st->opt = opt;
    st->reads = reads;
    st->chain_off = chain_off;
    st->chain_rid = chain_rid;
    st->chain_alt = chain_alt;
    st->chain_frac = chain_frac;
    st->chain_nseeds = chain_nseeds;
    st->soff = soff;
    st->seed_rbeg = seed_rbeg;
    st->seed_qbeg = seed_qbeg;
    st->seed_len = seed_len;
    st->qcap = qcap;
    st->tcap = tcap;
    const MemOptC &o = *opt;
    i64 l_pac = bns->l_pac;
    i64 total_seeds = soff[chain_off[reads->n]];
    st->srt.resize(total_seeds);
    st->seed_aln.assign(total_seeds, -1);
    st->encs.resize((size_t)reads->seq_off[reads->n]);
    for (i64 r = 0; r < reads->n; ++r) {
        std::vector<u8> tmp;
        encode_read(reads->seq_blob + reads->seq_off[r],
                    reads->seq_off[r + 1] - reads->seq_off[r], tmp);
        memcpy(st->encs.data() + reads->seq_off[r], tmp.data(), tmp.size());
    }
    for (i64 r = 0; r < reads->n; ++r) {
        i32 l_query = (i32)(reads->seq_off[r + 1] - reads->seq_off[r]);
        for (i64 ci = chain_off[r]; ci < chain_off[r + 1]; ++ci) {
            i64 s0 = soff[ci];
            i64 ns = chain_nseeds[ci];
            if (ns == 0) continue;
            // rmax span (bwamem.cpp:2144-2177)
            i64 rmax0 = l_pac << 1, rmax1 = 0;
            for (i64 s = s0; s < s0 + ns; ++s) {
                i64 b = seed_rbeg[s]
                    - (seed_qbeg[s] + cal_max_gap(o, seed_qbeg[s]));
                i64 e = seed_rbeg[s] + seed_len[s]
                    + (l_query - seed_qbeg[s] - seed_len[s])
                    + cal_max_gap(o, l_query - seed_qbeg[s] - seed_len[s]);
                rmax0 = std::min(rmax0, b);
                rmax1 = std::max(rmax1, e);
            }
            rmax0 = std::max(rmax0, (i64)0);
            rmax1 = std::min(rmax1, l_pac << 1);
            if (rmax0 < l_pac && l_pac < rmax1) {
                if (seed_rbeg[s0] < l_pac) rmax1 = l_pac;
                else rmax0 = l_pac;
            }
            i32 rid;
            i64 rl;
            fetch_seq(*bns, rmax0, seed_rbeg[s0], rmax1, &rid, &rmax0,
                      &rmax1, &rl);
            // seeds in (score<<32 | idx) ascending; process descending
            i64 *srt = st->srt.data() + s0;
            for (i64 j = 0; j < ns; ++j) srt[j] = j;
            std::sort(srt, srt + ns, [&](i64 x, i64 y) {
                u64 kx = ((u64)(uint32_t)seed_len[s0 + x] << 32) | (u64)x;
                u64 ky = ((u64)(uint32_t)seed_len[s0 + y] << 32) | (u64)y;
                return kx < ky;   // seed score == len here
            });
            for (i64 kk = ns - 1; kk >= 0; --kk) {
                i64 s = s0 + srt[kk];
                ExtReg a;
                a.rb = H0_NULL; a.re = H0_NULL;
                a.qb = H0_NULL; a.qe = H0_NULL;
                a.rid = chain_rid[ci];
                a.score = -1; a.truesc = -1;
                a.w = o.w;
                a.seedcov = 0;
                a.seedlen0 = seed_len[s];
                a.chain = (i32)ci;
                a.frac_rep = chain_frac[ci];
                i32 regid = (i32)st->regs.size();
                st->seed_aln[s] = regid;
                if (seed_qbeg[s]) {       // left extension
                    i64 tmp = seed_rbeg[s] - rmax0;
                    ExtPair p;
                    p.qoff = seed_qbeg[s] - 1;
                    p.qdir = -1;
                    p.qlen = seed_qbeg[s];
                    p.toff = seed_rbeg[s] - 1;
                    p.tdir = -1;
                    p.tlen = (i32)std::max(tmp, (i64)0);
                    p.h0 = seed_len[s] * o.a;
                    p.regid = regid;
                    p.seqid = (i32)r;
                    st->pairs[0].push_back(p);
                    a.qb = seed_qbeg[s];
                    a.rb = seed_rbeg[s];
                } else {
                    a.score = a.truesc = seed_len[s] * o.a;
                    a.qb = 0;
                    a.rb = seed_rbeg[s];
                }
                if (seed_qbeg[s] + seed_len[s] != l_query) {  // right
                    i64 qe = seed_qbeg[s] + seed_len[s];
                    i64 re = seed_rbeg[s] + seed_len[s] - rmax0;
                    ExtPair p;
                    p.qoff = qe;
                    p.qdir = 1;
                    p.qlen = (i32)(l_query - qe);
                    p.toff = seed_rbeg[s] + seed_len[s];
                    p.tdir = 1;
                    p.tlen = (i32)((rmax1 - rmax0) - re);
                    p.h0 = H0_NULL;     // filled from the left result
                    p.regid = regid;
                    p.seqid = (i32)r;
                    st->pairs[1].push_back(p);
                    a.qe = (i32)qe;
                    a.re = rmax0 + re;
                } else {
                    a.qe = l_query;
                    a.re = seed_rbeg[s] + seed_len[s];
                    if (a.rb != H0_NULL && a.qb != H0_NULL) {
                        st->regs.push_back(a);
                        st->reg_read.push_back((i32)r);
                        st->regs.back().seedcov =
                            ext_seedcov(*st, (i32)ci, st->regs.back());
                        continue;
                    }
                }
                st->regs.push_back(a);
                st->reg_read.push_back((i32)r);
            }
        }
    }
    for (i32 side = 0; side < 2; ++side) {
        st->pending[side].resize(st->pairs[side].size());
        for (i64 i = 0; i < (i64)st->pairs[side].size(); ++i)
            st->pending[side][i] = i;
    }
    return st;
}

// In-cap pending pairs of the current round for `side`; fills the
// device-descriptor arrays (caller sized via the return of a first call
// with null pointers).  qoff is read-local; the caller adds the read-grid
// row base.
i64 rt_ext_pending(void *h, i32 side, i64 *qoff, i32 *qdir, i32 *qlen,
                   i64 *toff, i32 *tdir, i32 *tlen, i32 *h0,
                   i32 *seqid) {
    ExtState *st = (ExtState *)h;
    if (side == 1 && !st->right_ready) {
        // right pairs read their alnreg's left score as h0
        // (bwamem.cpp:2641-2658 analog; extend.py:271-272)
        for (ExtPair &p : st->pairs[1])
            p.h0 = st->regs[p.regid].score;
        st->right_ready = true;
    }
    st->pend_dev.clear();
    for (i64 i : st->pending[side]) {
        const ExtPair &p = st->pairs[side][i];
        if (p.qlen <= st->qcap && p.tlen <= st->tcap)
            st->pend_dev.push_back(i);
    }
    if (qoff) {
        for (i64 j = 0; j < (i64)st->pend_dev.size(); ++j) {
            const ExtPair &p = st->pairs[side][st->pend_dev[j]];
            qoff[j] = p.qoff;
            qdir[j] = p.qdir;
            qlen[j] = p.qlen;
            toff[j] = p.toff;
            tdir[j] = p.tdir;
            tlen[j] = p.tlen;
            h0[j] = p.h0;
            seqid[j] = p.seqid;
        }
    }
    return (i64)st->pend_dev.size();
}

// Apply one round: device scores for the in-cap subset (scores6, in
// rt_ext_pending order), scalar scores for the over-cap tail computed
// here; acceptance rule of bwamem.cpp:2472-2526 / 2688-2742.  Returns the
// number of pairs still pending (band-doubled retry).
i64 rt_ext_apply(void *h, i32 side, const i32 *scores6) {
    ExtState *st = (ExtState *)h;
    const MemOptC &o = *st->opt;
    i32 i_round = st->round[side];
    i32 w = o.w << i_round;
    i32 end_bonus = side == 0 ? o.pen_clip5 : o.pen_clip3;
    // index of each device-scored pair in scores6
    std::vector<i64> dev_pos(st->pairs[side].size(), -1);
    for (i64 j = 0; j < (i64)st->pend_dev.size(); ++j)
        dev_pos[st->pend_dev[j]] = j;
    std::vector<i64> nxt;
    for (i64 i : st->pending[side]) {
        const ExtPair &sp = st->pairs[side][i];
        i32 sc[6];
        // scores6 == nullptr: the caller decided this (small) round is
        // cheaper on the host scalar kernel than a device round trip
        if (scores6 && dev_pos[i] >= 0)
            memcpy(sc, scores6 + dev_pos[i] * 6, 24);
        else ext_host_score(*st, sp, w, end_bonus, sc);
        ExtReg &a = st->regs[sp.regid];
        i32 prev = a.score;
        a.score = sc[0];
        i32 max_off = sc[5];
        if (a.score == prev || max_off < (w >> 1) + (w >> 2)
                || i_round + 1 == MAX_BAND_TRY) {
            i32 qle = sc[1], tle = sc[2], gtle = sc[3], gscore = sc[4];
            if (side == 0) {
                if (gscore <= 0 || gscore <= a.score - o.pen_clip5) {
                    a.qb -= qle;
                    a.rb -= tle;
                    a.truesc = a.score;
                } else {
                    a.qb = 0;
                    a.rb -= gtle;
                    a.truesc = gscore;
                }
            } else {
                i32 l_query = (i32)(st->reads->seq_off[sp.seqid + 1]
                                    - st->reads->seq_off[sp.seqid]);
                if (gscore <= 0 || gscore <= a.score - o.pen_clip3) {
                    a.qe += qle;
                    a.re += tle;
                    a.truesc += a.score - sp.h0;
                } else {
                    a.qe = l_query;
                    a.re += gtle;
                    a.truesc += gscore - sp.h0;
                }
            }
            a.w = std::max(a.w, w);
            if (a.rb != H0_NULL && a.qb != H0_NULL && a.qe != H0_NULL
                    && a.re != H0_NULL)
                a.seedcov = ext_seedcov(*st, a.chain, a);
        } else {
            nxt.push_back(i);
        }
    }
    st->pending[side] = nxt;
    st->round[side] = i_round + 1;
    return (i64)nxt.size();
}

i64 rt_ext_nregs(void *h) { return (i64)((ExtState *)h)->regs.size(); }

// Seed-contained purge (bwamem.cpp:2895-2989) + write surviving regions
// (qe > qb) into the chunk SoA.  R arrays must hold rt_ext_nregs entries;
// off is n_reads+1.
void rt_ext_finish(void *h, RegsC *R) {
    ExtState *st = (ExtState *)h;
    const MemOptC &o = *st->opt;
    std::vector<i32> qb(st->regs.size()), qe(st->regs.size());
    for (size_t i = 0; i < st->regs.size(); ++i) {
        qb[i] = st->regs[i].qb;
        qe[i] = st->regs[i].qe;
    }
    // per-read region windows (reg_read is nondecreasing)
    std::vector<i64> read_lo(st->reads->n + 1, 0);
    {
        i64 p2 = 0;
        for (i64 r = 0; r < st->reads->n; ++r) {
            while (p2 < (i64)st->regs.size() && st->reg_read[p2] < r) ++p2;
            read_lo[r] = p2;
            while (p2 < (i64)st->regs.size() && st->reg_read[p2] == r) ++p2;
        }
        read_lo[st->reads->n] = (i64)st->regs.size();
    }
    for (i64 r = 0; r < st->reads->n; ++r) {
        i32 l_query = (i32)(st->reads->seq_off[r + 1]
                            - st->reads->seq_off[r]);
        i64 lim = 0;
        i64 reg_lo = read_lo[r];
        i64 reg_hi = r + 1 < st->reads->n ? read_lo[r + 1]
                                          : (i64)st->regs.size();
        for (i64 ci = st->chain_off[r]; ci < st->chain_off[r + 1]; ++ci) {
            i64 s0 = st->soff[ci];
            i64 ns = st->chain_nseeds[ci];
            if (ns == 0) continue;
            std::vector<i64> srt(st->srt.begin() + s0,
                                 st->srt.begin() + s0 + ns);
            for (i64 kk = ns - 1; kk >= 0; --kk) {
                if (srt[kk] < 0) continue;
                i64 s = s0 + srt[kk];
                i64 v = 0;
                bool contained = false;
                for (i64 pi = reg_lo; pi < reg_hi; ++pi) {
                    if (v >= lim) break;
                    const ExtReg &p = st->regs[pi];
                    // live coordinates: purged entries skip without
                    // advancing v, exactly like the python spec
                    i32 pqb = qb[pi], pqe = qe[pi];
                    if (pqb == -1 && pqe == -1) continue;
                    if (st->seed_rbeg[s] < p.rb
                            || st->seed_rbeg[s] + st->seed_len[s] > p.re
                            || st->seed_qbeg[s] < pqb
                            || st->seed_qbeg[s] + st->seed_len[s] > pqe) {
                        ++v;
                        continue;
                    }
                    if (st->seed_len[s] - st->regs[pi].seedlen0
                            > 0.1 * l_query) {
                        ++v;
                        continue;
                    }
                    i32 qd = st->seed_qbeg[s] - pqb;
                    i32 rd = (i32)(st->seed_rbeg[s] - p.rb);
                    i32 max_gap = cal_max_gap(o, std::min(qd, rd));
                    i32 ww = std::min(max_gap, st->regs[pi].w);
                    if (qd - rd < ww && rd - qd < ww) { contained = true; break; }
                    qd = pqe - (st->seed_qbeg[s] + st->seed_len[s]);
                    rd = (i32)(p.re - (st->seed_rbeg[s] + st->seed_len[s]));
                    max_gap = cal_max_gap(o, std::min(qd, rd));
                    ww = std::min(max_gap, st->regs[pi].w);
                    if (qd - rd < ww && rd - qd < ww) { contained = true; break; }
                    ++v;
                }
                if (contained || v < lim) {
                    // confirm no overlapping distinct seed would extend
                    // differently (bwamem.cpp:2932-2960)
                    bool ok_skip = true;
                    for (i64 v2 = kk + 1; v2 < ns; ++v2) {
                        if (srt[v2] < 0) continue;
                        i64 t = s0 + srt[v2];
                        if (st->seed_len[t] < st->seed_len[s] * 0.95)
                            continue;
                        if (st->seed_qbeg[s] <= st->seed_qbeg[t]
                                && st->seed_qbeg[s] + st->seed_len[s]
                                   - st->seed_qbeg[t] >= st->seed_len[s] >> 2
                                && st->seed_qbeg[t] - st->seed_qbeg[s]
                                   != st->seed_rbeg[t] - st->seed_rbeg[s]) {
                            ok_skip = false;
                            break;
                        }
                        if (st->seed_qbeg[t] <= st->seed_qbeg[s]
                                && st->seed_qbeg[t] + st->seed_len[t]
                                   - st->seed_qbeg[s] >= st->seed_len[s] >> 2
                                && st->seed_qbeg[s] - st->seed_qbeg[t]
                                   != st->seed_rbeg[s] - st->seed_rbeg[t]) {
                            ok_skip = false;
                            break;
                        }
                    }
                    if (ok_skip) {
                        i32 aln = st->seed_aln[s];
                        qb[aln] = qe[aln] = -1;
                        srt[kk] = -1;
                        continue;
                    }
                }
                ++lim;
            }
        }
    }
    // write survivors (qe > qb), read-major
    i64 w = 0;
    i64 pi = 0;
    for (i64 r = 0; r < st->reads->n; ++r) {
        R->off[r] = w;
        for (; pi < (i64)st->regs.size() && st->reg_read[pi] == r; ++pi) {
            const ExtReg &a = st->regs[pi];
            i32 aqb = qb[pi], aqe = qe[pi];
            if (aqe <= aqb) continue;
            R->rb[w] = a.rb;
            R->re[w] = a.re;
            R->qb[w] = aqb;
            R->qe[w] = aqe;
            R->rid[w] = a.rid;
            R->score[w] = a.score;
            R->truesc[w] = a.truesc;
            R->sub[w] = 0;
            R->alt_sc[w] = 0;
            R->csub[w] = 0;
            R->sub_n[w] = 0;
            R->w[w] = a.w;
            R->seedcov[w] = a.seedcov;
            R->secondary[w] = -1;
            R->secondary_all[w] = -1;
            R->seedlen0[w] = a.seedlen0;
            R->n_comp[w] = 1;
            R->is_alt[w] = 0;
            R->frac_rep[w] = a.frac_rep;
            ++w;
        }
    }
    R->off[st->reads->n] = w;
}

void rt_ext_free(void *h) { delete (ExtState *)h; }

// the caller's round loop must match the forced-accept bound above
i32 rt_ext_max_band_try() { return MAX_BAND_TRY; }

} // extern "C"

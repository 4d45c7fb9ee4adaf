// smem_group.cuh: mem_collect_smem for one read (bwamem.cpp:626-803), run
// by one lane group: the body of the smem_collect CUDA kernel
// (smem_collect.cu), which the tests also compile as host C++.
//
// Semantics: the port's host oracle rt_collect_smems_reads
// (native/runtime.cpp, smems_one_pos), as ops/seed.py:smem_collect_ref
// computes it:
//   round 1  pivots at next_x, min_intv = 1;
//   round 2  the split rule over a snapshot of round 1's output: a seed of
//            length >= split_len and s <= split_width re-seeds from its
//            midpoint with min_intv = s + 1;
//   round 3  forward-only seeds while max_mem_intv > 0
//            (bwtSeedStrategyAllPosOneThread);
//   then a stable per-read sort by (m, n).
// Two route rules decide only where a read is seeded, never what it gets:
// the candidate list holds LCAP entries (a compile-time bucket), and the
// read's output holds `cap` slots (its own, sized from its length by
// ops/seed.py:slot_offsets).  A read that would push past either stops at
// once: its count is -1 and its backward_ext count 0, and the caller
// re-seeds it on the exact host oracle.
//
// The lane group.  G lanes (16 or 32) of a warp seed one read:
//   * a forward walk is a chain of dependent backward_ext steps on one
//     interval; every lane runs it, and each step splits the 8 code words
//     of the two occ rows (k and k+s) over the lanes: one 32-bit word per
//     lane, its four popcounts packed in a byte each, two reductions
//     (smem_occ_pair).  The two rows' checkpoint words are one broadcast
//     load per row;
//   * a backward step extends the candidate list one candidate per lane
//     (lists longer than G run in lane-strided passes).  The two sequential
//     rules of the host loop become group operations: "the first candidate
//     that survives or dies at full length, emitted if it died" is a
//     ballot and a find-first-set; "a survivor is kept when its s differs
//     from the previous survivor's" compares each lane's s with the
//     previous surviving lane's (a ballot and a shuffle; across passes a
//     carried value), and the kept ones are compacted in place by a prefix
//     popcount of the ballot (a kept candidate never moves up the list).
// Every loop exit is decided from values the whole group shares.  The
// interface (SmemGroup) has two implementations: on the card one value per
// thread and the warp intrinsics over the group's lanes; in host C++ the
// lanes as arrays stepped in lockstep (each(f) calls f for every lane),
// where scalar code runs once.
//
// On chip.  The candidate list (n int32, k and s int64; the list never
// needs l) and, for reads of at most SMEM_STAGE slots, the emitted SMEMs
// live in the group's shared memory; the per-read sort (odd-even
// transposition, which is stable) runs there and the slots are written
// once.  A longer read stages in its own output slots and sorts there.
#pragma once

#include "fm_occ.cuh"

#ifdef __CUDACC__
#define SG_D __device__ __forceinline__
#define SG_HD __host__ __device__ __forceinline__
#else
#define SG_D inline
#define SG_HD inline
#endif

#define SMEM_STAGE 64          // output slots staged on chip per group

// Called with an event (0: a backward pass after a step's first, i.e. a
// list longer than G; 1: survivors dropped as equal-s ties) and a count;
// the host tests count them.
#ifndef SMEM_STAT_HOOK
#define SMEM_STAT_HOOK(what, n)
#endif

struct SmemParams {
    int min_seed_len;
    int split_len;
    int64_t split_width;
    int64_t max_mem_intv;
};

// shared-memory bytes of one group: the list, then the staged slots
SG_HD int smem_group_bytes(int lcap) {
    return lcap * (8 + 8 + 4) + SMEM_STAGE * (8 + 8 + 4 + 4);
}

SG_D int sg_popc(unsigned x) {
#ifdef __CUDA_ARCH__
    return __popc(x);
#else
    return __builtin_popcount(x);
#endif
}
SG_D int sg_msb(unsigned x) {   // x != 0
#ifdef __CUDA_ARCH__
    return 31 - __clz(x);
#else
    return 31 - __builtin_clz(x);
#endif
}
SG_D int sg_lsb(unsigned x) {   // x != 0
#ifdef __CUDA_ARCH__
    return __ffs(x) - 1;
#else
    return __builtin_ffs(x) - 1;
#endif
}

#ifdef __CUDACC__

// One value per thread on the card.
template <class T>
struct SmemLane {
    T v;
    SG_D T &operator()(int) { return v; }
    SG_D const T &operator()(int) const { return v; }
};

// The card's group: G consecutive lanes of a warp.
template <int N>
struct SmemGroup {
    static constexpr int G = N;
    template <class T>
    using Lane = SmemLane<T>;
    unsigned mask, shift;
    int l;
    __device__ SmemGroup() {
        const int wl = threadIdx.x & 31;
        l = wl & (G - 1);
        shift = wl & ~(G - 1);
        mask = ((G == 32) ? 0xffffffffu : ((1u << G) - 1u)) << shift;
    }
    SG_D bool leader() const { return l == 0; }
    template <class F>
    SG_D void each(F f) const { f(l); }
    template <class F>
    SG_D unsigned ballot(F f) const {
        return __ballot_sync(mask, f(l)) >> shift;
    }
    SG_D unsigned reduce_add(const Lane<unsigned> &x) const {
        return __reduce_add_sync(mask, x.v);
    }
    template <class T>
    SG_D T bcast(const Lane<T> &x, int src) const {
        return __shfl_sync(mask, x.v, src, G);
    }
    template <class T>
    SG_D Lane<T> gather(const Lane<T> &x, const Lane<int> &src) const {
        return Lane<T>{__shfl_sync(mask, x.v, src.v, G)};
    }
    SG_D void sync() const { __syncwarp(mask); }
    SG_D int fetch_add(int *ctr) const {   // the leader's atomic, broadcast
        int r = 0;
        if (l == 0) r = atomicAdd(ctr, 1);
        return __shfl_sync(mask, r, 0, G);
    }
};

SG_D uint32_t sg_word(const FmView &f, int64_t blk, int i) {
    return (uint32_t)__ldg(f.occp + blk * 8 + i);
}
SG_D void sg_cp(const FmView &f, int64_t blk, uint32_t r[4]) {
    const int4 a = __ldg(reinterpret_cast<const int4 *>(f.occp) + blk * 2);
    r[0] = a.x; r[1] = a.y; r[2] = a.z; r[3] = a.w;
}

#else

// G values, one per lane, on the host.
template <class T, int G>
struct SmemLanes {
    T v[G] = {};
    T &operator()(int l) { return v[l]; }
    const T &operator()(int l) const { return v[l]; }
};

// The host's group: the G lanes stepped in lockstep.
template <int N>
struct SmemGroup {
    static constexpr int G = N;
    template <class T>
    using Lane = SmemLanes<T, G>;
    bool leader() const { return true; }
    template <class F>
    void each(F f) const {
        for (int l = 0; l < G; ++l) f(l);
    }
    template <class F>
    unsigned ballot(F f) const {
        unsigned b = 0;
        for (int l = 0; l < G; ++l)
            if (f(l)) b |= 1u << l;
        return b;
    }
    unsigned reduce_add(const Lane<unsigned> &x) const {
        unsigned r = 0;
        for (int l = 0; l < G; ++l) r += x(l);
        return r;
    }
    template <class T>
    T bcast(const Lane<T> &x, int src) const { return x(src); }
    template <class T>
    Lane<T> gather(const Lane<T> &x, const Lane<int> &src) const {
        Lane<T> r;
        for (int l = 0; l < G; ++l) r(l) = x(src(l));
        return r;
    }
    void sync() const {}
};

inline uint32_t sg_word(const FmView &f, int64_t blk, int i) {
    return (uint32_t)f.occp[blk * 8 + i];
}
inline void sg_cp(const FmView &f, int64_t blk, uint32_t r[4]) {
    for (int i = 0; i < 4; ++i) r[i] = (uint32_t)f.occp[blk * 8 + i];
}

#endif

template <class Gr, class T>
using SgLane = typename Gr::template Lane<T>;

// occ(pos, c) for all four chars from the row's checkpoint words and the
// packed per-char counts of its first (pos & 63) chars (byte c = char c)
SG_D void sg_occ_finish(const FmView &f, int64_t pos, unsigned packed,
                        int64_t out[4]) {
    const int64_t blk = pos >> 6;
    uint32_t r[4];
    sg_cp(f, blk, r);
    const uint32_t hi = f.has_hi ? fm_hi(f, blk) : 0u;
    for (int c = 0; c < 4; ++c)
        out[c] = fm_cp(f, r, hi, c) + (int64_t)((packed >> (8 * c)) & 0xFFu);
    out[0] -= fm_sent_in(f, pos, (int)(pos & 63));
}

// occ(p0, .) and occ(p1, .) with the 8 code words of the two rows split
// over the lanes (word w = row * 4 + i, lane w % G); every lane gets both.
template <class Gr>
SG_D void smem_occ_pair(const Gr &g, const FmView &f, int64_t p0,
                        int64_t p1, int64_t o0[4], int64_t o1[4]) {
    SgLane<Gr, unsigned> c0, c1;
    g.each([&](int l) {
        unsigned a0 = 0, a1 = 0;
        for (int w = l; w < 8; w += Gr::G) {
            const int64_t pos = w < 4 ? p0 : p1;
            const uint32_t x = sg_word(f, pos >> 6, 4 + (w & 3));
            const uint32_t pm = fm_prefix_mask((int)(pos & 63), w & 3);
            const uint32_t lo = x & 0x55555555u;
            const uint32_t hb = (x >> 1) & 0x55555555u;
            const uint32_t nlo = lo ^ 0x55555555u, nhb = hb ^ 0x55555555u;
            const unsigned pk = (unsigned)fm_popc(nlo & nhb & pm)
                                | (unsigned)fm_popc(lo & nhb & pm) << 8
                                | (unsigned)fm_popc(nlo & hb & pm) << 16
                                | (unsigned)fm_popc(lo & hb & pm) << 24;
            if (w < 4) a0 += pk; else a1 += pk;
        }
        c0(l) = a0;
        c1(l) = a1;
    });
    sg_occ_finish(f, p0, g.reduce_add(c0), o0);
    sg_occ_finish(f, p1, g.reduce_add(c1), o1);
}

// backwardExt of one interval by the whole group (group-uniform result)
template <class Gr>
SG_D void smem_ext_group(const Gr &g, const FmView &f, int64_t k, int64_t l,
                         int64_t s, int a, int64_t *ko, int64_t *lo,
                         int64_t *so) {
    int64_t sp[4], ep[4];
    smem_occ_pair(g, f, k, k + s, sp, ep);
    fm_ext_combine(f, k, l, s, a, sp, ep, ko, lo, so);
}

// One read's state: its codes, the group's list and the staged slots.
template <class Gr>
struct SmemRead {
    const Gr &g;
    const FmView &f;
    const int8_t *enc;
    int len;
    SmemParams p;
    int lcap;               // list entries
    int64_t *lk, *ls;       // the candidate list
    int32_t *ln;
    int32_t *om, *on;       // the staged slots (on chip or the read's own)
    int64_t *ok, *os;
    int cap;                // the read's slots
    int cnt;
    int64_t nbwd;           // backward_ext calls
};

template <class Gr>
SG_D bool smem_emit(SmemRead<Gr> &R, int m, int n, int64_t k, int64_t s) {
    if (R.cnt >= R.cap) return false;
    if (R.g.leader()) {
        R.om[R.cnt] = m;
        R.on[R.cnt] = n;
        R.ok[R.cnt] = k;
        R.os[R.cnt] = s;
    }
    ++R.cnt;
    return true;
}

// forward candidate i goes to list slot lcap-1-i: read from lcap-np up,
// the list is longest match first
template <class Gr>
SG_D bool smem_push(SmemRead<Gr> &R, int i, int n, int64_t k, int64_t s) {
    if (i >= R.lcap) return false;
    if (R.g.leader()) {
        const int at = R.lcap - 1 - i;
        R.ln[at] = n;
        R.lk[at] = k;
        R.ls[at] = s;
    }
    return true;
}

// One backward step at column j (char aj) over the np candidates at
// list[base...]: emits the first candidate that dies at full length before
// any survives, keeps the distinct survivors at list[0...].  Returns the
// number kept, or -1 when the emission outran the read's slots.
template <class Gr>
SG_D int smem_bwd_step(SmemRead<Gr> &R, int base, int np, int m, int aj,
                       int64_t mi) {
    const Gr &g = R.g;
    constexpr int G = Gr::G;
    const int msl = R.p.min_seed_len;
    int kept = 0;
    bool found = false;
    int64_t carry = -1;           // the previous pass's last survivor's s
    R.nbwd += np;
    for (int p0 = 0; p0 < np; p0 += G) {
        SMEM_STAT_HOOK(0, p0 > 0);
        SgLane<Gr, int32_t> cn;
        SgLane<Gr, int64_t> ck, cs, nk, ns;
        g.each([&](int l) {
            const int p = p0 + l;
            if (p < np) {
                int64_t nl;
                cn(l) = R.ln[base + p];
                ck(l) = R.lk[base + p];
                cs(l) = R.ls[base + p];
                fm_backward_ext(R.f, ck(l), 0, cs(l), aj, &nk(l), &nl,
                                &ns(l));
            }
        });
        const int nin = np - p0 < G ? np - p0 : G;
        const unsigned in = nin == 32 ? 0xffffffffu : (1u << nin) - 1u;
        const unsigned dies = in & g.ballot([&](int l) {
            return ns(l) < mi;
        });
        const unsigned full = in & g.ballot([&](int l) {
            return cn(l) - m + 1 >= msl;
        });
        const unsigned surv = in & ~dies;
        const unsigned hit = (dies & full) | surv;
        if (!found && hit) {
            found = true;
            const int h = sg_lsb(hit);
            if ((dies >> h) & 1u
                && !smem_emit(R, m, g.bcast(cn, h), g.bcast(ck, h),
                              g.bcast(cs, h)))
                return -1;
        }
        SgLane<Gr, int> src;
        g.each([&](int l) {
            const unsigned below = surv & ((1u << l) - 1u);
            src(l) = below ? sg_msb(below) : l;
        });
        const SgLane<Gr, int64_t> prev = g.gather(ns, src);
        const unsigned keep = surv & g.ballot([&](int l) {
            const unsigned below = surv & ((1u << l) - 1u);
            return ns(l) != (below ? prev(l) : carry);
        });
        SMEM_STAT_HOOK(1, sg_popc(surv & ~keep));
        g.sync();     // every lane has read its entry before any is moved
        g.each([&](int l) {
            if ((keep >> l) & 1u) {
                const int d = kept + sg_popc(keep & ((1u << l) - 1u));
                R.ln[d] = cn(l);
                R.lk[d] = nk(l);
                R.ls[d] = ns(l);
            }
        });
        if (surv) carry = g.bcast(ns, sg_msb(surv));
        kept += sg_popc(keep);
    }
    g.sync();
    return kept;
}

// smems_one_pos: SMEMs through pivot x.  Returns next_x, or -1 when the
// read outran its list or its slots.
template <class Gr>
SG_D int smem_one_pos(SmemRead<Gr> &R, int x, int64_t min_intv) {
    const FmView &f = R.f;
    const int8_t *enc = R.enc;
    const int len = R.len;
    R.g.sync();   // the last call's list is read before this one writes it
    int next_x = x + 1;
    const int a = enc[x];
    if (a >= 4) return next_x;
    int64_t k = fm_count(f, a), l = fm_count(f, 3 - a);
    int64_t s = fm_count(f, a + 1) - k;
    int n = x, np = 0;
    bool broke = false;
    for (int j = x + 1; j < len; ++j) {
        const int aj = enc[j];
        next_x = j + 1;
        if (aj >= 4) { broke = true; break; }
        int64_t nk, nl, ns;
        // forward extension == backward on the RC twin: swap k/l
        smem_ext_group(R.g, f, l, k, s, 3 - aj, &nl, &nk, &ns);
        ++R.nbwd;
        if (ns != s && !smem_push(R, np++, n, k, s)) return -1;
        if (ns < min_intv) { next_x = j; broke = true; break; }
        k = nk; l = nl; s = ns; n = j;
    }
    if (!broke) next_x = len;
    if (s >= min_intv && !smem_push(R, np++, n, k, s)) return -1;
    R.g.sync();
    int base = R.lcap - np, m = x;
    for (int j = x - 1; j >= 0 && np > 0; --j) {
        const int aj = enc[j];
        if (aj >= 4) break;
        np = smem_bwd_step(R, base, np, m, aj, min_intv);
        if (np < 0) return -1;
        base = 0;
        m = j;
    }
    if (np > 0 && R.ln[base] - m + 1 >= R.p.min_seed_len
        && !smem_emit(R, m, R.ln[base], R.lk[base], R.ls[base]))
        return -1;
    return next_x;
}

// The three rounds and the sort for one read, into the staged slots.
// Returns false when the read outran its list or its slots.
template <class Gr>
SG_D bool smem_group_read(SmemRead<Gr> &R) {
    const Gr &g = R.g;
    const FmView &f = R.f;
    const int8_t *enc = R.enc;
    const int len = R.len;
    R.cnt = 0;
    R.nbwd = 0;
    for (int x = 0; x < len;) {                        // round 1
        x = smem_one_pos(R, x, 1);
        if (x < 0) return false;
    }
    g.sync();
    const int n1 = R.cnt;                              // round 2
    for (int i = 0; i < n1; ++i) {
        const int m = R.om[i], n = R.on[i];
        const int64_t s = R.os[i];
        if (n + 1 - m < R.p.split_len || s > R.p.split_width) continue;
        if (smem_one_pos(R, (n + 1 + m) >> 1, s + 1) < 0) return false;
    }
    if (R.p.max_mem_intv > 0) {                        // round 3
        const int msl1 = R.p.min_seed_len + 1;
        for (int x = 0; x < len;) {
            int next_x = x + 1;
            const int a = enc[x];
            if (a < 4) {
                int64_t k = fm_count(f, a), l = fm_count(f, 3 - a);
                int64_t s = fm_count(f, a + 1) - k;
                bool broke = false;
                for (int j = x + 1; j < len; ++j) {
                    next_x = j + 1;
                    const int aj = enc[j];
                    if (aj >= 4) { broke = true; break; }
                    int64_t nk, nl, ns;
                    smem_ext_group(g, f, l, k, s, 3 - aj, &nl, &nk, &ns);
                    ++R.nbwd;
                    k = nk; l = nl; s = ns;
                    if (s < R.p.max_mem_intv && (j - x + 1) >= msl1) {
                        if (s > 0 && !smem_emit(R, x, j, k, s)) return false;
                        broke = true;
                        break;
                    }
                }
                if (!broke) next_x = len;
            }
            x = next_x;
        }
    }
    g.sync();
    // stable sort by (m, n), odd-even transposition: ties are full-tuple
    // duplicates
    const int cnt = R.cnt;
    for (int ph = 0; ph < cnt; ++ph) {
        g.each([&](int l) {
            for (int i = (ph & 1) + 2 * l; i + 1 < cnt; i += 2 * Gr::G) {
                if (R.om[i] > R.om[i + 1]
                    || (R.om[i] == R.om[i + 1] && R.on[i] > R.on[i + 1])) {
                    const int32_t tm = R.om[i], tn = R.on[i];
                    const int64_t tk = R.ok[i], ts = R.os[i];
                    R.om[i] = R.om[i + 1]; R.on[i] = R.on[i + 1];
                    R.ok[i] = R.ok[i + 1]; R.os[i] = R.os[i + 1];
                    R.om[i + 1] = tm; R.on[i + 1] = tn;
                    R.ok[i + 1] = tk; R.os[i + 1] = ts;
                }
            }
        });
        g.sync();
    }
    return true;
}

// One launch's reads: the read grid enc [N][L] with lens, the order the
// groups take them in, the per-read slot offsets (int64[N + 1]) into the
// flat outputs, and the per-read count and backward_ext count.
struct SmemBatch {
    FmView f;
    const int8_t *enc;
    const int *lens;
    const int *order;
    const int64_t *slot_off;
    int N, L;
    SmemParams p;
    int32_t *om, *on;
    int64_t *ok, *os;
    int *ocnt;
    int64_t *onbwd;
};

// Seed read r with group g and its shared bytes `mem` (smem_group_bytes),
// then write its sorted slots, count and backward_ext count.
template <class Gr>
SG_D void smem_group_run(const Gr &g, const SmemBatch &b, int lcap, int r,
                         unsigned char *mem) {
    int len = b.lens[r];
    len = len < 0 ? 0 : (len > b.L ? b.L : len);
    const int64_t o0 = b.slot_off[r];
    const int cap = (int)(b.slot_off[r + 1] - o0);
    int64_t *lk = reinterpret_cast<int64_t *>(mem);
    int64_t *ls = lk + lcap;
    int32_t *ln = reinterpret_cast<int32_t *>(ls + lcap);
    int64_t *sk = reinterpret_cast<int64_t *>(ln + lcap);
    int64_t *ss = sk + SMEM_STAGE;
    int32_t *sm = reinterpret_cast<int32_t *>(ss + SMEM_STAGE);
    int32_t *sn = sm + SMEM_STAGE;
    const bool chip = cap <= SMEM_STAGE;
    SmemRead<Gr> R{g, b.f, b.enc + (int64_t)r * b.L, len, b.p, lcap,
                   lk, ls, ln,
                   chip ? sm : b.om + o0, chip ? sn : b.on + o0,
                   chip ? sk : b.ok + o0, chip ? ss : b.os + o0,
                   cap, 0, 0};
    const bool ok = smem_group_read(R);
    if (ok && chip) {
        g.each([&](int l) {
            for (int i = l; i < R.cnt; i += Gr::G) {
                b.om[o0 + i] = sm[i];
                b.on[o0 + i] = sn[i];
                b.ok[o0 + i] = sk[i];
                b.os[o0 + i] = ss[i];
            }
        });
    }
    if (g.leader()) {
        b.ocnt[r] = ok ? R.cnt : -1;
        b.onbwd[r] = ok ? R.nbwd : 0;
    }
    g.sync();     // the group's shared bytes are free for its next read
}

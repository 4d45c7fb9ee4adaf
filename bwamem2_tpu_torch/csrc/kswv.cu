// kswv: batched two-phase mate-rescue Smith-Waterman on Hopper (sm_90a).
//
// Replaces the TPU device stage bwamem2_tpu/ops/kswv.py:kswv_two_phase
// (:303) and its phase body _kswv_phase (:76), jitted XLA reached through
// DeviceKswv.align_batch.  Plain PyTorch version:
// bwamem2_tpu_torch/ops/kswv.py:kswv_two_phase_ref; wrapper and build:
// bwamem2_tpu_torch/ops/kswv_cuda.py.  A second kernel, kswv_phase,
// replaces bwamem2_tpu/ops/kswv.py:kswv_kernel (:66): one phase per
// problem with the caller's per-problem target direction, stop score and
// live flag (kswv_group.cuh:kswv_run_phase), over the same lane groups,
// register buckets and launch plan; its plain version is ops/kswv.py:
// kswv_phase_ref, its wrapper ops/kswv_cuda.py:KswvPhase, its caller the
// port's tools/kernel_micro.py (the JAX package's only caller of
// kswv_kernel is its tools/kernel_micro.py).  Its bound is the same
// model over the one phase's rows.  At small batches it runs the split
// form below (kswv_split_kernel).
//
// Contract: P rescue problems of one precision class (u8: 16 lanes, biased,
// saturating; i16: 8 lanes) given by descriptors: query codes from the
// chunk's int8[N, L] read grid (qoff = flat row*L+col, qdir = +-1, qcomp:
// complement codes < 4), target codes from the uint8 doubled genome (int64
// toff, tlen bases forward; 2-bit packed when ref_packed).  Output int32[2,
// P, 6]: phase 0 and phase 1 rows of (score, te, qe, score2, te2,
// saturated).  Every problem must have qlen <= Qmax (a multiple of 16) and
// tlen <= Tmax; the kernel clamps to keep a broken descriptor inside its
// stripes and its row array.  There is no length cap: the launch sizes the
// stripes from the batch's longest query.  The i16 class saturates its adds
// at 32767 as the native kernel does (row maxima and shared stripes are
// int16), so any query length and match score fit.  The scores a and b are
// those of the int8 score matrix the native kernel reads (match a,
// mismatch -b, both in -128..127; ops/kswv.py:DeviceKswv takes them from
// MemOptions.mat_scores), so every score the CLI accepts launches.
//
// Design: one lane group per problem, the SIMD lanes of the striped
// register as threads (kswv_group.cuh): a half-warp for u8, a quarter-warp
// for i16.  Lane l owns stripe column l; the striped lane shift is a
// __shfl_up_sync, the lazy-F exit an __all_sync, the row maximum a
// __reduce_max_sync, and the row's target base one load per lane for NL
// rows, broadcast a row at a time.  Both phases run back to back in the
// group, so phase 1's descriptors never leave it.  The stripes never touch
// global memory: with slen <= 16 (every u8 query of up to 256 bases, i16
// ones of up to 128) they are registers, in a kernel instantiated per
// register bucket (u8: 8, 12, 16 segments; i16: 16); longer queries keep
// them in dynamic shared memory, 7 bytes per query column (int16 H, E,
// Hmax; the uint8 profile), with as many groups per block as fit.  Only the
// row maxima (int16 [P][Tpad], one write per row) and the two output rows
// go to global memory.  Groups per block are chosen per launch so that a
// small batch still spreads over every SM (ceil(P / (SMs x 8)), at most 128
// threads); DeviceKswv orders each class's problems by descending (tlen,
// qlen), so that a warp's two u8 groups, and neighbouring warps, run rows of
// similar count.
//
// The split form (kswv_phase only; kswv_group.cuh:kswv_phase_split).  A
// small batch leaves each SM a few warps whose row is a chain of slen
// dependent segment steps (an i16 query of 512 columns: 64 of them a row,
// its stripes in shared memory), with too few lanes to hide it (fewer
// than KSWV_SPLIT_LANES_PER_SEGMENT x slen an SM).  There kswv_plan gives each lane S = 2, 4 or 8
// threads, each holding a run of m = ceil(slen / S) of the lane's
// segments (2 to 16, in registers), so a row becomes about 2m dependent
// steps, a fold of S values and the lazy-F votes; the lanes' columns, and
// so the stripes and the row maximum taken before the lazy-F fixup, are
// unchanged, and so is the output.  A group of more than a warp (u8 S = 4,
// 8; i16 S = 8) is a block and crosses its warps through shared memory,
// a barrier per exchange (three a row and one a lazy-F sweep).  The
// two-phase kswv keeps one thread a lane (its batches fill the card).
//
// What still holds it back: at one thread a lane each lane walks its slen
// segments one after another (a row is slen dependent steps, plus at least
// one lazy-F segment with its vote), the groups of a warp serialise when
// their problems' row counts or lazy-F sweeps differ, and the leader lane
// scans the row maxima alone after each phase; the split form spends a
// second pass over its run, the fold and a min a lazy-F sweep on every
// row, and its barriers where a group spans warps.
//
// What bounds it: integer DP.  The bound counts the least int32 operations
// the recurrence needs per striped cell, not this kernel's instruction mix:
// a precomputed query profile (as the native ksw_align builds, qpad x 5
// entries, negligible beside the cells), H/E/F held in registers, and
// sm_90's DPX instructions where one fuses two operations
// (__viaddmax_s32: max(a + b, c); __vimax3_s32: max(a, b, c)).
//   u8 main-pass cell (10):  1 profile load; 1 add of the diagonal H and
//     the biased score; 1 min with 255 (saturate); 1 fused subtract of the
//     bias with max 0; 1 three-way max of H, E, F; 1 running row max;
//     2 for E' = max(max(E - e_del, 0), H - oe_del) (two fused add-max);
//     2 for F' likewise.
//   i16 main-pass cell (9):  1 profile load; 1 add of diagonal H and score
//     (no bias); 1 min with 32767 (saturate); 1 three-way max; 1 row max;
//     2 for E'; 2 for F'.
//   lazy-F cell, both classes (4):  1 max of H and F; 2 fused add-max
//     (H - oe_ins and F - e_ins, each floored at 0); 1 compare for the
//     sweep's exit vote.  Every row runs at least one segment (NL cells).
// The per-byte SIMD video intrinsics (__vaddus4, __vmaxu4) are not counted
// as one operation for four cells: on sm_90 they compile to several
// instructions.  Cells are qpad = NL * slen per row, over the rows each
// phase runs (both phases), counted from the inputs by kswv_two_phase_ref's
// `work`.  The card's INT32 issue rate is 132 SMs x 64 lanes x 1.98 GHz =
// 16.7 Tops/s, a DPX instruction counted at that rate.  The bytes it must
// move are the descriptors (25 B per problem), the query and target codes
// (qlen + tlen bytes) and 2 x 6 int32 out, at 3.35 TB/s, so operations
// bound it.  chip_smoke.py reports that bound beside the time.

#include <cuda_runtime.h>

#include "kswv_group.cuh"

namespace {

template <bool U8, int SMAX>
__global__ void __launch_bounds__(KSWV_MAX_THREADS)
kswv_kernel(const KswvBatch b) {
    constexpr int NL = U8 ? 16 : 8;
    extern __shared__ __align__(16) unsigned char kswv_smem[];
    const int gpb = blockDim.x / NL, gi = threadIdx.x / NL;
    const int p = blockIdx.x * gpb + gi;
    if (p >= b.P) return;          // the whole group returns
    const KswvGroup<NL> g;
    kswv_run<U8, SMAX>(g, b, p, kswv_smem + gi * kswv_group_bytes(b.Qmax));
}

template <bool U8, int SMAX>
__global__ void __launch_bounds__(KSWV_MAX_THREADS)
kswv_phase_kernel(const KswvBatch b, const KswvPhaseArgs a) {
    constexpr int NL = U8 ? 16 : 8;
    extern __shared__ __align__(16) unsigned char kswv_smem[];
    const int gpb = blockDim.x / NL, gi = threadIdx.x / NL;
    const int p = blockIdx.x * gpb + gi;
    if (p >= b.P) return;          // the whole group returns
    const KswvGroup<NL> g;
    kswv_run_phase<U8, SMAX>(g, b, a, p,
                             kswv_smem + gi * kswv_group_bytes(b.Qmax));
}

// The split form of kswv_phase: a group of NL x S threads per problem
// (kswv_group.cuh:kswv_phase_split), register stripes of SMAX segments a
// sub-thread.  A group of more than a warp is a whole block, and its
// crossings between warps go through `xch`.
template <bool U8, int SMAX, int S>
__global__ void __launch_bounds__(KSWV_MAX_THREADS)
kswv_split_kernel(const KswvBatch b, const KswvPhaseArgs a) {
    constexpr int NL = U8 ? 16 : 8, T = NL * S;
    __shared__ int xch[T > 32 ? 2 * T : 1];
    const int gpb = blockDim.x / T, gi = threadIdx.x / T;
    const int p = blockIdx.x * gpb + gi;
    if (p >= b.P) return;          // the whole group returns
    const KswvGroup<NL, S> g(xch);
    kswv_run_phase<U8, SMAX>(g, b, a, p, nullptr);
}

// Launch `kern` with `smem` bytes of dynamic shared memory (raising the
// kernel's limit past 48 KB first); returns a CUDA error code.
template <class... A, class... B>
int kswv_go(void (*kern)(A...), int blocks, int threads, int smem,
            cudaStream_t st, B... args) {
    if (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (e) return (int)e;
    }
    kern<<<blocks, threads, smem, st>>>(args...);
    return 0;
}

// Target blocks per SM when groups per block are chosen for a small batch.
constexpr int KSWV_BLOCKS_PER_SM = 8;

// The split form's instantiations, X(u8, SMAX, S): S sub-threads a lane,
// up to SMAX = 8 register segments a sub-thread (16 ran slower on an
// H100: 127 registers and a longer chain).
#define KSWV_SPLIT_BUCKETS(X)                                      \
    X(true, 8, 2) X(true, 8, 4) X(true, 8, 8)                      \
    X(false, 8, 2) X(false, 8, 4) X(false, 8, 8)

// A kswv_phase launch takes the split form while its lanes are fewer than
// this many an SM for each segment of a lane (P x NL < SMs x 32 x slen):
// the longer a lane's chain of segments, the more lanes it takes to hide
// it.  On an H100 the split form ran u8 (slen 10) 6-10 % faster at 64 to
// 2,048 problems and 50 % slower at 4,096; i16 (slen 64) 4.3x faster at
// 512, 1.8x at 4,096 and 5 % faster at 32,768.
constexpr int KSWV_SPLIT_LANES_PER_SEGMENT = 32;

}  // namespace

// The launch's shape for P problems of the class with the longest query
// Qmax: plan[0] the register bucket (0: shared-memory stripes), plan[1]
// groups per block, plan[2] dynamic shared memory bytes per block, plan[3]
// S, the sub-threads a lane (1: a lane a thread).  split < 0: the
// two-phase kernel (always S = 1); 0: kswv_phase, S chosen here; > 0:
// kswv_phase at S = split.  The split form is taken when the batch's
// lanes are too few to hide a lane's chain of segments (fewer than
// KSWV_SPLIT_LANES_PER_SEGMENT x slen an SM) and a lane holds more than 8
// segments: the least S in 2, 4, 8 that leaves a sub-thread at most 8
// segments (its stripes in registers); S is allowed when it does.
// Returns a CUDA
// error code (cudaErrorInvalidValue when one group's stripes exceed the
// card's shared memory per block, or for a forced S not allowed).
extern "C" int kswv_plan(int u8, int Qmax, int P, int split, int *plan) {
    int dev = 0, nsm = 0, optin = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (!err)
        err = cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount,
                                     dev);
    if (!err)
        err = cudaDeviceGetAttribute(
            &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err) return (int)err;
    const int nl = u8 ? 16 : 8, slen = Qmax / nl;
    auto allowed = [&](int s) {
        return (s == 2 || s == 4 || s == 8) && (slen + s - 1) / s <= 8;
    };
    int S = 1;
    if (split > 1) {
        if (!allowed(split)) return (int)cudaErrorInvalidValue;
        S = split;
    } else if (split == 0 && slen > 8 &&
               (int64_t)P * nl <
                   (int64_t)nsm * KSWV_SPLIT_LANES_PER_SEGMENT * slen) {
        for (int s = 8; s >= 2; s /= 2)
            if (allowed(s)) S = s;
    }
    const int T = nl * S;
    const int smax = S > 1 ? 8 : kswv_bucket(u8, Qmax);
    const int64_t spread = (int64_t)nsm * KSWV_BLOCKS_PER_SM;
    int gpb = (int)((P + spread - 1) / spread);
    const int gmax = T > 32 ? 1 : KSWV_MAX_THREADS / T;
    gpb = gpb < 1 ? 1 : (gpb > gmax ? gmax : gpb);
    int64_t bytes = 0;
    if (!smax) {
        const int64_t per = kswv_group_bytes(Qmax);
        if (per > optin) return (int)cudaErrorInvalidValue;
        if (gpb > optin / per) gpb = (int)(optin / per);
        bytes = gpb * per;
    }
    plan[0] = smax;
    plan[1] = gpb;
    plan[2] = (int)bytes;
    plan[3] = S;
    return 0;
}

// The launch of a planned batch: both phases (ph null) or one phase.
static int kswv_start(const KswvBatch &batch, const KswvPhaseArgs *ph,
                      int u8, const int plan[4], cudaStream_t st) {
    const int nl = u8 ? 16 : 8, gpb = plan[1], smem = plan[2];
    const int blocks = (batch.P + gpb - 1) / gpb;
    int err = 0;
    if (plan[3] > 1) {
#define KSWV_SPLIT_LAUNCH(U, M, S)                                        \
    if (!!u8 == U && plan[0] == M && plan[3] == S)                        \
        kswv_split_kernel<U, M, S><<<blocks, gpb * nl * S, 0, st>>>(      \
            batch, *ph);
        KSWV_SPLIT_BUCKETS(KSWV_SPLIT_LAUNCH)
#undef KSWV_SPLIT_LAUNCH
        return (int)cudaGetLastError();
    }
#define KSWV_LAUNCH(U, S)                                                  \
    if (!!u8 == U && plan[0] == S)                                         \
        err = ph ? kswv_go(kswv_phase_kernel<U, S>, blocks, gpb * nl,      \
                           smem, st, batch, *ph)                           \
                 : kswv_go(kswv_kernel<U, S>, blocks, gpb * nl, smem, st,  \
                           batch);
    KSWV_BUCKETS(KSWV_LAUNCH)
#undef KSWV_LAUNCH
    return err ? err : (int)cudaGetLastError();
}

// Launch on `stream` (PyTorch's current stream); returns a CUDA error code
// (the plan's, or cudaGetLastError() of the launch) so the wrapper can
// raise on a refused launch.  u8 selects the class.  rowmax: int16[P, Tpad]
// (Tpad a multiple of 8, >= Tmax); out: int32[2, P, 6].
extern "C" int kswv_launch(const int8_t *enc, int64_t n_enc,
                           const uint8_t *ref, int64_t n_ref, int ref_packed,
                           const int *qoff, const int *qdir,
                           const uint8_t *qcomp, const int *qlen,
                           const int64_t *toff, const int *tlen, int P,
                           int Qmax, int Tmax, int Tpad, int u8, int minsc,
                           int a, int b, int o_del, int e_del, int o_ins,
                           int e_ins, int16_t *rowmax, int *out,
                           void *stream) {
    int plan[4];
    const int err = kswv_plan(u8, Qmax, P, -1, plan);
    if (err) return err;
    const KswvBatch batch{enc,   n_enc, ref,   n_ref, ref_packed,
                          qoff,  qdir,  qcomp, qlen,  toff,
                          tlen,  P,     Qmax,  Tmax,  Tpad,
                          minsc, {a, b, o_del, e_del, o_ins, e_ins},
                          rowmax, out};
    return kswv_start(batch, nullptr, u8, plan, (cudaStream_t)stream);
}

// One phase (kswv_phase): as kswv_launch, plus per problem tdir (+-1),
// endsc (the stop score; KSWV_NO_LIMIT: none) and live (uint8: run it),
// and split (kswv_plan's: 0 lets the plan choose S); rowmax int16[P,
// Tpad], out int32[P, 6].
extern "C" int kswv_phase_launch(
    const int8_t *enc, int64_t n_enc, const uint8_t *ref, int64_t n_ref,
    int ref_packed, const int *qoff, const int *qdir, const uint8_t *qcomp,
    const int *qlen, const int64_t *toff, const int *tdir, const int *tlen,
    const int *endsc, const uint8_t *live, int P, int Qmax, int Tmax,
    int Tpad, int u8, int minsc, int a, int b, int o_del, int e_del,
    int o_ins, int e_ins, int split, int16_t *rowmax, int *out,
    void *stream) {
    if (split < 0) return (int)cudaErrorInvalidValue;
    int plan[4];
    const int err = kswv_plan(u8, Qmax, P, split, plan);
    if (err) return err;
    const KswvBatch batch{enc,   n_enc, ref,   n_ref, ref_packed,
                          qoff,  qdir,  qcomp, qlen,  toff,
                          tlen,  P,     Qmax,  Tmax,  Tpad,
                          minsc, {a, b, o_del, e_del, o_ins, e_ins},
                          rowmax, out};
    const KswvPhaseArgs ph{tdir, endsc, live};
    return kswv_start(batch, &ph, u8, plan, (cudaStream_t)stream);
}

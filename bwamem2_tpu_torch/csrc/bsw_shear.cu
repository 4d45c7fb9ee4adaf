// bsw_shear: sheared-band Smith-Waterman extension of long pairs on Hopper
// (sm_90a).
//
// Replaces the XLA device stage bwamem2_tpu/ops/bsw.py:bsw_shear_desc_kernel
// (:572, body _bsw_shear_dp :370), the long class of the JAX package's
// DeviceBSW._run.  Plain PyTorch version: bwamem2_tpu_torch/ops/bsw.py:
// bsw_shear_desc_ref; wrapper and build: bwamem2_tpu_torch/ops/
// bsw_shear_cuda.py.
//
// Contract: P extension problems given by descriptors, as bsw_extend.cu
// takes them (query codes from the chunk's int8[N, L] read grid, qoff =
// flat row*L+col, qdir = +-1; target codes from the uint8 doubled genome,
// int64 toff, tdir = +-1, 2-bit packed when ref_packed), with any qlen up
// to the grid's width and any tlen; every pair's w at most the launch's
// band radius Wh.  Each pair runs min(tlen, Tmax) rows at most.  Output
// int32[P, 6]: score qle tle gtle gscore max_off, what bsw_extend gives for
// the same pair.
//
// Design (shear_group.cuh has the bodies).  A call's pairs go to at most
// two launches, one of each body, each pair with its own row count: the
// caller orders them (ops/bsw.py:DeviceBSW.long_order) with the pairs
// whose every value fits 16 bits first (ops/bsw_shear_cuda.py:
// BswShear.fits16, the one test), each part by descending row count.
//   * pairs [0, n16) run bsw_shear_s16_kernel<R>: two 16-bit slots per
//     register, the DPX 16x2 forms (two cells an instruction);
//   * pairs [n16, P) run bsw_shear_kernel<C>: C int32 slots per lane.
// When both bodies have pairs, the wrapper puts the int32 launch on a
// second stream joined to the caller's by events, so the two run at once;
// the count n16 may live on the card (ShearBatch::n16: bsw_shear_tiles
// computes it and the order there, and never waits), each launch then
// sized for every pair.
// One warp per pair, SHEAR_WPB warps a block, a block for every
// SHEAR_WPB pairs in order: the block scheduler starts the next block
// (the next longest pairs) on an SM as soon as one of its blocks ends, so
// no SM idles behind another's tail and a launch holds a call's pairs at
// once.  (A persistent grid whose warps took the pairs from a ticket
// counter ran run (d)'s calls ~12 % slower on an H100.)  The two bodies
// are separate kernels, so that each is built for its own registers.  C
// and R come from Wh (SHEAR_BUCKETS: at the default w = 100 C 7, R 4; on
// the band-doubling retry at 200 C 13, R 7).  A wider band (Wh > 206)
// runs bsw_shear_wide_kernel: the int32 body with its frame in shared
// memory (one warp per block, 640 B per slot per lane, Wh up to 5806); a
// launch beyond that is refused.  A pair stops on a zero row maximum, on
// z-drop, or after its last row (by row qlen + w its band is empty).
//
// The split-band form (bsw_shear_blk_kernel<K, C>, body shear_group.cuh:
// shear_pair_blk).  A call of fewer pairs than the card has SMs leaves
// SMs idle, and lasts as long as its longest pair's chain of rows.  There
// bsw_shear_plan gives each pair a block of K = 2 warps, one launch for
// pairs of both kinds (int32 slots): a warp runs 32 C of the frame's
// slots a row (C = 4 or 7 against the one-warp body's 7 or 13), and the F
// scan and the row's reductions cross warps through shared memory, two
// barriers a row.  Its rows are the one-warp body's, value for value.
//
// What bounds it: the same integer DP as bsw_extend.cu, counted the same
// way: 10 int32 operations per band cell (bsw_extend.cu's header) over the
// cells the band covers (bsw_shear_desc_ref's `cells`), at the card's
// INT32 issue rate, against the bytes moved (descriptors, qlen + tlen code
// bytes, the output).  chip_smoke.py reports that bound beside the
// measured time.  The 16-bit body spends more than 5 instructions per cell
// (two cells per DPX instruction), so the 10-operation model stays the
// lower bound of both bodies.  What the design spends beyond it: every
// lane runs all of its slots each row (the band is 2w+1 of F slots), the
// frame shift, the F scan and the reductions each row; and a pair's rows
// run one after another, so a launch of few pairs lasts as long as its
// longest pair's rows, each a row's fixed work plus its slots (the split
// form cuts the slots a warp runs, not the fixed work, and adds two
// barriers).
//
// SASS instructions per frame slot (tools/shear_sass.py: the slope of a
// body's row-loop instruction count between two slot counts, cuobjdump
// -sass of the sm_90a build, rarely taken blocks included): before this
// design (one int32 kernel, a launch per row rung) 30.17 (C 7 -> 13);
// now the int32 body 30.5 (C 7 -> 13; in bsw_shear_kernel<C> itself
// 30.17) and the 16-bit body 21.0 (R 4 -> 7, two slots a register).

#include <climits>

#include <cuda_runtime.h>

#include "shear_group.cuh"

#define SHEAR_WPB 4   // warps (pairs) per block of the register kernels

namespace {

// The register buckets: the int32 body, C slots per lane.
template <int C>
__global__ void __launch_bounds__(SHEAR_G * SHEAR_WPB)
bsw_shear_kernel(const ShearBatch b) {
    const int p0 = b.n16 ? *b.n16 : b.p0;
    const int p = p0 + blockIdx.x * SHEAR_WPB + threadIdx.x / SHEAR_G;
    if (p < b.P) shear_pair_i32<C>(BswGroup<SHEAR_G>(), b, p);
}

// The 16-bit body, R registers of two slots per lane.
template <int R>
__global__ void __launch_bounds__(SHEAR_G * SHEAR_WPB)
bsw_shear_s16_kernel(const ShearBatch b) {
    const int P = b.n16 ? *b.n16 : b.P;
    const int p = b.p0 + blockIdx.x * SHEAR_WPB + threadIdx.x / SHEAR_G;
    if (p < P) shear_pair_s16<R>(BswGroup<SHEAR_G>(), b, p);
}

// The split-band form: a block of K warps per pair, C int32 slots a lane.
template <int K, int C>
__global__ void __launch_bounds__(SHEAR_G * K)
bsw_shear_blk_kernel(const ShearBatch b) {
    __shared__ int xch[SHEAR_X_SLOTS * K];
    const int p = b.p0 + blockIdx.x;
    if (p < b.P) shear_pair_blk<C>(ShearBlock<K>(xch), b, p);
}

// The memory frame: b.C slots per lane, one warp per block.
__global__ void __launch_bounds__(SHEAR_G)
bsw_shear_wide_kernel(const ShearBatch b) {
    extern __shared__ int shear_frame[];
    shear_pair_i32<0>(BswGroup<SHEAR_G>(), b, b.p0 + blockIdx.x,
                      shear_frame + threadIdx.x, SHEAR_G);
}

}  // namespace

// A launch of n pairs takes the split-band form, unless forced, when one
// warp a pair would leave SMs without a warp (n below the SM count).

// The launch of `n` pairs at band radius Wh in the 16-bit body (s16) or
// the int32 one: plan[0] C (int32 slots per lane), plan[1] R (16-bit
// registers per lane, 0 for the memory frame and the split form), plan[2]
// blocks, plan[3] threads per block, plan[4] shared-memory bytes per block
// (dynamic: the memory frame's), plan[5] K, warps per pair (1: one warp a
// pair; K = 2: the split-band form, whose one launch takes pairs of both
// kinds).  split 0 lets the plan choose K: the split form when the n pairs
// are fewer than the card's SMs and the band fits a register bucket;
// split 1 or 2 forces K.  Returns a CUDA error code
// (cudaErrorInvalidValue when no frame holds 2*Wh + 3 slots, for the
// 16-bit body beyond the register buckets, or for a forced K without a
// bucket for Wh).
extern "C" int bsw_shear_plan(int Wh, int n, int s16, int split, int *plan) {
    int C = 0;
    const int ct = shear_bucket(Wh, &C);
    if (ct < 0 || n < 0 || (ct == 0 && s16) || split < 0 || split > 2)
        return (int)cudaErrorInvalidValue;
    int K = split;
    if (split == 0) {
        int dev = 0, nsm = 0;
        cudaError_t err = cudaGetDevice(&dev);
        if (!err)
            err = cudaDeviceGetAttribute(
                &nsm, cudaDevAttrMultiProcessorCount, dev);
        if (err) return (int)err;
        K = ct && n < nsm ? 2 : 1;
    }
    if (K > 1) {
        int cb = 0;
#define SHEAR_BLK_PICK(k, c, wh) \
    if (!cb && K == k && Wh <= wh) cb = c;
        SHEAR_BLK_BUCKETS(SHEAR_BLK_PICK)
#undef SHEAR_BLK_PICK
        if (!cb) return (int)cudaErrorInvalidValue;
        plan[0] = cb;
        plan[1] = 0;
        plan[2] = n > 0 ? n : 1;
        plan[3] = K * SHEAR_G;
        plan[4] = 0;
        plan[5] = K;
        return 0;
    }
    int R = 0;
#define SHEAR_R(c, r) \
    if (ct == c) R = r;
    SHEAR_BUCKETS(SHEAR_R)
#undef SHEAR_R
    const int wpb = ct ? SHEAR_WPB : 1;
    const int64_t blocks = ((int64_t)n + wpb - 1) / wpb;
    if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
    plan[0] = C;
    plan[1] = R;
    plan[2] = (int)(blocks > 0 ? blocks : 1);
    plan[3] = wpb * SHEAR_G;
    plan[4] = ct ? 0 : SHEAR_ARRAYS * SHEAR_G * C * (int)sizeof(int);
    plan[5] = 1;
    return 0;
}

// Launch pairs [p0, P) on `stream` (PyTorch's current stream) in the form
// bsw_shear_plan gives for split: the split-band form, or one warp a pair
// in the 16-bit body (s16) or the int32 one; returns a CUDA error code
// (the plan's, or cudaGetLastError() of the launch) so the wrapper can
// raise on a refused launch.  n16: null, or a count on the card that
// splits [p0, P) between the two one-warp bodies (ShearBatch::n16; the
// launch is sized for all of [p0, P)).  out: int32[P, 6], rows [p0, P)
// written.
extern "C" int bsw_shear_launch(
    const int8_t *enc, int64_t n_enc, const uint8_t *ref, int64_t n_ref,
    int ref_packed, const int *qoff, const int *qdir, const int *qlen,
    const int64_t *toff, const int *tdir, const int *tlen, const int *h0,
    const int *w, const int *n16, int p0, int P, int s16, int split, int Wh,
    int Tmax, int a, int b, int o_del, int e_del, int o_ins, int e_ins,
    int zdrop, int end_bonus, int max_sc, int *out, void *stream) {
    if (p0 < 0 || p0 > P) return (int)cudaErrorInvalidValue;
    int plan[6];
    const int err = bsw_shear_plan(Wh, P - p0, s16, split, plan);
    if (err || p0 == P) return err;
    cudaStream_t st = (cudaStream_t)stream;
    const ShearBatch batch{enc,  n_enc, ref,  n_ref, ref_packed, qoff,
                           qdir, qlen,  toff, tdir,  tlen,       h0,
                           w,    p0,    P,    Wh,    Tmax,       plan[0],
                           {a, b, o_del, e_del, o_ins, e_ins, zdrop,
                            end_bonus, max_sc},
                           out,  plan[5] > 1 ? nullptr : n16};
    if (plan[5] > 1) {             // the split-band form
#define SHEAR_BLK_LAUNCH(k, c, wh)                                        \
    if (plan[5] == k && plan[0] == c)                                     \
        bsw_shear_blk_kernel<k, c><<<plan[2], plan[3], 0, st>>>(batch);
        SHEAR_BLK_BUCKETS(SHEAR_BLK_LAUNCH)
#undef SHEAR_BLK_LAUNCH
        return (int)cudaGetLastError();
    }
    if (plan[1] == 0) {            // the memory frame
        const cudaError_t e = cudaFuncSetAttribute(
            bsw_shear_wide_kernel,
            cudaFuncAttributeMaxDynamicSharedMemorySize, plan[4]);
        if (e) return (int)e;
        bsw_shear_wide_kernel<<<plan[2], plan[3], plan[4], st>>>(batch);
        return (int)cudaGetLastError();
    }
#define SHEAR_LAUNCH(c, r)                                               \
    if (plan[0] == c) {                                                  \
        if (s16)                                                         \
            bsw_shear_s16_kernel<r><<<plan[2], plan[3], 0, st>>>(batch); \
        else                                                             \
            bsw_shear_kernel<c><<<plan[2], plan[3], 0, st>>>(batch);     \
    }
    SHEAR_BUCKETS(SHEAR_LAUNCH)
#undef SHEAR_LAUNCH
    return (int)cudaGetLastError();
}

#ifdef SHEAR_SASS_PROBE
// Each body alone at two slot counts, for tools/shear_sass.py's count of
// SASS instructions per slot (built only with -DSHEAR_SASS_PROBE).
template <int C>
__global__ void shear_probe_i32(const ShearBatch b) {
    shear_pair_i32<C>(BswGroup<SHEAR_G>(), b, blockIdx.x);
}
template <int R>
__global__ void shear_probe_s16(const ShearBatch b) {
    shear_pair_s16<R>(BswGroup<SHEAR_G>(), b, blockIdx.x);
}
template __global__ void shear_probe_i32<7>(const ShearBatch);
template __global__ void shear_probe_i32<13>(const ShearBatch);
template __global__ void shear_probe_s16<4>(const ShearBatch);
template __global__ void shear_probe_s16<7>(const ShearBatch);
#endif

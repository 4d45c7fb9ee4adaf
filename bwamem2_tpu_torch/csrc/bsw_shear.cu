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
// Design: one warp per pair (shear_group.cuh).  The pair's DP state is a
// frame of F = 32*C >= 2*Wh + 3 band offsets in registers, C slots per
// lane, which moves one column along the query per row: H, E and the
// query codes shift one slot left per row (a register move and one
// shfl_down at each lane's edge), and the row's work is bsw_extend's row
// over the frame instead of the query, so a row costs O(w), not O(qlen).
// C is chosen per launch from Wh (SHEAR_BUCKETS: 7 at the default w = 100,
// 13 on the band-doubling retry at 200); a wider band (Wh > 206) runs the
// same body with its frame in shared memory (one warp per block, 640 B per
// slot per lane, Wh up to 5806), and a launch beyond that is refused.  The row loop runs in the kernel;
// a pair stops on a zero row maximum, on z-drop, or after its last row (by
// row qlen + w its band is empty).  Warps per block are ceil(P / (SMs x
// 8)), at most 4, so a small launch still spreads over every SM; the
// dispatch (ops/bsw.py:DeviceBSW.long_order) launches each rung's pairs by
// descending row count.
//
// What bounds it: the same integer DP as bsw_extend.cu, counted the same
// way: 10 int32 operations per band cell (bsw_extend.cu's header) over the
// cells the band covers (bsw_shear_desc_ref's `cells`), at the card's
// INT32 issue rate, against the bytes moved (descriptors, qlen + tlen code
// bytes, the output).  chip_smoke.py reports that bound beside the
// measured time.  What the design spends beyond it: every lane runs all C
// of its slots each row (the band is 2w+1 of F slots), the frame shift (3
// registers per slot and 3 shuffles per row), the F scan, four reductions
// and two broadcasts per row; and one pair's rows run one after another,
// so a launch lasts at least as long as its longest pair.

#include <cuda_runtime.h>

#include "shear_group.cuh"

#define SHEAR_WARPS_MAX 4       // warps (pairs) per block at most

namespace {

// CT: a register bucket's slots per lane, or 0 for the shared-memory
// frame (b.C slots per lane, one warp per block).
template <int CT>
__global__ void __launch_bounds__(SHEAR_G * SHEAR_WARPS_MAX)
bsw_shear_kernel(const ShearBatch b) {
    const int p = blockIdx.x * (blockDim.x / SHEAR_G) + threadIdx.x / SHEAR_G;
    if (p >= b.P) return;          // the whole warp returns
    const BswGroup<SHEAR_G> g;
    if constexpr (CT > 0) {
        shear_group_pair<CT>(g, b, p);
    } else {
        extern __shared__ int shear_frame[];
        shear_group_pair<0>(g, b, p, shear_frame + g.lane(), SHEAR_G);
    }
}

// Target blocks per SM when warps per block are chosen for a small batch.
constexpr int SHEAR_BLOCKS_PER_SM = 8;

}  // namespace

// The launch's shape for P pairs at band radius Wh: plan[0] C (slots per
// lane), plan[1] warps per block, plan[2] shared-memory bytes per block (0
// for a register bucket).  Returns a CUDA error code
// (cudaErrorInvalidValue when no frame holds 2*Wh + 3 slots).
extern "C" int bsw_shear_plan(int Wh, int P, int *plan) {
    int C = 0;
    const int ct = shear_bucket(Wh, &C);
    if (ct < 0) return (int)cudaErrorInvalidValue;
    int dev = 0, nsm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (!err)
        err = cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount,
                                     dev);
    if (err) return (int)err;
    const int64_t spread = (int64_t)nsm * SHEAR_BLOCKS_PER_SM;
    int wpb = (int)((P + spread - 1) / spread);
    wpb = wpb < 1 ? 1 : (wpb > SHEAR_WARPS_MAX ? SHEAR_WARPS_MAX : wpb);
    plan[0] = C;
    plan[1] = ct > 0 ? wpb : 1;
    plan[2] = ct > 0 ? 0 : SHEAR_ARRAYS * SHEAR_G * C * (int)sizeof(int);
    return 0;
}

// Launch on `stream` (PyTorch's current stream); returns a CUDA error code
// (the plan's, or cudaGetLastError() of the launch) so the wrapper can
// raise on a refused launch.  out: int32[P, 6].
extern "C" int bsw_shear_launch(
    const int8_t *enc, int64_t n_enc, const uint8_t *ref, int64_t n_ref,
    int ref_packed, const int *qoff, const int *qdir, const int *qlen,
    const int64_t *toff, const int *tdir, const int *tlen, const int *h0,
    const int *w, int P, int Wh, int Tmax, int a, int b, int o_del,
    int e_del, int o_ins, int e_ins, int zdrop, int end_bonus, int max_sc,
    int *out, void *stream) {
    int plan[3];
    const int err = bsw_shear_plan(Wh, P, plan);
    if (err) return err;
    const ShearBatch batch{enc,  n_enc, ref,  n_ref, ref_packed, qoff,
                           qdir, qlen,  toff, tdir,  tlen,       h0,
                           w,    P,     Wh,   Tmax,  plan[0],
                           {a, b, o_del, e_del, o_ins, e_ins, zdrop,
                            end_bonus, max_sc},
                           out};
    const int wpb = plan[1];
    const int blocks = (P + wpb - 1) / wpb;
    cudaStream_t st = (cudaStream_t)stream;
    if (plan[2]) {                 // the shared-memory frame
        cudaError_t e = cudaFuncSetAttribute(
            bsw_shear_kernel<0>, cudaFuncAttributeMaxDynamicSharedMemorySize,
            plan[2]);
        if (e) return (int)e;
        bsw_shear_kernel<0><<<blocks, SHEAR_G, plan[2], st>>>(batch);
        return (int)cudaGetLastError();
    }
#define SHEAR_LAUNCH(c)                                                   \
    if (plan[0] == c)                                                     \
        bsw_shear_kernel<c><<<blocks, wpb * SHEAR_G, 0, st>>>(batch);
    SHEAR_BUCKETS(SHEAR_LAUNCH)
#undef SHEAR_LAUNCH
    return (int)cudaGetLastError();
}

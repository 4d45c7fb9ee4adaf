// bsw_extend: banded Smith-Waterman seed extension on Hopper (sm_90a).
//
// Replaces the TPU kernel bwamem2_tpu/ops/bsw_pallas.py:_mk_kernel (launched
// by _call, production entry bsw_desc_pallas) and its XLA twin
// bwamem2_tpu/ops/bsw.py:bsw_desc_kernel.  Plain PyTorch version:
// bwamem2_tpu_torch/ops/bsw.py:bsw_desc_ref; wrapper and build:
// bwamem2_tpu_torch/ops/bsw_cuda.py.
//
// Contract: P extension problems given by descriptors.  Query codes are
// gathered from the chunk's int8[N, L] read grid (qoff = flat row*L+col,
// qdir = +-1), target codes from the uint8 doubled genome (int64 toff,
// tdir = +-1; 2-bit packed when ref_packed), so no sequence tile is ever
// materialized.  Output int32[P, 6]: score qle tle gtle gscore max_off.
// Every pair must have qlen <= Qmax <= 383.
//
// Design: one lane group per pair (bsw_group.cuh).  G lanes (8, 16 or 32)
// share the pair's DP row, each owning C consecutive query columns whose H,
// E and query codes stay in registers for the whole pair; (G, C) is chosen
// per launch from the batch's longest query: the least of BSW_BUCKETS'
// nine column capacities (32 to 384) that holds it.  A row is one pass over
// the lane's columns for M and F's carry, a log2 G shuffle scan of the
// carries, a second pass for H and E, one shuffle for the column crossing
// to the next lane, and reductions for the row maximum and the band
// shrink; the row's target base comes from one coalesced load per G rows,
// broadcast a row at a time.  Nothing but the descriptors, the sequence
// codes and the output row touches memory: the earlier design's global H/E
// scratch ([2][Qmax+1][P] int32, 162 MB at the main path's (255, 320)
// rung, 16 bytes moved per band cell, uncoalesced) is gone.  Groups per
// block are ceil(P / (SMs x 8)), at most 128 threads, so a small batch
// still spreads over every SM; DeviceBSW launches each rung group's pairs
// by descending (tlen, qlen), so that the groups of a warp and neighbouring
// warps run rows of similar count.
//
// What bounds it: integer DP.  The bound counts the least int32 operations
// the recurrence needs per band cell, not this kernel's instruction mix: a
// precomputed query profile (qlen x 5 entries, negligible beside the
// cells), H and E held in registers, and sm_90's DPX instructions where
// one fuses two operations (__viaddmax_s32: max(a + b, c); __vimax3_s32:
// max(a, b, c)).  Per band cell (10):  1 profile load; 1 add of the
// diagonal H and the score; 1 select that zeroes it where the diagonal H is
// 0 (no restart through a zero cell); 1 three-way max of M, E and F; 2 for
// E' = max(E - e_del, max(M - oe_del, 0)) (two fused add-max); 2 for F'
// likewise; 2 for the row maximum with its column under the rightmost-tie
// rule (one multiply-add packing value and column into a key, one running
// max).  The band clamp, z-drop test and output are per row or per pair,
// and the band shrink's scans read only the cells at the band's edges, so
// none is counted.  The band covers ~2w+1 <= 201 columns per row.  The
// card's INT32 issue rate is 132 SMs x 64 lanes x 1.98 GHz = 16.7 Tops/s,
// a DPX instruction counted at that rate, against 3.35 TB/s for the ~36 B
// of descriptors + qlen + tlen code bytes in and 24 B out per pair, so
// the operation count bounds it by two orders of magnitude.  chip_smoke.py
// counts the cells these inputs actually compute (bsw_desc_ref's `cells`)
// and reports that bound beside the measured time, and beside it the bound
// of the earlier model (24 operations per cell, the one-thread kernel's
// unfused mix) so that the figures of both designs compare.  What the lane
// design spends beyond the bound: every lane runs all C of its columns
// each row, in the band or not (the band is ~2w+1 of up to G*C columns,
// and shrinks further), about 25 lane operations per column; the F scan,
// the column crossing, the target broadcast and four reductions per row;
// and the groups of a warp wait for the one with the most rows.

#include <cuda_runtime.h>

#include "bsw_group.cuh"

namespace {

template <int G, int C>
__global__ void __launch_bounds__(BSW_MAX_THREADS)
bsw_extend_kernel(const BswBatch b) {
    const int gpb = blockDim.x / G, gi = threadIdx.x / G;
    const int p = blockIdx.x * gpb + gi;
    if (p >= b.P) return;          // the whole group returns
    const BswGroup<G> g;
    bsw_group_pair<C>(g, b, p);
}

// Target blocks per SM when groups per block are chosen for a small batch.
constexpr int BSW_BLOCKS_PER_SM = 8;

}  // namespace

// The launch's shape for P pairs whose longest query is Qmax: plan[0] G
// (lanes per pair), plan[1] C (columns per lane), plan[2] groups per
// block.  Returns a CUDA error code (cudaErrorInvalidValue when no bucket
// holds Qmax + 1 columns).
extern "C" int bsw_plan(int Qmax, int P, int *plan) {
    int G = 0, C = 0;
    if (Qmax < 0 || !bsw_bucket(Qmax, &G, &C))
        return (int)cudaErrorInvalidValue;
    int dev = 0, nsm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (!err)
        err = cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount,
                                     dev);
    if (err) return (int)err;
    const int64_t spread = (int64_t)nsm * BSW_BLOCKS_PER_SM;
    int gpb = (int)((P + spread - 1) / spread);
    gpb = gpb < 1 ? 1 : (gpb > BSW_MAX_THREADS / G ? BSW_MAX_THREADS / G
                                                   : gpb);
    plan[0] = G;
    plan[1] = C;
    plan[2] = gpb;
    return 0;
}

// Launch on `stream` (PyTorch's current stream); returns a CUDA error code
// (the plan's, or cudaGetLastError() of the launch) so the wrapper can
// raise on a refused launch.  out: int32[P, 6].
extern "C" int bsw_extend_launch(
    const int8_t *enc, int64_t n_enc, const uint8_t *ref, int64_t n_ref,
    int ref_packed, const int *qoff, const int *qdir, const int *qlen,
    const int64_t *toff, const int *tdir, const int *tlen, const int *h0,
    const int *w, int P, int Qmax, int a, int b, int o_del, int e_del,
    int o_ins, int e_ins, int zdrop, int end_bonus, int max_sc, int *out,
    void *stream) {
    int plan[3];
    const int err = bsw_plan(Qmax, P, plan);
    if (err) return err;
    const BswBatch batch{enc,  n_enc, ref,  n_ref, ref_packed, qoff, qdir,
                         qlen, toff,  tdir, tlen,  h0,         w,    P,
                         {a, b, o_del, e_del, o_ins, e_ins, zdrop, end_bonus,
                          max_sc},
                         out};
    const int gpb = plan[2];
    const int blocks = (P + gpb - 1) / gpb;
    cudaStream_t st = (cudaStream_t)stream;
#define BSW_LAUNCH(G, C)                                                  \
    if (plan[0] == G && plan[1] == C)                                     \
        bsw_extend_kernel<G, C><<<blocks, gpb * G, 0, st>>>(batch);
    BSW_BUCKETS(BSW_LAUNCH)
#undef BSW_LAUNCH
    return (int)cudaGetLastError();
}

// round2_forward: the forward candidates of each pivot, one lane group per
// pivot, on Hopper (sm_90a).
//
// Replaces the JAX package's bwamem2_tpu/ops/smem.py:round2_forward_kernel
// (jitted XLA, not Pallas), which the per-stage seeding of the sharded
// index and of the legacy round 1 runs for round 1's pivots (min_intv 1)
// and round 2's re-seeding pivots (ops/backend.py:TorchBackend._round2).
// Per pivot (rid, x, min_intv): from the base at x of read rid in the read
// grid, extend forward while the interval stays >= min_intv, pushing the
// interval before each change of its size (the distinct-interval prefixes,
// at most C kept), then the last one.  The caller fills the slots (n -1;
// k, l, s 0).  Plain PyTorch version: ops/smem.py:round2_forward_ref;
// wrapper: ops/smem.py:Round2Forward; the group's body is
// r2f_group.cuh:r2f_group_run, compiled as host C++ by the tests.
//
// What bounds it.  Not its bytes or operations.  Operations: 131 int32
// operations (24 popcounts) per backward_ext in the one-thread form, the
// int32 pipe's 107 / 64 clocks per call and SM.  Bytes: the distinct occ
// rows read (32 B each), the pivots' columns of the read grid (1 B a
// step), 16 B of descriptor in, 28 B per candidate slot and the count
// out, over 3.35 TB/s; over a sharded index (D - 1) / D of the rows cross
// NVLink (450 GB/s each way).  Both are ~2 % of a launch.  Each step
// depends on the last (its rows' addresses are the previous step's
// interval), so a walk is a chain of row loads, and a launch lasts at
// least as long as its longest walk (up to L - 1 steps) at one step's
// latency: ~0.8-1 us a step alone on an H100 (PERF.md), one L2 round trip
// and the count after it.  A pivot holds 8 thread slots where the
// one-thread form held one: where a launch has more long walks than the
// card holds groups at once (24,576 pivots on chip_smoke.py's run (g),
// ~17,000 resident groups), the rest wait for a group to free, and the
// launch takes about two long walks, whatever their order (PERF.md).
//
// Design.  One thread per pivot ran each step's 131 operations serially
// in that thread, and a warp ran as long as its longest walk of 32.  Here
// 8 lanes walk one pivot: the step's char is known a step ahead, so lane
// w counts in code word w & 3 of the step's row w >> 2 only the chars
// equal to it and past it, one reduction gives every lane all four
// counts, and the new interval is a few int64 additions (r2f_group.cuh).
// The grid is persistent (resident blocks per SM x SMs, cut to the blocks
// the pivots fill); a group takes its next pivot from a launch-wide ticket
// counter as its walk ends, and a warp loops until every group of it is
// done, so its groups reconverge every step.
// Measured against the one-thread kernel in one call (PERF.md).
// Instantiated over FmView and FmShardView as round1_chain.cu.

#include <cuda_runtime.h>

#include "r2f_group.cuh"

#define R2F_MAX_THREADS 256

namespace {

template <int SHARDED>
__global__ void __launch_bounds__(R2F_MAX_THREADS)
round2_forward_kernel(const R2fBatch<typename FmViewOf<SHARDED>::type> b,
                      unsigned long long *next) {
    R2fGroup g(next);
    r2f_group_run(g, b);
}

template <int SHARDED>
int r2f_resident_of(int threads, int *blocks) {
    int dev = 0, nsm = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (!err)
        err = cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount,
                                     dev);
    if (!err)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, round2_forward_kernel<SHARDED>, threads, 0);
    if (err) return (int)err;
    *blocks = (per_sm < 1 ? 1 : per_sm) * nsm;
    return 0;
}

}  // namespace

// The blocks of `threads` threads that the current device holds at once
// over the replicated (sharded 0) or sharded (1) index (the occupancy API
// x SMs): the persistent grid, which the wrapper cuts to the blocks the
// pivots fill.  A CUDA error code (cudaErrorInvalidValue for a block that
// is not whole warps of at most R2F_MAX_THREADS).
extern "C" int round2_forward_resident(int sharded, int threads,
                                       int *blocks) {
    if (threads < 32 || threads > R2F_MAX_THREADS || threads % 32)
        return (int)cudaErrorInvalidValue;
    return sharded ? r2f_resident_of<1>(threads, blocks)
                   : r2f_resident_of<0>(threads, blocks);
}

// Launch `blocks` blocks of `threads` threads on `stream` (PyTorch's
// current stream) after zeroing the ticket counter `next` there; returns
// a CUDA error code.  fm: the index as fm_occ.cuh's table (host memory);
// enc int8[N, L] (NL = N * L); rid, x int32[P], mi int64[P]; cn
// int32[P, C], ck, cl, cs int64[P, C] (filled by the caller), ncand
// int32[P].
extern "C" int round2_forward_launch(const int64_t *fm, const int8_t *enc,
                                     int64_t NL, int L, const int *rid,
                                     const int *x, const int64_t *mi, int P,
                                     int C, int *cn, int64_t *ck,
                                     int64_t *cl, int64_t *cs, int *ncand,
                                     int blocks, int threads,
                                     unsigned long long *next,
                                     void *stream) {
    cudaStream_t st = (cudaStream_t)stream;
    cudaError_t err = cudaMemsetAsync(next, 0, sizeof *next, st);
    if (err) return (int)err;
    if (fm[0] == 1)
        round2_forward_kernel<0><<<blocks, threads, 0, st>>>(
            R2fBatch<FmView>{fm_view_of(fm), enc, NL, L, rid, x, mi, P, C,
                             cn, ck, cl, cs, ncand},
            next);
    else
        round2_forward_kernel<1><<<blocks, threads, 0, st>>>(
            R2fBatch<FmShardView>{fm_shard_view_of(fm), enc, NL, L, rid, x,
                                  mi, P, C, cn, ck, cl, cs, ncand},
            next);
    return (int)cudaGetLastError();
}

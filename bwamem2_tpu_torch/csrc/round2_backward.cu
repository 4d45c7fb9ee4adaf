// round2_backward: the backward walk of each forward candidate, each warp's
// lanes refilled as their walks end, on Hopper (sm_90a).
//
// Replaces the JAX package's bwamem2_tpu/ops/smem.py:
// round2_backward_kernel and round2_backward_resume_kernel (jitted XLA,
// not Pallas; both through _bwd_walk), which the per-stage seeding of the
// sharded index and of the legacy round 1 runs after round2_forward
// (ops/backend.py:TorchBackend._round2).  Per lane: from column x - 1 of
// its read, one LF step per column while the interval stays >= min_intv;
// a step below it kills the lane (died), column 0 or an N ends the walk.
// One kernel, two entries: round2_backward_launch starts each lane from
// its pivot's forward candidate (k, s) = (ck, cs)[piv, slot] (a pivot at x
// 0 or an empty interval is a dead lane) and writes the alive flag too;
// round2_backward_resume_launch continues lanes from a given (col, k, s).
// Each walks at most n_steps steps: the JAX kernels run a short first
// phase and resume the survivors, the port's caller walks every lane to
// its end in one launch (n_steps = L) and resumes the wide tier's lanes.
// Plain PyTorch versions: ops/smem.py:round2_backward_ref,
// round2_backward_resume_ref; wrapper: ops/smem.py:Round2Backward; the
// warp's body is r2b_group.cuh:r2b_group_run, compiled as host C++ by the
// tests.
//
// What bounds it.  Not its bytes or operations.  Operations: each LF
// step is two one-char occ counts, 63 int32 operations of which 8
// popcounts (round1_walk.cu's model), the int32 pipe's 55 / 64 clocks per
// step and SM.  Bytes: two 32-byte occ rows per step (the distinct rows
// the plain version counts), one read grid byte per step, the lane's
// descriptor in (4 + 4 + 8 + 8 B from the pivot and candidate grids, 8 B
// of indices) and 21 B out, over 3.35 TB/s; over a sharded index (D - 1)
// / D of the rows cross NVLink (450 GB/s each way).  Both are ~2-5 % of a
// launch.  A walk is a chain of dependent row loads, so a launch lasts
// at least as long as its longest walk (up to L - 1 steps) at one step's
// latency: ~0.7 us a step alone on an H100 (PERF.md), one L2 round trip
// and the count after it.
//
// Design.  One thread per lane ran each walk to its end: most lanes die
// within a few steps, so a warp's time was its longest walk and most of
// its lanes idled.  Here the grid is persistent (resident blocks per SM x
// SMs, cut to the blocks the lanes fill) and each thread keeps one walk in
// registers (r2b_group.cuh): the first fill is strided over the whole
// grid, a thread whose walk ended is refilled from a launch-wide ticket
// counter, a walk's next base is loaded with its rows, and the first
// entry's short walks and the resume entry's long ones run through the
// same loop.  Measured (PERF.md): one walk a thread is the fastest (two
// and four, at 80 and 146-150 registers, hold more walks a thread than
// latency-bound steps can use), and it runs close to the one-thread
// kernel, whose launches were already within ~1.5x of their longest walk.
// Instantiated over FmView and FmShardView as round1_chain.cu.

#include <cuda_runtime.h>

#include "r2b_group.cuh"

#define R2B_MAX_THREADS 256

namespace {

template <int SHARDED>
__global__ void __launch_bounds__(R2B_MAX_THREADS)
round2_backward_kernel(const R2bBatch<typename FmViewOf<SHARDED>::type> b,
                       unsigned long long *next) {
    SaWarp g(next);
    r2b_group_run(g, b);
}

template <int SHARDED>
int r2b_resident_of(int threads, int *blocks) {
    int dev = 0, nsm = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (!err)
        err = cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount,
                                     dev);
    if (!err)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, round2_backward_kernel<SHARDED>, threads, 0);
    if (err) return (int)err;
    *blocks = (per_sm < 1 ? 1 : per_sm) * nsm;
    return 0;
}

// the lanes of `a` over the index view of the table fm (its shard count:
// 1 is the replicated index), after zeroing the ticket counter `next`
int launch(const int64_t *fm, const R2bBatch<FmView> &a, int blocks,
           int threads, unsigned long long *next, void *stream) {
    cudaStream_t st = (cudaStream_t)stream;
    cudaError_t err = cudaMemsetAsync(next, 0, sizeof *next, st);
    if (err) return (int)err;
    if (fm[0] == 1) {
        R2bBatch<FmView> b = a;
        b.f = fm_view_of(fm);
        round2_backward_kernel<0><<<blocks, threads, 0, st>>>(b, next);
    } else {
        const R2bBatch<FmShardView> b{
            fm_shard_view_of(fm), a.enc, a.NL, a.L, a.rid, a.x, a.mi, a.ck,
            a.cs, a.C, a.piv, a.slot, a.col0, a.k0, a.s0, a.M, a.n_steps,
            a.col, a.k, a.s, a.died, a.alive};
        round2_backward_kernel<1><<<blocks, threads, 0, st>>>(b, next);
    }
    return (int)cudaGetLastError();
}

}  // namespace

// The blocks of `threads` threads that the current device holds at once
// over the replicated (sharded 0) or sharded (1) index (the occupancy API
// x SMs): the persistent grid, which the wrapper cuts to the blocks the
// lanes fill.  A CUDA error code (cudaErrorInvalidValue for a block that
// is not whole warps of at most R2B_MAX_THREADS).
extern "C" int round2_backward_resident(int sharded, int threads,
                                        int *blocks) {
    if (threads < 32 || threads > R2B_MAX_THREADS || threads % 32)
        return (int)cudaErrorInvalidValue;
    return sharded ? r2b_resident_of<1>(threads, blocks)
                   : r2b_resident_of<0>(threads, blocks);
}

// Lanes from the forward candidates, `blocks` blocks of `threads` threads,
// after zeroing the ticket counter `next` on `stream` (PyTorch's current
// stream); returns a CUDA error code.  fm: the index as fm_occ.cuh's
// table (host memory); enc int8[N, L] (NL = N * L); ridp, xp int32[P], mi
// int64[P], ck, cs int64[P, C]; piv, slot int32[M]; out: col int32[M], k,
// s int64[M], died, alive bool[M].
extern "C" int round2_backward_launch(
        const int64_t *fm, const int8_t *enc, int64_t NL, int L,
        const int *ridp, const int *xp, const int64_t *mi,
        const int64_t *ck, const int64_t *cs, int C, const int *piv,
        const int *slot, int M, int n_steps, int *col, int64_t *k,
        int64_t *s, bool *died, bool *alive, int blocks, int threads,
        unsigned long long *next, void *stream) {
    const R2bBatch<FmView> a{FmView{}, enc, NL, L, ridp, xp, mi, ck, cs, C,
                             piv, slot, nullptr, nullptr, nullptr, M,
                             n_steps, col, k, s, died, alive};
    return launch(fm, a, blocks, threads, next, stream);
}

// Lanes resumed from (col0, k0, s0), lane i of read rid[i] at pivot
// column x[i] with min_intv mi[i] (all [M]); out as above without alive.
extern "C" int round2_backward_resume_launch(
        const int64_t *fm, const int8_t *enc, int64_t NL, int L,
        const int *rid, const int *x, const int64_t *mi, const int *col0,
        const int64_t *k0, const int64_t *s0, int M, int n_steps, int *col,
        int64_t *k, int64_t *s, bool *died, int blocks, int threads,
        unsigned long long *next, void *stream) {
    const R2bBatch<FmView> a{FmView{}, enc, NL, L, rid, x, mi, nullptr,
                             nullptr, 0, nullptr, nullptr, col0, k0, s0, M,
                             n_steps, col, k, s, died, nullptr};
    return launch(fm, a, blocks, threads, next, stream);
}

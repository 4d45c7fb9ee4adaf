// round2_forward: the forward candidates of each pivot, one thread per
// pivot, on Hopper (sm_90a).
//
// Replaces the JAX package's bwamem2_tpu/ops/smem.py:round2_forward_kernel
// (jitted XLA, not Pallas), which the per-stage seeding of the sharded
// index and of the legacy round 1 runs for round 1's pivots (min_intv 1)
// and round 2's re-seeding pivots (ops/backend.py:TorchBackend._round2).
// Per pivot (rid, x, min_intv): from the base at x of read rid in the read
// grid, extend forward while the interval stays >= min_intv, pushing the
// interval before each change of its size (the distinct-interval
// prefixes, at most C kept), then the last one.  The caller fills the
// slots (n -1; k, l, s 0).  Plain PyTorch version:
// ops/smem.py:round2_forward_ref; wrapper: ops/smem.py:Round2Forward; the
// pivot's body is seed_stages.cuh:stage_round2_forward, compiled as host
// C++ by the tests.
//
// What bounds it.  As round1_chain.cu: 131 int32 operations (24
// popcounts) and two 32-byte occ rows per backward_ext (the int32 pipe,
// 107 / 64 clocks per call and SM); bytes the distinct rows read, the
// pivots' columns of the read grid (1 B a step) and 16 B of descriptor in,
// 28 B per candidate slot and the count out, over 3.35 TB/s; over a
// sharded index (D - 1) / D of the rows cross NVLink (450 GB/s each way).
//
// Design.  One thread per pivot, its walk to the end (each step depends on
// the last); a warp runs as long as its longest walk.  A walk is a chain
// of row loads, and a launch lasts about as long as its longest walk at
// one step's latency (~0.8-0.9 us alone on an H100).  Eight lanes a pivot
// on a persistent grid ran 1.5x slower on chip_smoke.py's run (g):
// the group's reduction did not shorten a step, and a pivot held eight
// thread slots, so the largest launches took two long walks (PERF.md).
// Instantiated over FmView and FmShardView as round1_chain.cu.

#include <cuda_runtime.h>

#include "seed_stages.cuh"

#define R2F_THREADS 128

namespace {

template <int SHARDED>
__global__ void __launch_bounds__(R2F_THREADS)
round2_forward_kernel(const typename FmViewOf<SHARDED>::type f,
                      const int8_t *__restrict__ enc, int64_t NL, int L,
                      const int *__restrict__ rid,
                      const int *__restrict__ x,
                      const int64_t *__restrict__ mi, int P, int C,
                      int *__restrict__ cn, int64_t *__restrict__ ck,
                      int64_t *__restrict__ cl, int64_t *__restrict__ cs,
                      int *__restrict__ ncand) {
    const int p = blockIdx.x * blockDim.x + threadIdx.x;
    if (p >= P) return;
    const int64_t o = (int64_t)p * C;
    int64_t steps = 0;
    ncand[p] = stage_round2_forward(f, enc, NL, L, rid[p], x[p], mi[p], C,
                                    cn + o, ck + o, cl + o, cs + o, &steps);
}

}  // namespace

// Launch on `stream` (PyTorch's current stream); returns
// cudaGetLastError() of the launch.  fm: the index as fm_occ.cuh's table
// (host memory); enc int8[N, L] (NL = N * L); rid, x int32[P], mi
// int64[P]; cn int32[P, C], ck, cl, cs int64[P, C] (filled by the
// caller), ncand int32[P].
extern "C" int round2_forward_launch(const int64_t *fm, const int8_t *enc,
                                     int64_t NL, int L, const int *rid,
                                     const int *x, const int64_t *mi, int P,
                                     int C, int *cn, int64_t *ck,
                                     int64_t *cl, int64_t *cs, int *ncand,
                                     void *stream) {
    const unsigned blocks = (unsigned)((P + R2F_THREADS - 1) / R2F_THREADS);
    cudaStream_t st = (cudaStream_t)stream;
    if (fm[0] == 1)
        round2_forward_kernel<0><<<blocks, R2F_THREADS, 0, st>>>(
            fm_view_of(fm), enc, NL, L, rid, x, mi, P, C, cn, ck, cl, cs,
            ncand);
    else
        round2_forward_kernel<1><<<blocks, R2F_THREADS, 0, st>>>(
            fm_shard_view_of(fm), enc, NL, L, rid, x, mi, P, C, cn, ck, cl,
            cs, ncand);
    return (int)cudaGetLastError();
}

// round1_chain: round 1's pivot chain, one thread per read, on Hopper
// (sm_90a).
//
// Replaces the JAX package's bwamem2_tpu/ops/smem.py:round1_chain_kernel
// (jitted XLA, not Pallas), the first stage of the per-stage seeding that
// the sharded index runs (ops/backend.py:TorchBackend.collect_smems).  Per
// read: from x = 0, a pivot at each base; its segment extends forward
// (backward_ext on the RC twin) until the interval empties, an N or the
// read end.  Writes the pivot count and the pivots (the caller fills px
// with -1).  Plain PyTorch version: ops/smem.py:round1_chain_ref; wrapper:
// ops/smem.py:Round1Chain; the read's body is
// seed_stages.cuh:stage_round1_chain, which the tests compile as host C++.
//
// What bounds it.  Not its bytes or operations.  Operations: each
// backward_ext is two all-four occ counts, 131 int32 operations of which
// 24 popcounts (the model of smem_collect.cu's header); on sm_90 the
// int32 pipe's 107 / 64 clocks per call and SM bound them.  Bytes: two
// 32-byte occ rows per backward_ext (the plain version counts the distinct
// rows the run reads, each once), the read grid (1 B per column) and
// lengths in, 4 B per pivot slot and read out, over 3.35 TB/s; over a
// sharded index (D - 1) / D of the rows cross NVLink (450 GB/s each way).
// chip_smoke.py computes that bound from the plain version's counts: a
// few % of a launch.  A launch waits on latency: a read's chain is a
// sequence of loads, each addressed by the interval the one before gave
// (~0.7-0.8 us a load alone on an H100, PERF.md); a launch of 7,500 reads
// (59 blocks on 132 SMs: nothing to hide a wait behind) lasts about as
// long as its longest chain, 149 loads on chip_smoke.py's run (g), a read
// in a repeat family.
//
// Design.  One thread per read walks its whole chain (the chain is
// sequential in the read: each segment starts where the last one died) in
// one flat loop, so a warp's lanes step together whatever segment each is
// in.  The sharded instantiation issues a step's two occ rows before it
// counts either (one round trip a step; the replicated one counts the first
// row before it loads the second: SASS, PERF.md).  Starting segments from
// the K-mer table and locating small intervals to compare them with the
// genome were measured and left out: neither shortens the longest chain by
// more than 6 of its 149 loads, and neither made a launch faster (PERF.md).
// Two instantiations: the replicated index (FmView) and the sharded one
// (FmShardView, fm_occ.cuh), picked by the launcher from the index table's
// shard count.

#include <cuda_runtime.h>

#include "seed_stages.cuh"

#define R1C_THREADS 128

namespace {

template <int SHARDED>
__global__ void __launch_bounds__(R1C_THREADS)
round1_chain_kernel(const typename FmViewOf<SHARDED>::type f,
                    const int8_t *__restrict__ enc,
                    const int *__restrict__ lens, int N, int L, int cap,
                    int *__restrict__ npiv, int *__restrict__ px) {
    const int r = blockIdx.x * blockDim.x + threadIdx.x;
    if (r >= N) return;
    int64_t steps = 0;
    npiv[r] = stage_round1_chain(f, enc + (int64_t)r * L, lens[r], cap,
                                 px + (int64_t)r * cap, &steps);
}

}  // namespace

// Launch on `stream` (PyTorch's current stream); returns
// cudaGetLastError() of the launch.  fm: the index as fm_occ.cuh's table
// (host memory); enc int8[N, L] (codes 0..4), lens int32[N]; npiv
// int32[N], px int32[N, cap] (filled with -1 by the caller).
extern "C" int round1_chain_launch(const int64_t *fm, const int8_t *enc,
                                   const int *lens, int N, int L, int cap,
                                   int *npiv, int *px, void *stream) {
    const unsigned blocks = (unsigned)((N + R1C_THREADS - 1) / R1C_THREADS);
    cudaStream_t st = (cudaStream_t)stream;
    if (fm[0] == 1)
        round1_chain_kernel<0><<<blocks, R1C_THREADS, 0, st>>>(
            fm_view_of(fm), enc, lens, N, L, cap, npiv, px);
    else
        round1_chain_kernel<1><<<blocks, R1C_THREADS, 0, st>>>(
            fm_shard_view_of(fm), enc, lens, N, L, cap, npiv, px);
    return (int)cudaGetLastError();
}

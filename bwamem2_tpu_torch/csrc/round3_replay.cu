// round3_replay: round 3's seeds under max_mem_intv, one thread per read,
// on Hopper (sm_90a).
//
// Replaces the JAX package's bwamem2_tpu/ops/smem.py:round3_replay_kernel
// (jitted XLA, not Pallas) as a launch of its own in the per-stage seeding
// of the sharded index and of the legacy round 1 (ops/backend.py:
// TorchBackend.collect_smems; the replicated index runs round 3 inside
// smem_collect).  Per read (bwtSeedStrategyAllPosOneThread): from x = 0,
// a segment extends forward until its interval drops below max_intv at a
// length of at least min_len (opt.min_seed_len + 1), an N or the read end;
// a stop with a non-empty interval is a seed [x, col]; next x = col + 1.
// The caller fills the slots (x, n -1; s, k 0).  Plain PyTorch version:
// ops/smem.py:round3_replay_ref; wrapper: ops/smem.py:Round3Replay; the
// read's body is seed_stages.cuh:stage_round3, compiled as host C++ by the
// tests.
//
// What bounds it.  Not its bytes or operations.  As round1_chain.cu: 131
// int32 operations (24 popcounts) and two 32-byte occ rows per
// backward_ext, the int32 pipe at 107 / 64 clocks per call and SM; bytes
// the distinct rows read, the read grid and lengths in and 24 B per seed
// slot plus the count out, over 3.35 TB/s; over a sharded index (D - 1) /
// D of the rows cross NVLink (450 GB/s each way).  A launch waits on
// latency: a read's segments follow one another (each starts where the
// last stopped), each step is a load addressed by the one before, and a
// launch of 7,500 reads lasts about as long as its longest chain, 149
// loads on chip_smoke.py's run (g) (one segment in a repeat family whose
// interval stays at max_intv or above to the read's end), at ~0.9 us a
// load alone (PERF.md).
//
// Design.  One thread per read, its chain to the end in one flat loop as
// round1_chain.cu (a step's loads as there); cap >= L / min_len + 1 slots
// cannot overflow.  Running later segments ahead from speculated starts cuts
// the mean chain but cannot split the longest one, and the K-mer start saves
// 6 of its loads; both were measured and left out (PERF.md).  Instantiated
// over FmView and FmShardView as round1_chain.cu.

#include <cuda_runtime.h>

#include "seed_stages.cuh"

#define R3_THREADS 128

namespace {

template <int SHARDED>
__global__ void __launch_bounds__(R3_THREADS)
round3_replay_kernel(const typename FmViewOf<SHARDED>::type f,
                     const int8_t *__restrict__ enc,
                     const int *__restrict__ lens, int N, int L,
                     int64_t max_intv, int min_len, int cap,
                     int *__restrict__ nout, int *__restrict__ ox,
                     int *__restrict__ on, int64_t *__restrict__ os,
                     int64_t *__restrict__ ok) {
    const int r = blockIdx.x * blockDim.x + threadIdx.x;
    if (r >= N) return;
    const int64_t o = (int64_t)r * cap;
    int64_t steps = 0;
    nout[r] = stage_round3(f, enc + (int64_t)r * L, lens[r], max_intv,
                           min_len, cap, ox + o, on + o, os + o, ok + o,
                           &steps);
}

}  // namespace

// Launch on `stream` (PyTorch's current stream); returns
// cudaGetLastError() of the launch.  fm: the index as fm_occ.cuh's table
// (host memory); enc int8[N, L], lens int32[N]; nout int32[N], ox, on
// int32[N, cap] and os, ok int64[N, cap], filled by the caller.
extern "C" int round3_replay_launch(const int64_t *fm, const int8_t *enc,
                                    const int *lens, int N, int L,
                                    int64_t max_intv, int min_len, int cap,
                                    int *nout, int *ox, int *on, int64_t *os,
                                    int64_t *ok, void *stream) {
    const unsigned blocks = (unsigned)((N + R3_THREADS - 1) / R3_THREADS);
    cudaStream_t st = (cudaStream_t)stream;
    if (fm[0] == 1)
        round3_replay_kernel<0><<<blocks, R3_THREADS, 0, st>>>(
            fm_view_of(fm), enc, lens, N, L, max_intv, min_len, cap, nout,
            ox, on, os, ok);
    else
        round3_replay_kernel<1><<<blocks, R3_THREADS, 0, st>>>(
            fm_shard_view_of(fm), enc, lens, N, L, max_intv, min_len, cap,
            nout, ox, on, os, ok);
    return (int)cudaGetLastError();
}

// sa_resolve: suffix-array resolution of BWT positions on Hopper (sm_90a),
// each warp's lanes refilled as their walks end.
//
// Replaces the JAX package's SA walks (jitted XLA, not Pallas):
// bwamem2_tpu/ops/seedall.py:_sa_walk (inside _stage_merge_sa) and
// ops/salookup.py:sa_lookup_kernel.  Semantics: get_sa_entry_compressed
// (FMI_search.cpp:1103-1175), as the port's host rt_sa_entries
// (native/runtime.cpp).  Plain PyTorch version: ops/seed.py:
// sa_resolve_ref; wrapper: ops/seed_cuda.py:SaResolve.  The walk-and-refill
// loop is csrc/sa_group.cuh, which the tests compile as host C++.
//
// What bounds it: bytes.  One dependent random 32-byte occ-row read per LF
// step (about 7 steps per position on the main path, geometric: 1/8 of
// the positions are sampled), then a 1-byte and a 4-byte SA read, the
// 8-byte position in and the 8-byte coordinate out: chip_smoke.py's bound
// is 32 B per row read plus 5 + 16 B per position, over 3.35 TB/s.  The
// instruction work per step (a row's popcounts, ~100 int32 operations) is
// below that at the card's issue rate.
//
// Design.  A warp that walks one position per lane runs until its longest
// walk ends (the longest of 32 geometric walks is ~26 steps against a mean
// of 7: ~27 % of the lane-steps would do work), and a row or count array
// indexed at run time sits in a stack frame in local memory.  So the grid
// is persistent (resident blocks per SM x SMs, from the occupancy
// API, fewer where the positions fill fewer); each thread keeps W walks in
// registers (a template argument) and refills a slot when its walk ends
// from its warp's reservation of tickets, renewed from a launch-wide
// counter with one atomic per warp (sa_group.cuh), so lanes stay busy
// until the queue drains and blocks do not wait on their slowest warp.
// Each iteration waits only on its rows: new positions and SA entries are
// loaded one iteration ahead of their use.  The row's code word and the
// char's checkpoint and count are taken by selects (fm_occ.cuh:
// fm_char_occ_row, fm_cp, fm_count), so nothing is indexed at run time
// and ptxas reports no stack frame.  What remains: the longest walk of a
// launch (~106 steps among 1.4 million positions) is a chain of dependent
// row reads that no schedule shortens.  The wrapper chooses W and the
// block size (SaResolve.shape_for).
//
// Sharded index.  Each kernel is instantiated twice: over FmView (the
// replicated index, the code above) and over FmShardView (the occ rows and
// SA words split by row range over cards, fm_occ.cuh), where each row and
// SA read picks its shard and may be a peer load over NVLink; the walks
// and the bound are the same.  The launcher takes the index as
// fm_occ.cuh's table and picks the instantiation from its shard count.

#include <cuda_runtime.h>

#include "sa_group.cuh"

#define SA_MAX_THREADS 512

namespace {

template <int W, int SHARDED>
__global__ void __launch_bounds__(SA_MAX_THREADS)
sa_resolve_kernel(const SaBatchOf<typename FmViewOf<SHARDED>::type> b,
                  unsigned long long *next) {
    SaWarp g(next);
    sa_group_run<W>(g, b);
}

// every instantiation: walks per lane.  One: on an NVIDIA H100 at 700 W,
// W = 2 and W = 4 (54 and 92 registers, fewer warps resident) were
// slower than W = 1 (39 registers) at every chunk size measured, from
// 42,598 to 1,736,470 positions, L2- and DRAM-resident (PERF.md).
#define SA_WALKS(X) X(1)

template <int W, int SHARDED>
int sa_resident_of(int threads, int *blocks) {
    int dev = 0, nsm = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (!err)
        err = cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount,
                                     dev);
    if (!err)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, sa_resolve_kernel<W, SHARDED>, threads, 0);
    if (err) return (int)err;
    *blocks = (per_sm < 1 ? 1 : per_sm) * nsm;
    return 0;
}

template <int SHARDED>
int sa_launch(const SaBatchOf<typename FmViewOf<SHARDED>::type> &b, int W,
              int blocks, int threads, unsigned long long *next,
              cudaStream_t st) {
#define SA_LAUNCH(WW)                                                     \
    if (W == WW) {                                                        \
        sa_resolve_kernel<WW, SHARDED><<<blocks, threads, 0, st>>>(b,     \
                                                                   next); \
        return (int)cudaGetLastError();                                   \
    }
    SA_WALKS(SA_LAUNCH)
#undef SA_LAUNCH
    return (int)cudaErrorInvalidValue;
}

}  // namespace

// The blocks of `threads` threads that the current device holds at once at
// W walks per lane over the replicated (sharded 0) or sharded (1) index
// (the occupancy API x SMs): the persistent grid, which the wrapper cuts to
// the blocks the positions fill.  A CUDA error code (cudaErrorInvalidValue
// for a W that is not instantiated or a block that is not whole warps of
// at most SA_MAX_THREADS).
extern "C" int sa_resolve_resident(int W, int sharded, int threads,
                                   int *blocks) {
    if (threads < 32 || threads > SA_MAX_THREADS || threads % 32)
        return (int)cudaErrorInvalidValue;
#define SA_RESIDENT(WW)                                                   \
    if (W == WW)                                                          \
        return sharded ? sa_resident_of<WW, 1>(threads, blocks)           \
                       : sa_resident_of<WW, 0>(threads, blocks);
    SA_WALKS(SA_RESIDENT)
#undef SA_RESIDENT
    return (int)cudaErrorInvalidValue;
}

// Launch `blocks` blocks on `stream` (PyTorch's current stream) after
// zeroing the ticket counter `next` there; returns a CUDA error code
// (cudaGetLastError() of the launch, or cudaErrorInvalidValue for a W that
// is not instantiated).  fm: the index as fm_occ.cuh's table (host
// memory); pos and out int64[P].
extern "C" int sa_resolve_launch(const int64_t *fm, const int64_t *pos,
                                 int64_t P, int64_t *out, int W, int blocks,
                                 int threads, unsigned long long *next,
                                 void *stream) {
    cudaStream_t st = (cudaStream_t)stream;
    cudaError_t err = cudaMemsetAsync(next, 0, sizeof *next, st);
    if (err) return (int)err;
    if (fm[0] == 1)
        return sa_launch<0>(SaBatch{fm_view_of(fm), (const int8_t *)fm[26],
                                    (const uint32_t *)fm[34], pos, P, out},
                            W, blocks, threads, next, st);
    return sa_launch<1>(SaBatchOf<FmShardView>{fm_shard_view_of(fm),
                                               nullptr, nullptr, pos, P, out},
                        W, blocks, threads, next, st);
}

// smem_collect: SMEM collection (all three rounds + the per-read sort) on
// Hopper (sm_90a), one lane group per read.
//
// Replaces the JAX package's fused seeding stages (jitted XLA, not Pallas):
// bwamem2_tpu/ops/seedall.py:_stage_chain_collect, _stage_bwd_emit1,
// _stage_round (_fwd_phased, _bwd_lanes), _stage_select2, _stage_retry*,
// the merge/sort of _stage_merge_sa, and ops/smem.py:round3_replay_kernel
// and _bwd_walk.  Plain PyTorch version: bwamem2_tpu_torch/ops/seed.py:
// smem_collect_ref; wrapper: ops/seed_cuda.py.  The per-read algorithm is
// csrc/smem_group.cuh, which the tests compile as host C++.
//
// Design.  A group of G lanes (16 or 32; a template argument chosen by the
// wrapper from the chunk's read count) seeds one read: the forward walks run as one step of the
// whole group with the two occ rows' code words split over the lanes, the
// backward steps one candidate per lane, the sequential rules of the host
// loop as ballots, shuffles and a prefix popcount (smem_group.cuh).  The
// candidate list and the staged output slots stay in the group's shared
// memory: LCAP list entries (a compile-time bucket, 160 or 320, chosen by
// the wrapper from the grid width) and SMEM_STAGE slots; a read with more
// slots stages in its own output slots.  Each read's slots are its own
// (ops/seed.py:slot_offsets, from its length), at offsets prefix-summed on
// the device, so no buffer scales with N x L.  The grid is persistent: one
// block per resident slot (the occupancy of this instantiation and its
// shared memory), four groups per block, each group taking its next read
// from an atomic counter in the order the wrapper gives (longest first), so
// a long read does not hold a block while the short ones wait.  What still
// holds it back: each forward step is a dependent round trip to the occ
// table (the walks are chains), and the groups resident on an SM are
// bounded by their shared memory (~4.7 KB per group at LCAP 160).
//
// What bounds it.  Bytes: every backward_ext reads two 32-byte occ rows at
// data-dependent places (the kernel counts its calls per read), plus the
// read grid and the written slots, over 3.35 TB/s.  Operations: the least
// int32 operations a backward_ext needs, not this kernel's instruction mix:
//   per code word (4 per row, 8 per call): 1 shift (the high bit plane);
//     3 three-input logic operations (LOP3: three of the four char classes,
//     each masked by the row's prefix); 3 popcounts; 3 adds into the
//     counts (the fourth class follows from the prefix length) = 10, of
//     which 3 are popcounts;
//   per row (2 per call): 2 for the prefix mask of the partial word, 3 for
//     the fourth class, 8 for the four int64 checkpoint adds, 3 for the
//     sentinel's test and adjustment = 16;
//   per call: 8 for the four int64 interval sizes, 3 for the sentinel in
//     [k, k+s), 6 for l's sum of up to three int64 sizes, 2 for k' = 19.
//   Total 8 x 10 + 2 x 16 + 19 = 131 operations, 24 of them popcounts.
// On sm_90 a popcount issues at 16 per clock per SM, the others at 64:
// 132 x 16 x 1.98 GHz = 4.18 Tops/s and 16.7 Tops/s, and the four warp
// schedulers issue 128 lanes' instructions a clock.  Whether popcounts
// share the int32 pipe is not documented, so the operations bound is the
// slowest of the three (107 / 64 clocks per backward_ext and SM, the
// int32 pipe), not the sum of the two pipes.  chip_smoke.py reports
// max(bytes, operations) with the one that bounds.

#include <cuda_runtime.h>

#include "smem_group.cuh"

namespace {

constexpr int SMEM_GROUPS_PER_BLOCK = 4;

template <int G, int LCAP>
__global__ void __launch_bounds__(SMEM_GROUPS_PER_BLOCK * G)
smem_collect_kernel(const SmemBatch b, int *next) {
    extern __shared__ __align__(16) unsigned char smem_shared[];
    const SmemGroup<G> g;
    unsigned char *mem = smem_shared
                         + (threadIdx.x / G) * smem_group_bytes(LCAP);
    for (;;) {
        const int t = g.fetch_add(next);
        if (t >= b.N) break;
        smem_group_run(g, b, LCAP, b.order[t], mem);
    }
}

#define SMEM_BUCKETS(X) X(16, 160) X(32, 160) X(16, 320) X(32, 320)

// The launch's blocks (resident blocks per SM x SMs), threads and dynamic
// shared bytes per block for lanes G and list capacity lcap; a CUDA error
// code (cudaErrorInvalidValue for a bucket that does not exist).
template <int G, int LCAP>
int smem_plan_of(int *plan) {
    int dev = 0, nsm = 0, per_sm = 0;
    const int threads = SMEM_GROUPS_PER_BLOCK * G;
    const int bytes = SMEM_GROUPS_PER_BLOCK * smem_group_bytes(LCAP);
    cudaError_t err = cudaGetDevice(&dev);
    if (!err)
        err = cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount,
                                     dev);
    if (!err && bytes > 48 * 1024)
        err = cudaFuncSetAttribute(smem_collect_kernel<G, LCAP>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   bytes);
    if (!err)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, smem_collect_kernel<G, LCAP>, threads, bytes);
    if (err) return (int)err;
    plan[0] = (per_sm < 1 ? 1 : per_sm) * nsm;
    plan[1] = threads;
    plan[2] = bytes;
    return 0;
}

}  // namespace

extern "C" int smem_collect_plan(int G, int lcap, int *plan) {
#define SMEM_PLAN(GG, LL) \
    if (G == GG && lcap == LL) return smem_plan_of<GG, LL>(plan);
    SMEM_BUCKETS(SMEM_PLAN)
#undef SMEM_PLAN
    return (int)cudaErrorInvalidValue;
}

// Launch on `stream` (PyTorch's current stream); returns a CUDA error code
// (the plan's, or cudaGetLastError() of the launch; cudaErrorInvalidValue
// for a sharded index, which seeds through the per-stage kernels).  fm:
// the index as fm_occ.cuh's table (host memory).  order: int32[N], the
// reads in the order the groups take them;
// slot_off: int64[N + 1]; outputs: m, n int32 and k, s int64 of
// slot_off[N] slots, cnt int32[N], nbwd int64[N]; next: an int32 zero.
extern "C" int smem_collect_launch(
    const int64_t *fm, const int8_t *enc,
    const int *lens, const int *order, const int64_t *slot_off, int N, int L,
    int min_seed_len, int split_len, int64_t split_width,
    int64_t max_mem_intv, int G, int lcap, int32_t *out_m, int32_t *out_n,
    int64_t *out_k, int64_t *out_s, int *out_cnt, int64_t *out_nbwd,
    int *next, void *stream) {
    if (fm[0] != 1) return (int)cudaErrorInvalidValue;
    int plan[3];
    const int err = smem_collect_plan(G, lcap, plan);
    if (err) return err;
    const SmemBatch b{
        fm_view_of(fm), enc, lens, order, slot_off, N, L,
        SmemParams{min_seed_len, split_len, split_width, max_mem_intv},
        out_m, out_n, out_k, out_s, out_cnt, out_nbwd};
    const int blocks = plan[0] < (N + SMEM_GROUPS_PER_BLOCK - 1)
                                     / SMEM_GROUPS_PER_BLOCK
                           ? plan[0]
                           : (N + SMEM_GROUPS_PER_BLOCK - 1)
                                 / SMEM_GROUPS_PER_BLOCK;
    cudaStream_t st = (cudaStream_t)stream;
#define SMEM_LAUNCH(GG, LL)                                                \
    if (G == GG && lcap == LL)                                             \
        smem_collect_kernel<GG, LL><<<blocks, plan[1], plan[2], st>>>(b,   \
                                                                      next);
    SMEM_BUCKETS(SMEM_LAUNCH)
#undef SMEM_LAUNCH
    return (int)cudaGetLastError();
}

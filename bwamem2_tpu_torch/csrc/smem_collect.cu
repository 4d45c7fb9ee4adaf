// smem_collect: SMEM collection (all three rounds + the per-read sort) on
// Hopper (sm_90a), one thread per read.
//
// Replaces the JAX package's fused seeding stages (jitted XLA, not Pallas):
// bwamem2_tpu/ops/seedall.py:_stage_chain_collect, _stage_bwd_emit1,
// _stage_round (_fwd_phased, _bwd_lanes), _stage_select2, _stage_retry*,
// the merge/sort of _stage_merge_sa, and ops/smem.py:round3_replay_kernel
// and _bwd_walk.  Plain PyTorch version: bwamem2_tpu_torch/ops/seed.py:
// smem_collect_ref; wrapper: ops/seed_cuda.py.  The per-read algorithm is
// csrc/smem_collect_dp.cuh, which the tests compile as host C++.
//
// What bounds it: random 32-byte occ-row reads.  Every backward_ext reads
// two rows (k and k+s) at data-dependent places of a table far larger than
// L2 at genome scale, and each read's walk is a chain of dependent reads;
// the arithmetic per row (8 popcounts, a few selects) is small.  The bound
// chip_smoke.py reports is the bytes these inputs need: backward_ext calls
// x 2 rows x 32 B (the kernel counts its calls per read), plus the read
// grid and the output slots, over 3.35 TB/s.
//
// Design (right and simple first): one thread per read running the scalar
// rounds of the port's host oracle.  The TPU design (lockstep candidate
// grids, survivor compaction on measured schedules, tier-1/tier-2 caps)
// exists for a SIMD machine without per-lane control flow and is not
// carried over; what must match is the final (m, n, k, s) per read.  The
// candidate lists live in a global scratch laid out [2][L+1][N] so that
// neighbouring threads touch neighbouring words.  A warp runs as long as
// its slowest read, and each thread's row reads are serialised by the walk:
// later work batches the candidates of a step across a warp.

#include <cuda_runtime.h>

#include "smem_collect_dp.cuh"

namespace {

__global__ void __launch_bounds__(128)
smem_collect_kernel(FmView f, const int8_t *__restrict__ enc,
                    const int *__restrict__ lens, int N, int L,
                    SmemParams p, int cap, int32_t *sc_n, int64_t *sc_k,
                    int64_t *sc_l, int64_t *sc_s, int32_t *out_m,
                    int32_t *out_n, int64_t *out_k, int64_t *out_s,
                    int *out_cnt, int64_t *out_nbwd) {
    const int r = blockIdx.x * blockDim.x + threadIdx.x;
    if (r >= N) return;
    SmemScratch sc{sc_n + r, sc_k + r, sc_l + r, sc_s + r, (int64_t)N,
                   L + 1};
    const int64_t o0 = (int64_t)r * cap;
    SmemOut o{out_m + o0, out_n + o0, out_k + o0, out_s + o0, cap, 0, 0};
    int len = lens[r];
    len = len < 0 ? 0 : (len > L ? L : len);
    smem_collect_read(f, enc + (int64_t)r * L, len, p, sc, o);
    out_cnt[r] = o.cnt;
    out_nbwd[r] = o.nbwd;
}

}  // namespace

// Launch on `stream` (PyTorch's current stream); returns
// cudaGetLastError().  counts: int64[5] on the host.  Scratch: int32[2,
// L+1, N] + 3 x int64[2, L+1, N]; outputs [N, cap] (m, n int32; k, s
// int64), cnt int32[N], nbwd int64[N].
extern "C" int smem_collect_launch(
    const int32_t *occp, const int32_t *occ_hi, int has_hi,
    const int64_t *counts, int64_t sentinel, const int8_t *enc,
    const int *lens, int N, int L, int min_seed_len, int split_len,
    int64_t split_width, int64_t max_mem_intv, int cap, int32_t *sc_n,
    int64_t *sc_k, int64_t *sc_l, int64_t *sc_s, int32_t *out_m,
    int32_t *out_n, int64_t *out_k, int64_t *out_s, int *out_cnt,
    int64_t *out_nbwd, void *stream) {
    FmView f{occp, occ_hi, {counts[0], counts[1], counts[2], counts[3],
                            counts[4]}, sentinel, has_hi};
    SmemParams p{min_seed_len, split_len, split_width, max_mem_intv};
    const int threads = 128;
    const int blocks = (N + threads - 1) / threads;
    smem_collect_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        f, enc, lens, N, L, p, cap, sc_n, sc_k, sc_l, sc_s, out_m, out_n,
        out_k, out_s, out_cnt, out_nbwd);
    return (int)cudaGetLastError();
}

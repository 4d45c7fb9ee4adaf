// sa_resolve: suffix-array resolution of BWT positions on Hopper (sm_90a),
// one thread per position.
//
// Replaces the JAX package's SA walks (jitted XLA, not Pallas):
// bwamem2_tpu/ops/seedall.py:_sa_walk (inside _stage_merge_sa) and
// ops/salookup.py:sa_lookup_kernel.  Semantics: get_sa_entry_compressed
// (FMI_search.cpp:1103-1175), as the port's host rt_sa_entries
// (native/runtime.cpp): LF-walk until the position is a sampled slot
// (pos & 7 == 0) or the sentinel, then (sa_ms << 32) + sa_ls + steps with
// the int8 ms byte sign-extended; at the sentinel the result is the step
// count.  Plain PyTorch version: ops/seed.py:sa_resolve_ref; wrapper:
// ops/seed_cuda.py.  The walk is fm_sa_entry in csrc/fm_occ.cuh.
//
// What bounds it: one dependent random 32-byte occ-row read per LF step
// (about 8 steps per position on average, geometric tail), then a 1-byte
// and a 4-byte SA read.  chip_smoke.py's bound counts these inputs' steps
// x 32 B + 5 B per position + the 8-byte position in and the 8-byte
// coordinate out, over 3.35 TB/s.  One thread per position keeps every
// walk's row reads independent across threads, so the card has as many
// row reads in flight as it has resident threads; the latency chain within
// a walk is what remains.

#include <cuda_runtime.h>

#include "fm_occ.cuh"

namespace {

__global__ void __launch_bounds__(256)
sa_resolve_kernel(FmView f, const int8_t *__restrict__ sa_ms,
                  const uint32_t *__restrict__ sa_ls,
                  const int64_t *__restrict__ pos, int64_t P,
                  int64_t *__restrict__ out) {
    const int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
    if (i >= P) return;
    int steps;
    out[i] = fm_sa_entry(f, sa_ms, sa_ls, pos[i], &steps);
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError().  counts: int64[5] on the
// host; pos and out int64[P].
extern "C" int sa_resolve_launch(const int32_t *occp, const int32_t *occ_hi,
                                 int has_hi, const int64_t *counts,
                                 int64_t sentinel, const int8_t *sa_ms,
                                 const uint32_t *sa_ls, const int64_t *pos,
                                 int64_t P, int64_t *out, void *stream) {
    FmView f{occp, occ_hi, {counts[0], counts[1], counts[2], counts[3],
                            counts[4]}, sentinel, has_hi};
    const int threads = 256;
    const int64_t blocks = (P + threads - 1) / threads;
    sa_resolve_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
        f, sa_ms, sa_ls, pos, P, out);
    return (int)cudaGetLastError();
}

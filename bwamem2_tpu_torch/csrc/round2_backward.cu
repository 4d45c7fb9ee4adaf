// round2_backward: the backward walk of each forward candidate, one
// thread per candidate lane, on Hopper (sm_90a).
//
// Replaces the JAX package's bwamem2_tpu/ops/smem.py:
// round2_backward_kernel and round2_backward_resume_kernel (jitted XLA,
// not Pallas; both through _bwd_walk), which the per-stage seeding of the
// sharded index runs after round2_forward (ops/backend.py:
// TorchBackend._round2).  Per lane: from column x - 1 of its read, one LF
// step per column while the interval stays >= min_intv; a step below it
// kills the lane (died), column 0 or an N ends the walk.  One kernel, two
// entries: round2_backward_launch starts each lane from its pivot's
// forward candidate (k, s) = (ck, cs)[piv, slot] (a pivot at x 0 or an
// empty interval is a dead lane) and writes the alive flag too;
// round2_backward_resume_launch continues lanes from a given (col, k, s).
// Each walks at most n_steps steps: the JAX kernels run a short first
// phase and resume the survivors, the port's caller walks every lane to
// its end in one launch (n_steps = L).  Plain PyTorch versions:
// ops/smem.py:round2_backward_ref, round2_backward_resume_ref; wrapper:
// ops/smem.py:Round2Backward; the lane's body is
// seed_stages.cuh:stage_round2_backward, compiled as host C++ by the
// tests.
//
// What bounds it.  Operations: each LF step is two one-char occ counts,
// 63 int32 operations of which 8 popcounts (round1_walk.cu's model), the
// int32 pipe's 55 / 64 clocks per step and SM.  Bytes: two 32-byte occ
// rows per step (the distinct rows the plain version counts), one read
// grid byte per step, the lane's descriptor in (4 + 4 + 8 + 8 B from the
// pivot and candidate grids, 8 B of indices) and 21 B out, over 3.35 TB/s;
// over a sharded index (D - 1) / D of the rows cross NVLink (450 GB/s each
// way).
//
// Design.  One thread per lane, its walk to the end: most lanes die
// within ~24 steps, so a warp's time is its longest walk.  Instantiated
// over FmView and FmShardView as round1_chain.cu.

#include <cuda_runtime.h>

#include "seed_stages.cuh"

#define R2B_THREADS 128

namespace {

// A launch's lanes: either from the candidate grids (ck != nullptr: lane i
// is candidate slot[i] of pivot piv[i], whose read, column and min_intv
// are ridp, xp, mi at piv[i]) or resumed (ck == nullptr: lane i's read,
// column, min_intv and state are rid, x, mi, col, k, s at i).
struct R2bLanes {
    const int8_t *enc;
    int64_t NL;
    int L;
    const int *rid, *x;
    const int64_t *mi;
    const int64_t *ck, *cs;   // [P, C]
    int C;
    const int *piv, *slot;
    const int *col0;
    const int64_t *k0, *s0;
    int M, n_steps;
    int *col;
    int64_t *k, *s;
    bool *died, *alive;       // alive: nullptr on the resume entry
};

template <int SHARDED>
__global__ void __launch_bounds__(R2B_THREADS)
round2_backward_kernel(const typename FmViewOf<SHARDED>::type f,
                       const R2bLanes b) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= b.M) return;
    int p = i, col;
    int64_t k, s;
    bool alive;
    if (b.ck) {
        p = b.piv[i];
        const int64_t at = (int64_t)p * b.C + b.slot[i];
        k = b.ck[at];
        s = b.cs[at];
        col = 0;
        alive = b.x[p] > 0 && s > 0;
    } else {
        k = b.k0[i];
        s = b.s0[i];
        col = b.col0[i];
        alive = true;
    }
    bool died = false;
    int64_t steps = 0;
    alive = stage_round2_backward(f, b.enc, b.NL, b.L, b.rid[p], b.x[p],
                                  b.mi[p], alive, b.n_steps, &col, &k, &s,
                                  &died, &steps);
    b.col[i] = col;
    b.k[i] = k;
    b.s[i] = s;
    b.died[i] = died;
    if (b.alive) b.alive[i] = alive;
}

int launch(const int64_t *fm, const R2bLanes &b, void *stream) {
    if (b.M == 0) return 0;
    const unsigned blocks = (unsigned)((b.M + R2B_THREADS - 1) / R2B_THREADS);
    cudaStream_t st = (cudaStream_t)stream;
    if (fm[0] == 1)
        round2_backward_kernel<0><<<blocks, R2B_THREADS, 0, st>>>(
            fm_view_of(fm), b);
    else
        round2_backward_kernel<1><<<blocks, R2B_THREADS, 0, st>>>(
            fm_shard_view_of(fm), b);
    return (int)cudaGetLastError();
}

}  // namespace

// Lanes from the forward candidates.  Returns cudaGetLastError() of the
// launch on `stream` (PyTorch's current stream).  fm: the index as
// fm_occ.cuh's table (host memory); enc int8[N, L] (NL = N * L); ridp, xp
// int32[P], mi int64[P], ck, cs int64[P, C]; piv, slot int32[M]; out:
// col int32[M], k, s int64[M], died, alive bool[M].
extern "C" int round2_backward_launch(
        const int64_t *fm, const int8_t *enc, int64_t NL, int L,
        const int *ridp, const int *xp, const int64_t *mi,
        const int64_t *ck, const int64_t *cs, int C, const int *piv,
        const int *slot, int M, int n_steps, int *col, int64_t *k,
        int64_t *s, bool *died, bool *alive, void *stream) {
    const R2bLanes b{enc, NL, L, ridp, xp, mi, ck, cs, C, piv, slot,
                     nullptr, nullptr, nullptr, M, n_steps, col, k, s, died,
                     alive};
    return launch(fm, b, stream);
}

// Lanes resumed from (col0, k0, s0), lane i of read rid[i] at pivot
// column x[i] with min_intv mi[i] (all [M]); out as above without alive.
extern "C" int round2_backward_resume_launch(
        const int64_t *fm, const int8_t *enc, int64_t NL, int L,
        const int *rid, const int *x, const int64_t *mi, const int *col0,
        const int64_t *k0, const int64_t *s0, int M, int n_steps, int *col,
        int64_t *k, int64_t *s, bool *died, void *stream) {
    const R2bLanes b{enc, NL, L, rid, x, mi, nullptr, nullptr, 0, nullptr,
                     nullptr, col0, k0, s0, M, n_steps, col, k, s, died,
                     nullptr};
    return launch(fm, b, stream);
}

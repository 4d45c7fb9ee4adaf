// kswv: batched two-phase mate-rescue Smith-Waterman on Hopper (sm_90a).
//
// Replaces the TPU device stage bwamem2_tpu/ops/kswv.py:kswv_two_phase
// (:303) and its phase body _kswv_phase (:76), jitted XLA reached through
// DeviceKswv.align_batch.  Plain PyTorch version:
// bwamem2_tpu_torch/ops/kswv.py:kswv_two_phase_ref; wrapper and build:
// bwamem2_tpu_torch/ops/kswv_cuda.py.
//
// Contract: P rescue problems of one precision class (u8: 16 lanes, biased,
// saturating; i16: 8 lanes) given by descriptors: query codes from the
// chunk's int8[N, L] read grid (qoff = flat row*L+col, qdir = +-1, qcomp:
// complement codes < 4), target codes from the uint8 doubled genome (int64
// toff, tlen bases forward; 2-bit packed when ref_packed).  Output int32[2,
// P, 6]: phase 0 and phase 1 rows of (score, te, qe, score2, te2,
// saturated).  Every problem must have qlen <= Qmax (a multiple of 16) and
// tlen <= Tmax; the kernel clamps to keep a broken descriptor inside the
// scratch.  There is no length cap: the wrapper sizes the scratch per
// launch from the batch's longest query and window.  The i16 class needs
// Qmax * a <= 32767 (row maxima are int16, where the native kernel
// saturates).
//
// Design (right and simple first): one thread per problem, running the
// scalar striped emulation of kswv_dp.cuh for both phases back to back, so
// phase 1's descriptors never leave the thread.  The stripes H0, H1, E and
// Hmax live in a wrapper-allocated global scratch laid out [4][Qmax][P]
// and the per-row maxima in int16[Tmax][P] (the b-array is replayed from
// them once te is known), so neighbouring threads at the same cell touch
// neighbouring words, as bsw_extend's [Qmax+1][P] scratch does.  One
// thread per problem keeps the lane-exact semantics in one place that the
// host tests compile; its cost is that a warp runs as long as its longest
// problem and each cell's loads wait on the scratch.  A half-warp per
// problem, its 16 lanes the 16 SIMD lanes of the striped register
// (__shfl_up_sync for the lane shift, __all_sync for the lazy-F exit), is
// the redesign for speed.
//
// What bounds it: integer DP.  The bound counts the least int32 operations
// the recurrence needs per striped cell, not this kernel's instruction mix:
// a precomputed query profile (as the native ksw_align builds, qpad x 5
// entries, negligible beside the cells), H/E/F held in registers, and
// sm_90's DPX instructions where one fuses two operations
// (__viaddmax_s32: max(a + b, c); __vimax3_s32: max(a, b, c)).
//   u8 main-pass cell (10):  1 profile load; 1 add of the diagonal H and
//     the biased score; 1 min with 255 (saturate); 1 fused subtract of the
//     bias with max 0; 1 three-way max of H, E, F; 1 running row max;
//     2 for E' = max(max(E - e_del, 0), H - oe_del) (two fused add-max);
//     2 for F' likewise.
//   i16 main-pass cell (8):  1 profile load; 1 add of diagonal H and score
//     (no bias, no saturation); 1 three-way max; 1 row max; 2 for E'; 2 for
//     F'.
//   lazy-F cell, both classes (4):  1 max of H and F; 2 fused add-max
//     (H - oe_ins and F - e_ins, each floored at 0); 1 compare for the
//     sweep's exit vote.  Every row runs at least one segment (NL cells).
// The per-byte SIMD video intrinsics (__vaddus4, __vmaxu4) are not counted
// as one operation for four cells: on sm_90 they compile to several
// instructions.  Cells are qpad = NL * slen per row, over the rows each
// phase runs (both phases), counted from the inputs by kswv_two_phase_ref's
// `work`.  The card's INT32 issue rate is 132 SMs x 64 lanes x 1.98 GHz =
// 16.7 Tops/s, a DPX instruction counted at that rate.  The bytes it must
// move are the descriptors (25 B per problem), the query and target codes
// (qlen + tlen bytes) and 2 x 6 int32 out, at 3.35 TB/s, so operations
// bound it.  chip_smoke.py reports that bound beside the time.

#include <cuda_runtime.h>

#include "kswv_dp.cuh"

namespace {

template <int NL, bool U8>
__global__ void __launch_bounds__(64)
kswv_kernel(const int8_t *__restrict__ enc, int64_t n_enc,
            const uint8_t *__restrict__ ref, int64_t n_ref, int ref_packed,
            const int *__restrict__ qoff, const int *__restrict__ qdir,
            const uint8_t *__restrict__ qcomp, const int *__restrict__ qlen,
            const int64_t *__restrict__ toff, const int *__restrict__ tlen,
            int P, int Qmax, int Tmax, int minsc, KswvParams sp,
            int *__restrict__ scratch, int16_t *__restrict__ rowmax,
            int *__restrict__ out) {
    const int p = blockIdx.x * blockDim.x + threadIdx.x;
    if (p >= P) return;
    const int64_t plane = (int64_t)Qmax * P;
    KswvScratch s{scratch + p, scratch + plane + p, scratch + 2 * plane + p,
                  scratch + 3 * plane + p, rowmax + p, P};
    kswv_problem<NL, U8>(enc, n_enc, ref, n_ref, ref_packed, qoff[p], qdir[p],
                         qcomp[p], qlen[p], toff[p], tlen[p], minsc, sp,
                         Qmax, Tmax, s, out + (int64_t)p * 6,
                         out + ((int64_t)P + p) * 6);
}

}  // namespace

// Launch on `stream` (PyTorch's current stream); returns cudaGetLastError()
// so the wrapper can raise on a refused launch.  u8 selects the class.
// scratch: int32[4, Qmax, P]; rowmax: int16[Tmax, P]; out: int32[2, P, 6].
extern "C" int kswv_launch(const int8_t *enc, int64_t n_enc,
                           const uint8_t *ref, int64_t n_ref, int ref_packed,
                           const int *qoff, const int *qdir,
                           const uint8_t *qcomp, const int *qlen,
                           const int64_t *toff, const int *tlen, int P,
                           int Qmax, int Tmax, int u8, int minsc, int a,
                           int b, int o_del, int e_del, int o_ins, int e_ins,
                           int *scratch, int16_t *rowmax, int *out,
                           void *stream) {
    const KswvParams sp{a, b, o_del, e_del, o_ins, e_ins};
    const int threads = 64;
    const int blocks = (P + threads - 1) / threads;
    cudaStream_t st = (cudaStream_t)stream;
    if (u8)
        kswv_kernel<16, true><<<blocks, threads, 0, st>>>(
            enc, n_enc, ref, n_ref, ref_packed, qoff, qdir, qcomp, qlen, toff,
            tlen, P, Qmax, Tmax, minsc, sp, scratch, rowmax, out);
    else
        kswv_kernel<8, false><<<blocks, threads, 0, st>>>(
            enc, n_enc, ref, n_ref, ref_packed, qoff, qdir, qcomp, qlen, toff,
            tlen, P, Qmax, Tmax, minsc, sp, scratch, rowmax, out);
    return (int)cudaGetLastError();
}

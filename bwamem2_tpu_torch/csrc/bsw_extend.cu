// bsw_extend: banded Smith-Waterman seed extension on Hopper (sm_90a).
//
// Replaces the TPU kernel bwamem2_tpu/ops/bsw_pallas.py:_mk_kernel (launched
// by _call, production entry bsw_desc_pallas) and its XLA twin
// bwamem2_tpu/ops/bsw.py:bsw_desc_kernel.  Plain PyTorch version:
// bwamem2_tpu_torch/ops/bsw.py:bsw_desc_ref; wrapper and build:
// bwamem2_tpu_torch/ops/bsw_cuda.py.
//
// Contract: P extension problems given by descriptors.  Query codes are
// gathered from the chunk's int8[N, L] read grid (qoff = flat row*L+col,
// qdir = +-1), target codes from the uint8 doubled genome (int64 toff,
// tdir = +-1; 2-bit packed when ref_packed), so no sequence tile is ever
// materialized.  Output int32[P, 6]: score qle tle gtle gscore max_off.
//
// Design (right and simple first): one thread per pair — the reference's
// own SIMD strategy of one SeqPair per lane (bandedSWA.cpp:1997-2126) —
// running the scalar ksw_extend2 row loop of bsw_extend_dp.cuh.  Each
// thread stops at its own band, z-drop or row-max == 0, which is the
// Pallas kernel's 16-row "any lane alive" early exit at the granularity of
// one lane.  The H and E rows live in a wrapper-allocated global scratch
// laid out [Qmax+1][P] (column-major over pairs), so neighbouring threads
// at the same column touch neighbouring words; for P = 4096, Qmax = 383 the
// scratch is 12.6 MB and stays in the 50 MB L2.  The TPU layout (pairs on
// the 128 VPU lanes, DP columns on sublanes, roll-based cummax, int16 tier)
// is not carried over: it exists for the TPU's vector unit.
//
// What bounds it: integer DP.  Per band cell the loop does about 24 int32
// operations (score select, three max/relu pairs, tie-break, the shifted
// H store) besides 3 loads and 2 stores; the band covers ~2w+1 <= 201
// columns per row.  The card's INT32 issue rate is 132 SMs x 64 INT32
// lanes x 1.98 GHz = 16.7 Tops/s (a quarter of the 67 TFLOP/s float32 FMA
// peak), against 3.35 TB/s for the ~36 B of descriptors + qlen + tlen code
// bytes in and 24 B out per pair, so the operation count bounds it by two
// orders of magnitude.  chip_smoke.py counts the cells these inputs
// actually compute (bsw_desc_ref's `cells`) and reports that bound beside
// the measured time.  One thread per pair leaves the work exposed to warp
// divergence on mixed lengths (a warp runs as long as its longest pair)
// and to the scratch's L1/L2 latency: later work sorts pairs by length
// and keeps the band in registers/shared memory.

#include <cuda_runtime.h>

#include "bsw_extend_dp.cuh"

namespace {

__global__ void __launch_bounds__(128)
bsw_extend_kernel(const int8_t *__restrict__ enc, int64_t n_enc,
                  const uint8_t *__restrict__ ref, int64_t n_ref,
                  int ref_packed, const int *__restrict__ qoff,
                  const int *__restrict__ qdir, const int *__restrict__ qlen,
                  const int64_t *__restrict__ toff,
                  const int *__restrict__ tdir, const int *__restrict__ tlen,
                  const int *__restrict__ h0, const int *__restrict__ w,
                  int P, int Qmax, BswParams sp, int *__restrict__ scratch,
                  int *__restrict__ out) {
    const int p = blockIdx.x * blockDim.x + threadIdx.x;
    if (p >= P) return;
    int *H = scratch + p;
    int *E = scratch + (int64_t)(Qmax + 1) * P + p;
    // qlen <= Qmax is the caller's contract (ops/bsw.py:t_classes); the
    // clamp only keeps a broken descriptor inside the scratch
    const int ql = qlen[p] < Qmax ? qlen[p] : Qmax;
    bsw_pair(enc, n_enc, ref, n_ref, ref_packed, qoff[p], qdir[p], ql,
             toff[p], tdir[p], tlen[p], h0[p], w[p], sp, H, E, P,
             out + (int64_t)p * 6);
}

}  // namespace

// Launch on `stream` (PyTorch's current stream); returns cudaGetLastError()
// so the wrapper can raise on a refused launch.  scratch: int32[2, Qmax+1,
// P]; out: int32[P, 6].  Every pair must have qlen <= Qmax.
extern "C" int bsw_extend_launch(
    const int8_t *enc, int64_t n_enc, const uint8_t *ref, int64_t n_ref,
    int ref_packed, const int *qoff, const int *qdir, const int *qlen,
    const int64_t *toff, const int *tdir, const int *tlen, const int *h0,
    const int *w, int P, int Qmax, int a, int b, int o_del, int e_del,
    int o_ins, int e_ins, int zdrop, int end_bonus, int max_sc, int *scratch,
    int *out, void *stream) {
    BswParams sp{a, b, o_del, e_del, o_ins, e_ins, zdrop, end_bonus, max_sc};
    const int threads = 128;
    const int blocks = (P + threads - 1) / threads;
    bsw_extend_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        enc, n_enc, ref, n_ref, ref_packed, qoff, qdir, qlen, toff, tdir,
        tlen, h0, w, P, Qmax, sp, scratch, out);
    return (int)cudaGetLastError();
}

// row_gather: out[i, :] = tab[idx[i], :] on Hopper (sm_90a).
//
// Replaces the TPU kernel tools/gather_scale_probe.py:pallas_gather (the
// pl.pallas_call there: per-row async HBM -> VMEM copies, K = 8 in flight
// per block of 2048 rows).  It is the occ-row fetch of every LF step,
// measured alone: random rows of a table that stays in device memory.
// Plain PyTorch version: tab[idx] (ops/row_gather.py:row_gather_ref).
//
// What bounds it: bytes.  Each distinct row of the P indexed is read once,
// the P rows of W int32 are written once, plus 4 B of index per row; the
// bound is ((distinct + P) W 4 + 4 P) B over 3.35 TB/s (a table smaller
// than the rows gathered is read whole, once).  A random row of 32 or 64 B
// touches one or two 32-byte
// sectors, so the achieved rate depends on the row width and on whether
// the table fits the 50 MB L2.
//
// Design: each thread moves one 16-byte vector of one row (W/4 threads per
// row, neighbouring threads on neighbouring vectors of the same row), so a
// warp issues 32 independent 16-byte loads and coalesced 512-byte stores.
// The TPU kernel's explicit copy ring (K copies in flight, semaphores) is
// what the card's warp scheduler does by itself: every resident warp keeps
// its loads in flight.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void __launch_bounds__(256)
row_gather_kernel(const int4 *__restrict__ tab, const int *__restrict__ idx,
                  int4 *__restrict__ out, int64_t total, int V) {
    const int64_t t = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
    if (t >= total) return;
    const int64_t i = t / V;
    const int v = (int)(t - i * V);
    out[t] = __ldg(tab + (int64_t)__ldg(idx + i) * V + v);
}

}  // namespace

// tab: int32[nrows, W] with W % 4 == 0, 16-byte aligned; idx int32[P];
// out int32[P, W].  Returns cudaGetLastError().
extern "C" int row_gather_launch(const int32_t *tab, const int32_t *idx,
                                 int64_t P, int W, int32_t *out,
                                 void *stream) {
    const int V = W / 4;
    const int64_t total = P * V;
    const int threads = 256;
    const int64_t blocks = (total + threads - 1) / threads;
    row_gather_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
        reinterpret_cast<const int4 *>(tab), idx,
        reinterpret_cast<int4 *>(out), total, V);
    return (int)cudaGetLastError();
}

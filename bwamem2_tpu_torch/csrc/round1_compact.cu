// round1_compact: the legacy round 1 of SMEM seeding on Hopper (sm_90a):
// the per-end backward walk of every read column, the SMEM emission rule
// and the per-read compaction in one launch.
//
// Replaces the JAX package's bwamem2_tpu/ops/smem.py:round1_compact_kernel
// (jitted XLA, not Pallas; the round 1 of DeviceBackend(pivot_seeding=
// False)), reached here from ops/backend.py:TorchBackend.collect_smems
// when the backend is built with pivot_seeding=False.  With the K-mer
// table (index/klut.py, use_klut) a lane whose last K bases are clean
// starts from their interval instead of K LF steps (fm_occ.cuh:
// fm_round1_walk_lut, the LUT instantiation); without it (K = 0) every
// lane walks from scratch.  Plain PyTorch version: ops/smem.py:
// round1_compact_ref; wrapper: ops/smem.py:Round1Compact.  The read's body
// is round1_compact.cuh:r1c_read, which the tests compile as host C++.
//
// Output per read: the true emit count (more than cap routes the read to
// the host oracle) and cap slots n, b (int32), s (int32, clamped to
// 2^31 - 1), k (int64) in ascending end column, n = b = -1 and s = k = 0
// past the count.  The (N, L) walk results never leave the chip.
//
// What bounds it.  Operations: the model of round1_walk.cu's header, by
// step class: 63 int32 operations for an s > 1 step whose ends lie in two
// blocks, 52 in one block, 39 at s = 1 where the interval extends, 13
// where an s = 1 step empties it (8, 8, 4 and 0 of them popcounts), the
// int32 pipe's share bounding at 64 a clock per SM (16.7 Tops/s on 132
// SMs at 1.98 GHz), counted over the LF steps round1_compact_ref's `stats`
// reports: the steps these reads need, with the LUT start where it
// applies (a lane the table starts takes up to K steps fewer, plus K code
// loads and one table read, not counted).  Bytes: the distinct occ rows
// the walks read (32 B, 36 with the count-hi plane), the read grid (1 B
// per column) and lengths in, the table entries the lanes read (16 B
// each, counted as distinct codes would be: not counted, a floor), and
// the compaction's output: 4 B of count and cap x 20 B of slots per read.
// chip_smoke.py reports the larger of the two, and the bound of 63
// operations every step beside it.
//
// Design.  One warp per read (smem_group.cuh:SmemGroup<32>): the read's
// columns 32 at a time, one lane a column, each lane walking until its
// interval empties; a warp runs each pass as long as its longest walk.
// The lane's walk is round1_walk's (fm_occ.cuh:fm_round1_walk_lut: one
// row and one count at s = 1, the count-hi plane in a body of its own),
// and takes the same fewer instructions a step.
// b(n + 1) comes from the next lane by a shuffle, the pass's last column
// waits for the next pass's first (round1_compact.cuh), and the slots go
// by a ballot and a prefix popcount in column order, so the per-read
// argsort of the JAX version is not needed.  Nothing is indexed at run
// time in registers, so no stack frame.  Over the replicated index only:
// the sharded index seeds through the pivot chain (as the JAX package's
// mesh mode asserts), and the launcher refuses a sharded table.

#include <cuda_runtime.h>

#include "round1_compact.cuh"

#define R1X_THREADS 256

namespace {

template <bool LUT>
// one block an SM at least (.minnctapersm 1): without it ptxas held the
// walk to 40 registers, and round1_compact<noLUT> spilled
__global__ void __launch_bounds__(R1X_THREADS, 1)
round1_compact_kernel(const FmView f, const FmLut lut,
                      const int8_t *__restrict__ enc,
                      const int *__restrict__ lens, int N, int L,
                      int min_len, int cap, int *__restrict__ cnt,
                      int *__restrict__ on, int *__restrict__ ob,
                      int *__restrict__ os, int64_t *__restrict__ ok) {
    const int r = blockIdx.x * (R1X_THREADS / 32) + (threadIdx.x >> 5);
    if (r >= N) return;     // the whole warp returns
    const SmemGroup<32> g;
    const int len0 = __ldg(lens + r), len = len0 < L ? len0 : L;
    const int64_t o = (int64_t)r * cap;
    const int c = r1c_read<LUT>(g, f, lut, enc + (int64_t)r * L, len,
                                min_len, cap, on + o, ob + o, os + o,
                                ok + o);
    if (g.leader()) cnt[r] = c;
}

}  // namespace

// Launch on `stream` (PyTorch's current stream); returns
// cudaGetLastError() of the launch, or cudaErrorInvalidValue for a
// sharded index or a K the index's table does not have.  fm: the index as
// fm_occ.cuh's table (host memory); enc int8[N, L] (codes 0..4), lens
// int32[N]; K the table depth to start from (0: walk from scratch); cnt
// int32[N]; on, ob, os int32[N, cap], ok int64[N, cap].
extern "C" int round1_compact_launch(const int64_t *fm, const int8_t *enc,
                                     const int *lens, int N, int L,
                                     int min_len, int cap, int K, int *cnt,
                                     int *on, int *ob, int *os, int64_t *ok,
                                     void *stream) {
    const FmLut lut = fm_lut_of(fm);
    if (fm[0] != 1 || (K && (K != lut.K || !lut.start || !lut.size)))
        return (int)cudaErrorInvalidValue;
    const int per = R1X_THREADS / 32;
    const unsigned blocks = (unsigned)((N + per - 1) / per);
    cudaStream_t st = (cudaStream_t)stream;
    if (K)
        round1_compact_kernel<true><<<blocks, R1X_THREADS, 0, st>>>(
            fm_view_of(fm), lut, enc, lens, N, L, min_len, cap, cnt, on, ob,
            os, ok);
    else
        round1_compact_kernel<false><<<blocks, R1X_THREADS, 0, st>>>(
            fm_view_of(fm), lut, enc, lens, N, L, min_len, cap, cnt, on, ob,
            os, ok);
    return (int)cudaGetLastError();
}

// round1_walk: the round-1 SMEM backward walk from every (read, end) lane
// on Hopper (sm_90a).
//
// Replaces the JAX package's round-1 walk (jitted XLA, not Pallas):
// bwamem2_tpu/ops/smem.py:round1_kernel / _round1_walk at lut_k = 0, the
// first stage of ops/entry.py:seed_extend_step.  For every end column n of
// every read, one lane walks the FM index backward from n until the
// interval empties, the column passes 0 or a code is not a base, and
// writes the leftmost start b(n) (int32) and the interval (k, s) (int64)
// of [b(n), n].  Plain PyTorch version: ops/smem.py:round1_walk_ref;
// wrapper: ops/smem.py:Round1Walk.  The lane's walk is
// fm_occ.cuh:fm_round1_walk, which the tests compile as host C++.
//
// What bounds it.  Bytes: 20 B written per lane (b, k, s), the read grid
// (1 B per lane) and lengths read once, and the occ rows the walks touch,
// each 32-byte row once, over 3.35 TB/s.  Operations, by the class of the
// LF step (the plain version's `stats` counts each):
//   two rows (s > 1, the ends k and k + s in two blocks): two occ counts
//     of one base.  The least int32 work of a count is, per code word (4
//     per row), an XOR with the base's pattern, a shift, one three-input
//     logic operation (the pair test masked by the row's prefix), a
//     popcount and an add = 5, of which 1 popcount; per row 2 for the
//     prefix mask of the partial word, 2 for the int64 checkpoint add and
//     3 for the sentinel's test and adjustment = 7; so 2 x (4 x 5 + 7) =
//     54, plus 2 for k' = C[a] + occ, 2 for s', 1 for s' > 0, 2 for k + s
//     and 2 for the next code's test and load = 63, 8 of them popcounts
//     (the model of every step before the one-row step);
//   one block (s > 1, both ends in one block): the first count, 27; the
//     second end on the same row shares each word's XOR and shift: per
//     word a masked pair test, a popcount and an add = 12, plus 2 for its
//     prefix mask and 3 for its sentinel test = 17; s' is the two counts'
//     difference in int32 (the checkpoint cancels) = 1; plus 2 (k'), 1
//     (s' > 0), 2 (k + s) and 2 (next code) = 52, 8 popcounts;
//   s = 1 (one BWT position), the interval extended: one count, 27; s' =
//     [char k == a] less the sentinel: the code word by two selects, a
//     shift, a mask, the compare with a, the int64 compare of k with the
//     sentinel and an and (s' as a predicate, no further test) = 8; plus
//     2 (k') and 2 (next code) = 39, 4 popcounts;
//   s = 1, the step that empties the interval: the test above, 8, and the
//     code's place in k's row that a counting step takes from its prefix
//     mask (y = k & 63 and the shift 2 (y & 15)) = 3, plus 2 (this step's
//     code) = 13, no popcount: no count and no k' (a lane's last step).
// On sm_90 a popcount issues at 16 per clock per SM (4.18 Tops/s on 132
// SMs at 1.98 GHz), the other int32 operations at 64 (16.7 Tops/s), and
// the four warp schedulers issue 128 lanes' instructions a clock (33.4
// Tops/s).  Whether popcounts share the int32 pipe is not documented, so
// the operations bound is the slowest of the three, not the sum of the
// two pipes: the int32 pipe.  chip_smoke.py counts the steps by class and
// the distinct rows of each run's walks (round1_walk_ref's `stats`) and
// reports the larger bound, with the 63-operation bound of every step
// beside it.
//
// Design.  One thread per lane, lanes of a read in neighbouring threads,
// so a warp reads neighbouring grid bytes and each lane stops on its own.
// The TPU version steps all L lanes of a read in lockstep for L steps
// (dropping a quarter of the columns at a time) because its loop cannot
// end early per lane; here a lane ends when its walk does, and what that
// costs is warp divergence: a warp runs as long as its longest walk.  The
// kernel issues instructions for longer than a step's L2 round trips
// last (48 resident warps an SM, ~200 SASS instructions a step in the
// two-count form), so the walk (fm_occ.cuh:fm_round1_walk_lut) is written
// for fewer instructions: three steps in four are at s = 1, where
// fm_walk_single reads one row, tests the code at k and counts only when
// it matches, so the step that empties the interval forms no k'; a code
// word's prefix mask is one funnel shift; C[a] and the checkpoint are
// picked by two selects on a's bits; the count-hi plane's loads and
// shifts are compiled into a second body that runs only over an index
// that has one.  At s > 1 (fm_walk_step) the second row is loaded beside
// the first even when both ends share a block: skipping it split warps
// and ran slower (PERF.md).  Lanes in column-major order (a warp on one
// column of 32 reads) ran slower with this walk.
// Counts and row words are picked by selects (fm_occ.cuh), so nothing is
// indexed at run time and the kernel needs no stack frame.  A second
// instantiation reads the index through FmShardView (the occ rows split
// by row range over cards, fm_occ.cuh); the launcher takes the index as
// fm_occ.cuh's table and picks the instantiation from its shard count.

#include <cuda_runtime.h>

#include "fm_occ.cuh"

#define R1_THREADS 256

namespace {

template <int SHARDED>
// one block an SM at least (.minnctapersm 1): without it ptxas held the
// walk to 40 registers, and round1_compact<noLUT> spilled
__global__ void __launch_bounds__(R1_THREADS, 1)
round1_walk_kernel(const typename FmViewOf<SHARDED>::type f,
                   const int8_t *__restrict__ enc,
                   const int *__restrict__ lens, int64_t total, int L,
                   int *__restrict__ b, int64_t *__restrict__ k,
                   int64_t *__restrict__ s) {
    const int64_t t = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
    if (t >= total) return;
    const int64_t r = t / L;
    const int n = (int)(t - r * L);
    int bo;
    int64_t ko, so;
    fm_round1_walk(f, enc + r * L, __ldg(lens + r), n, &bo, &ko, &so);
    b[t] = bo;
    k[t] = ko;
    s[t] = so;
}

}  // namespace

// Launch on `stream` (PyTorch's current stream); returns
// cudaGetLastError() of the launch.  fm: the index as fm_occ.cuh's table
// (host memory); enc int8[N, L] (codes 0..4), lens int32[N]; b int32[N,
// L], k and s int64[N, L].
extern "C" int round1_walk_launch(const int64_t *fm, const int8_t *enc,
                                  const int *lens, int N, int L, int *b,
                                  int64_t *k, int64_t *s, void *stream) {
    const int64_t total = (int64_t)N * L;
    const unsigned blocks = (unsigned)((total + R1_THREADS - 1) / R1_THREADS);
    cudaStream_t st = (cudaStream_t)stream;
    if (fm[0] == 1)
        round1_walk_kernel<0><<<blocks, R1_THREADS, 0, st>>>(
            fm_view_of(fm), enc, lens, total, L, b, k, s);
    else
        round1_walk_kernel<1><<<blocks, R1_THREADS, 0, st>>>(
            fm_shard_view_of(fm), enc, lens, total, L, b, k, s);
    return (int)cudaGetLastError();
}

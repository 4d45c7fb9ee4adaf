// Scoring parameters of the banded extension and the doubled-genome
// accessor, shared by the bsw_extend kernel's group body (bsw_group.cuh) and
// the kswv kernel's (kswv_group.cuh).
//
// Plain C++ when BSW_HD is defined (e.g. `static inline`) before this
// header, so the host tests compile it with g++.

#pragma once

#include <stdint.h>

#ifndef BSW_HD
#ifdef __CUDACC__
#define BSW_HD __host__ __device__ __forceinline__
#else
#define BSW_HD static inline
#endif
#endif

struct BswParams {
    int a, b, o_del, e_del, o_ins, e_ins, zdrop, end_bonus, max_sc;
};

// Doubled-genome char at pos (ops/device_index.py:take_ref): clipped when
// unpacked; 4 chars per byte, LSB first, when packed.
BSW_HD int bsw_ref_at(const uint8_t *ref, int64_t n_ref, int packed,
                      int64_t pos) {
    if (!packed) {
        pos = pos < 0 ? 0 : (pos > n_ref - 1 ? n_ref - 1 : pos);
        return ref[pos];
    }
    int64_t b = pos >> 2;
    b = b < 0 ? 0 : (b > n_ref - 1 ? n_ref - 1 : b);
    return (ref[b] >> ((int)(pos & 3) * 2)) & 3;
}

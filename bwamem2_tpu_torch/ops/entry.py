"""The fused seed-and-extend step: round-1 walks, the SA resolution of each
read's longest SMEM, one right extension of it.

The counterpart of bwamem2_tpu/ops/entry.py:seed_extend_step, which the
JAX package compile-checks and shards over a data axis
(parallel/mesh.py:sharded_seed_extend).  The production pipeline calls the
same kernels with host work between the stages (ops/backend.py).  Each
stage is a wrapper: its kernel on CUDA tensors, its plain version on the
CPU.

  1. round1_walk (csrc/round1_walk.cu) from every (read, end) lane;
  2. the longest SMEM of each read (the first end column at the maximum,
     as jnp.argmax), its first occurrence resolved by sa_resolve
     (csrc/sa_resolve.cu);
  3. the query after the seed (QER_WIN columns) and the genome after its
     occurrence (REF_WIN chars) cut out as tiles and extended by
     bsw_tiles (csrc/bsw_extend.cu) with w = 100 and end bonus 5.

Two differences from the JAX step, both where it reads past what it has:
the genome window is read through take_ref, so a 2-bit packed genome
(2^31 doubled chars or more) is read right where the JAX step slices the
packed bytes; and the query length is cut to the QER_WIN-column tile,
where the JAX step passes the untrimmed rest of the read (more than the
tile holds for reads longer than QER_WIN + 1).  For reads of at most
QER_WIN + 1 bases on an unpacked genome the outputs are the JAX step's.
"""

from __future__ import annotations

import torch

from .bsw import bsw_tiles
from .device_index import DeviceFMIndex, take_ref
from .seed import sa_resolve
from .smem import round1_walk

REF_WIN = 256   # extension window on the reference
QER_WIN = 128
BAND_W = 100
END_BONUS = 5


def seed_extend_step(dfm: DeviceFMIndex, enc, lens, a: int = 1, b: int = 4,
                     o_del: int = 6, e_del: int = 1, o_ins: int = 6,
                     e_ins: int = 1, zdrop: int = 100):
    """enc int[N, L] nt4 codes (4 = N or padding), lens int[N], on any
    device or numpy; they are carried to the index's device.

    Returns (smem_b int32[N, L], smem_k int64[N, L], smem_s int64[N, L],
    coords int64[N], ext_scores int32[N, 6]) on the index's device: the
    round-1 walk of every lane, the coordinate of each read's longest
    SMEM, and the right extension of that seed."""
    dev = dfm.device
    enc = torch.as_tensor(enc).to(dev, torch.int8).contiguous()
    lens = torch.as_tensor(lens).to(dev, torch.int32).contiguous()
    N, L = enc.shape
    pos = torch.arange(L, dtype=torch.int32, device=dev)[None, :]

    # stage 1: SMEM walks
    bcol, k, s = round1_walk(dfm, enc, lens)
    length = torch.where(pos < lens[:, None], pos - bcol + 1, 0)

    # the longest SMEM of each read: its first end column at the maximum
    best_len = length.max(1).values
    best_n = torch.where(length == best_len[:, None], pos, L).min(1).values
    best_k = k.gather(1, best_n[:, None].long())[:, 0].contiguous()

    # stage 2: SA resolution of the first occurrence
    coords = sa_resolve(dfm, best_k)

    # stage 3: right extension from the seed end
    qstart = torch.minimum(best_n + 1, lens)
    qlen = (lens - qstart).clamp(0, QER_WIN)
    rstart = (coords + best_len).clamp(0, dfm.n_ref - 1)
    tlen = (dfm.n_ref - rstart).clamp(max=REF_WIN).to(torch.int32)
    qpos = qstart[:, None].long() + torch.arange(QER_WIN, device=dev)
    qer = torch.where(qpos < L, enc.gather(1, qpos.clamp(max=L - 1)), 4)
    tpos = rstart[:, None] + torch.arange(REF_WIN, device=dev)
    ref = torch.where(tpos < dfm.n_ref,
                      take_ref(dfm.ref, tpos, dfm.ref_packed), 4)
    h0 = best_len * a
    w = torch.full((N,), BAND_W, dtype=torch.int32, device=dev)
    ext = bsw_tiles(qer, ref, qlen, tlen, h0, w, a, b, o_del, e_del, o_ins,
                    e_ins, zdrop, END_BONUS, a)
    return bcol, k, s, coords, ext

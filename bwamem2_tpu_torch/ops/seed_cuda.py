"""ctypes bindings of the seeding kernels: csrc/smem_collect.cu (with
csrc/smem_group.cuh) and csrc/sa_resolve.cu (built by ops/cuda_build.py),
and the index table every seeding and SA launcher takes (fm_table).

Each class is a wrapper: on CPU tensors it runs the plain PyTorch version
it was given (ops/seed.py), on CUDA tensors it launches the kernel or
raises — it never falls back.  `launches` and `plain_calls` count the two.
"""

from __future__ import annotations

import ctypes

import torch

from .cuda_build import I32, I64, VP, CudaKernel, check_tensors


MAX_SHARDS = 8      # csrc/fm_occ.cuh:FM_MAX_SHARDS
FM_TAB_LEN = 45     # csrc/fm_occ.cuh:FM_TAB_LEN


def fm_table(dfm) -> ctypes.Array:
    """The index as the seeding and SA launchers take it (csrc/fm_occ.cuh:
    fm_view_of, fm_shard_view_of), a host int64 array: [shards, has_hi,
    sentinel, counts[5], occ rows per shard, SA slots per shard, occp[8],
    occ_hi[8], sa_ms[8], sa_ls[8], lut_start, lut_size, lut_depth] (device
    pointers; 0 where unused).  The replicated index is one shard; only a
    replicated index carries a K-mer table (fm_occ.cuh:fm_lut_of).  Built
    once per index (the counts and sentinel are read from the device
    then)."""
    tab = getattr(dfm, "_fm_table", None)
    if tab is not None:
        return tab
    counts, sentinel = dfm.counts.cpu().tolist(), int(dfm.sentinel)
    sh = dfm.shards
    if sh is None:
        n, rows, sa_rows = 1, dfm.occp.shape[0], dfm.sa_ms.shape[0]
        lists = ([dfm.occp], [dfm.occ_hi] if dfm.has_hi else [],
                 [dfm.sa_ms], [dfm.sa_ls])
    else:
        n, rows, sa_rows = len(sh.occp), sh.rows, sh.sa_rows
        lists = (sh.occp, sh.occ_hi or [], sh.sa_ms, sh.sa_ls)
    if n > MAX_SHARDS or rows >= 1 << 32 or sa_rows >= 1 << 32:
        raise ValueError(f"index of {n} shards of {rows} occ rows and "
                         f"{sa_rows} SA slots: the kernels take at most "
                         f"{MAX_SHARDS} shards of fewer than 2^32")
    ptrs = []
    for lst in lists:
        p = [t.data_ptr() for t in lst]
        ptrs += p + [0] * (MAX_SHARDS - len(p))
    lut = ([dfm.lut_start.data_ptr(), dfm.lut_size.data_ptr(),
            dfm.lut_depth] if dfm.lut_start is not None else [0, 0, 0])
    tab = (I64 * FM_TAB_LEN)(n, int(dfm.has_hi), sentinel, *counts, rows,
                             sa_rows, *ptrs, *lut)
    dfm._fm_table = tab
    return tab


def _check_index(kernel: str, dfm, dev) -> None:
    """Raise unless the index's occ tables are int32 rows of 8 words
    aligned to 16 bytes, on `dev` (the replicated index) or each on a
    card (a sharded one: shards may lie on other cards)."""
    sh = dfm.shards
    if sh is None:
        check_tensors(kernel, dev, occp=(dfm.occp, torch.int32, 2),
                      occ_hi=(dfm.occ_hi, torch.int32, 1))
        tabs = [dfm.occp]
    else:
        tabs = list(sh.occp)
        for i, t in enumerate(sh.occp + (sh.occ_hi or []) + sh.sa_ms
                              + sh.sa_ls):
            if t.device.type != "cuda" or not t.is_contiguous():
                raise ValueError(f"{kernel}: shard table {i} is not a "
                                 f"contiguous CUDA tensor ({t.device})")
    for t in tabs:
        if t.dtype != torch.int32 or t.dim() != 2 or t.shape[1] != 8 \
                or t.data_ptr() % 16:
            raise ValueError(f"{kernel}: occp must be 16-byte aligned "
                             f"int32[nb, 8], got {tuple(t.shape)} {t.dtype}")


class SmemCollect(CudaKernel):
    """smem_collect(dfm, enc, lens, min_seed_len, split_len, split_width,
    max_mem_intv, lcap, slot_off) -> (m, n int32[S], k, s int64[S],
    cnt int32[N] (-1: the read outran its list or its slots), nbwd
    int64[N]), S = slot_off[N]: read r's SMEMs in slots slot_off[r]...,
    sorted by (m, n).  `lcap` is one of ops/seed.py:LIST_CAPS.  The lane
    group's width, one of LANES, is lanes_for(N)."""

    NAME = "smem_collect"
    SOURCES = ("smem_collect.cu", "smem_group.cuh", "fm_occ.cuh")
    SIGNATURE = ("smem_collect_launch",
                 [VP, VP, VP, VP, VP, I32, I32, I32, I32, I64, I64, I32, I32]
                 + [VP] * 7 + [VP])
    LANES = (16, 32)        # the lane widths smem_collect.cu instantiates

    def __init__(self, plain):
        super().__init__()
        self.plain = plain

    @staticmethod
    def lanes_for(N: int) -> int:
        """Lanes per read for a chunk of N reads, chosen on an NVIDIA H100
        80GB HBM3 (700 W) from chip_smoke.py's phase 5b, which times every
        width: 32 lanes led at 2,048 and 15,000 reads, where the reads do
        not fill the resident groups many times over; 16 at 66,668 reads
        (the default task size)."""
        return 32 if N < 32768 else 16

    @staticmethod
    def plan_bytes(N: int, lens) -> int:
        """Device bytes the wrapper allocates for N reads of lengths `lens`
        (ops/seed.py:slot_offsets' rule): 24 per slot, the per-read count,
        backward_ext count, order and slot offset, and the read counter.
        Linear in sum(lens) + N; the read grid is the caller's."""
        from .seed import SLOTS_BASE, SLOTS_PER_BASE
        slots = sum(SLOTS_BASE + max(int(x), 0) // SLOTS_PER_BASE
                    for x in lens)
        return 24 * slots + N * (4 + 8 + 4) + 8 * (N + 1) + 4

    def plan(self, lanes: int, lcap: int, dev) -> tuple:
        """(blocks, threads, shared bytes per block) of a launch at this
        lane width and list capacity on CUDA device `dev`."""
        plan = (I32 * 3)()
        err = self._query(dev, "smem_collect_plan", [I32, I32, VP], lanes,
                          lcap, plan)
        if err:
            raise ValueError(f"smem_collect: no launch for {lanes} lanes, "
                             f"list capacity {lcap} (CUDA error {err})")
        return tuple(plan)

    def __call__(self, dfm, enc, lens, min_seed_len: int, split_len: int,
                 split_width: int, max_mem_intv: int, lcap: int, slot_off):
        args = (dfm, enc, lens, min_seed_len, split_len, split_width,
                max_mem_intv, lcap, slot_off)
        if enc.device.type == "cpu":
            self._plain()
            return self.plain(*args)
        return self.launch(*args)

    def launch(self, dfm, enc, lens, min_seed_len, split_len, split_width,
               max_mem_intv, lcap, slot_off):
        dev = enc.device
        if dev.type != "cuda":
            raise ValueError(f"smem_collect kernel needs CUDA tensors, got "
                             f"{dev}")
        if dfm.shards is not None:
            raise ValueError("smem_collect reads a replicated index; a "
                             "sharded one seeds through the per-stage "
                             "kernels (ops/smem.py)")
        _check_index("smem_collect", dfm, dev)
        check_tensors("smem_collect", dev, enc=(enc, torch.int8, 2),
                      lens=(lens, torch.int32, 1),
                      slot_off=(slot_off, torch.int64, 1))
        N, L = enc.shape
        if lens.shape[0] != N or slot_off.shape[0] != N + 1:
            raise ValueError(f"smem_collect: {lens.shape[0]} lengths and "
                             f"{slot_off.shape[0]} slot offsets for {N} "
                             "reads")
        lanes = self.lanes_for(N)
        if lanes not in self.LANES:
            raise ValueError(f"smem_collect: {lanes} lanes per group, not "
                             f"one of {self.LANES}")
        S = int(slot_off[-1])
        z = lambda n, dt: torch.empty(n, dtype=dt, device=dev)  # noqa
        m, n = z(S, torch.int32), z(S, torch.int32)
        k, s = z(S, torch.int64), z(S, torch.int64)
        cnt, nbwd = z(N, torch.int32), z(N, torch.int64)
        if N == 0:
            return m, n, k, s, cnt, nbwd
        # longest reads first: a long read starts early, not last
        order = torch.argsort(lens, descending=True, stable=True).int()
        nxt = torch.zeros(1, dtype=torch.int32, device=dev)
        self._launch(
            dev, fm_table(dfm), enc.data_ptr(), lens.data_ptr(),
            order.data_ptr(), slot_off.data_ptr(), N, L, int(min_seed_len),
            int(split_len), int(split_width), int(max_mem_intv), lanes,
            int(lcap), m.data_ptr(), n.data_ptr(), k.data_ptr(),
            s.data_ptr(), cnt.data_ptr(), nbwd.data_ptr(), nxt.data_ptr())
        return m, n, k, s, cnt, nbwd


class SaResolve(CudaKernel):
    """sa_resolve(dfm, pos int64[P]) -> reference coordinates int64[P];
    every pos must be a BWT position of the index (the kernel does not
    check).  Each lane keeps W walks (one of WALKS) in blocks of `threads`
    threads, both from shape_for(P)."""

    NAME = "sa_resolve"
    SOURCES = ("sa_resolve.cu", "sa_group.cuh", "fm_occ.cuh")
    SIGNATURE = ("sa_resolve_launch",
                 [VP, VP, I64, VP, I32, I32, I32, VP, VP])
    WALKS = (1,)            # the walks per lane sa_resolve.cu instantiates

    def __init__(self, plain):
        super().__init__()
        self.plain = plain
        self._resident = {}

    @staticmethod
    def shape_for(P: int) -> tuple[int, int]:
        """(walks per lane, threads per block) for P positions, chosen on
        an NVIDIA H100 80GB HBM3 (700 W): one walk per lane led at every
        size from 42,598 to 1,736,470 positions (two and four walks, with
        more registers and fewer warps resident, were slower), and
        chip_smoke.py's phases 5b and 5d time 128, 256 and 512 threads."""
        return 1, 256

    def plan(self, W: int, threads: int, P: int, dev,
             sharded: bool = False) -> int:
        """Blocks of a launch at this shape on CUDA device `dev` over the
        replicated or the sharded index: the resident blocks (the
        occupancy API, asked once per device and shape), or fewer where P
        positions fill fewer."""
        key = (torch.device(dev).index, W, threads, sharded)
        if key not in self._resident:
            blocks = I32()
            err = self._query(dev, "sa_resolve_resident",
                              [I32, I32, I32, VP], W, int(sharded),
                              threads, ctypes.addressof(blocks))
            if err:
                raise ValueError(f"sa_resolve: no launch of {threads} "
                                 f"threads at {W} walks per lane (CUDA "
                                 f"error {err})")
            self._resident[key] = blocks.value
        return max(1, min(self._resident[key], -(-P // (threads * W))))

    def __call__(self, dfm, pos):
        if pos.device.type == "cpu":
            self._plain()
            return self.plain(dfm, pos)
        return self.launch(dfm, pos)

    def launch(self, dfm, pos):
        dev = pos.device
        if dev.type != "cuda":
            raise ValueError(f"sa_resolve kernel needs CUDA tensors, got "
                             f"{dev}")
        _check_index("sa_resolve", dfm, dev)
        check_tensors("sa_resolve", dev, pos=(pos, torch.int64, 1))
        if dfm.shards is None:
            check_tensors("sa_resolve", dev, sa_ms=(dfm.sa_ms, torch.int8, 1),
                          sa_ls=(dfm.sa_ls, torch.int32, 1))
        P = pos.shape[0]
        if P >= 1 << 31:
            raise ValueError(f"sa_resolve: {P} positions, the kernel's "
                             "int32 indices take fewer than 2^31")
        # the coordinates, then the launch's ticket counter
        out = torch.empty(P + 1, dtype=torch.int64, device=dev)
        if P == 0:
            return out[:0]
        W, threads = self.shape_for(P)
        ptr = out.data_ptr()
        self._launch(dev, fm_table(dfm), pos.data_ptr(), P, ptr, W,
                     self.plan(W, threads, P, dev, dfm.shards is not None),
                     threads, ptr + 8 * P)
        return out[:P]

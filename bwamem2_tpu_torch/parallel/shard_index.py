"""The genome-bucket sharded index across cards (the counterpart of
bwamem2_tpu/parallel/shard_index.py).

The replicated deployment needs every card to hold the whole index; this
one splits its big tables by contiguous row range ("genome bucket") over
D shards, one per entry of a device list (a card may repeat: several
shards on one card):

  occp   int32[nblocks, 8]   -> rows split over the shards, in order
  occ_hi int32[nblocks]      -> the same (only where the counts pass 32
                                bits; otherwise a dummy nothing reads)
  sa_ms  int8[(n>>3)+1]      -> the same
  sa_ls  int32[(n>>3)+1]     -> the same
  counts / sentinel / ref replicated on every card.

A human index (3.1 Gbp) holds ~3.1 GB of occ rows, ~3.9 GB of SA and 1.55
GB of packed genome: sharded over 4 cards each holds ~1.75 GB of tables
plus the genome.  The JAX package fetches every row with a collective
round (all_gather of the ids, a local gather, psum_scatter); here all
cards belong to one process, peer access is enabled between every pair
(csrc/peer_access.cu, which also allocates the shards with cudaMalloc),
and a kernel on one card reads another card's shard directly over NVLink
(csrc/fm_occ.cuh:FmShardView).  The plain versions fetch through
ops/device_index.py:dist_rows_ref, the collective's semantics.

The seeding lanes are split as the JAX package's shard_map splits them:
split_lanes pads nothing itself (the callers pad their lane counts to a
multiple of D), runs each card's contiguous slice of lanes on that card
from a thread of its own, and concatenates the outputs on the first
card.  A card's kernels read the whole read grid (round-2 lanes index
reads by row across the chunk), so inputs the lanes share go to every
card whole.
"""

from __future__ import annotations

import ctypes
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..ops import resolve_device
from ..ops.cuda_build import I32, I64, VP, build_library, current_tally, \
    launch_tally
from ..ops.device_index import DeviceFMIndex, FmShards
from ..ops.seed_cuda import MAX_SHARDS


class _PeerLib:
    """csrc/peer_access.cu, built at first use."""

    def __init__(self):
        self._lib = None

    def lib(self) -> ctypes.CDLL:
        if self._lib is None:
            path, _ = build_library("peer_access", ("peer_access.cu",))
            lib = ctypes.CDLL(path)
            for name, args in (("peer_enable", [I32, I32]),
                               ("peer_alloc", [I32, I64, VP]),
                               ("peer_free", [I32, VP])):
                getattr(lib, name).restype = I32
                getattr(lib, name).argtypes = args
            self._lib = lib
        return self._lib

    def call(self, name: str, *args) -> None:
        err = getattr(self.lib(), name)(*args)
        if err:
            raise RuntimeError(f"{name}{args[:2]} failed: CUDA error {err}")


PEER = _PeerLib()


class _CardBuffer:
    """cudaMalloc'd memory of one shard table on card `dev`, seen by torch
    through __cuda_array_interface__ (the tensor keeps this owner alive;
    the memory is freed with it)."""

    def __init__(self, dev: int, shape: tuple, dtype: np.dtype):
        self.dev = dev
        ptr = ctypes.c_void_p()
        nbytes = int(np.prod(shape)) * dtype.itemsize
        PEER.call("peer_alloc", dev, max(nbytes, 1), ctypes.byref(ptr))
        self.ptr = ptr.value
        self.__cuda_array_interface__ = dict(
            shape=shape, typestr=dtype.str, data=(self.ptr, False),
            strides=None, version=2)

    def __del__(self):
        if PEER._lib is not None and self.ptr:
            PEER.lib().peer_free(self.dev, self.ptr)


def enable_peers(cards: list[int]) -> None:
    """Peer access from every card to every other; raises if a pair cannot
    reach each other (there is no fallback to copying the tables)."""
    for a in cards:
        for b in cards:
            if a != b:
                PEER.call("peer_enable", a, b)


def _put(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    if dev.type != "cuda":
        return torch.from_numpy(a)
    t = torch.as_tensor(_CardBuffer(dev.index, a.shape, a.dtype), device=dev)
    t.copy_(torch.from_numpy(a))
    return t


def _pad_rows(a: np.ndarray, d: int) -> np.ndarray:
    pad = (-a.shape[0]) % d
    if pad == 0:
        return a
    return np.concatenate([a, np.zeros((pad,) + a.shape[1:], a.dtype)])


def shard_index(dfm: DeviceFMIndex, devices) -> list[DeviceFMIndex]:
    """Split the replicated index `dfm` (on any device) into len(devices)
    shards, shard i on devices[i], and return one view per entry of
    devices: a DeviceFMIndex on that device with the shards and its own
    copy of counts, sentinel and the genome (entries on the same device
    share one view).  CUDA cards get peer access to one another first."""
    devs = [resolve_device(d) for d in devices]
    D = len(devs)
    if not 1 <= D <= MAX_SHARDS:
        raise ValueError(f"{D} shards: the kernels take 1 to {MAX_SHARDS}")
    if len({d.type for d in devs}) != 1:
        raise ValueError(f"shards on {devs}: all on the CPU or all on cards")
    if devs[0].type == "cuda":
        enable_peers(sorted({d.index for d in devs}))

    def split(t: torch.Tensor):
        a = _pad_rows(t.cpu().numpy(), D)
        per = a.shape[0] // D
        return [_put(a[i * per:(i + 1) * per], d)
                for i, d in enumerate(devs)], per

    occp, rows = split(dfm.occp)
    sa_ms, sa_rows = split(dfm.sa_ms)
    sh = FmShards(occp=occp,
                  occ_hi=split(dfm.occ_hi)[0] if dfm.has_hi else None,
                  sa_ms=sa_ms, sa_ls=split(dfm.sa_ls)[0], rows=rows,
                  sa_rows=sa_rows, nblocks=dfm.occp.shape[0])
    views: dict = {}
    for d in devs:
        if d not in views:
            views[d] = DeviceFMIndex(
                ref=dfm.ref.to(d), ref_packed=dfm.ref_packed, device=d,
                n_ref=dfm.n_ref, counts=dfm.counts.to(d),
                sentinel=dfm.sentinel.to(d), has_hi=dfm.has_hi, shards=sh)
    return [views[d] for d in devs]


def table_bytes(views: list[DeviceFMIndex]) -> dict:
    """{device: bytes of index tables it holds}: its shards plus its copy
    of the genome and counts."""
    out: dict = {}
    sh = views[0].shards
    tabs = sh.occp + (sh.occ_hi or []) + sh.sa_ms + sh.sa_ls
    for v in {id(v): v for v in views}.values():
        tabs = tabs + [v.ref, v.counts]
    for t in tabs:
        key = str(t.device)
        out[key] = out.get(key, 0) + t.numel() * t.element_size()
    return out


def split_lanes(views: list[DeviceFMIndex], fn, lanes: tuple,
                shared: tuple = ()) -> tuple:
    """fn(view, *shared, *lane slices) on every card of the index: card i
    gets the i-th of len(views) equal contiguous slices of each tensor of
    `lanes` (their length a multiple of len(views)) and every tensor of
    `shared` whole, both on its device, and runs from a thread of its own
    with the caller's launch tally; fn returns a tuple of lane tensors.
    Returns their concatenations on the first card."""
    D = len(views)
    n = lanes[0].shape[0]
    if n % D:
        raise ValueError(f"{n} lanes do not split over {D} cards")
    per = n // D
    first = views[0].device
    on_dev = {}
    for v in views:
        if v.device not in on_dev:
            on_dev[v.device] = tuple(t.to(v.device) for t in shared)
    tally = current_tally()

    def run(i):
        launch_tally(tally)
        v = views[i]
        part = tuple(t[i * per:(i + 1) * per].to(v.device) for t in lanes)
        return fn(v, *on_dev[v.device], *part)

    with ThreadPoolExecutor(D) as pool:
        parts = list(pool.map(run, range(D)))
    return tuple(torch.cat([p[j].to(first) for p in parts])
                 for j in range(len(parts[0])))


def sharded_seed_extend_sharded_index(mesh: list, dfm: DeviceFMIndex, enc,
                                      lens, **kw):
    """ops/entry.py:seed_extend_step with both the reads and the index split
    over the devices of `mesh` (bwamem2_tpu/parallel/shard_index.py:
    sharded_seed_extend_sharded_index): the index in len(mesh) shards, the
    batch padded to a multiple of len(mesh) and split, each device's slice
    through the step from a thread of its own.  Returns the step's five
    outputs as numpy arrays over the batch; `kw` are its scores."""
    from ..ops.entry import seed_extend_step
    from .mesh import shard_batch
    views = shard_index(dfm, mesh)
    encs, lenss, n = shard_batch(mesh, np.asarray(enc), np.asarray(lens))

    def step(v, e, ln):
        return [x.cpu() for x in seed_extend_step(v, e, ln, **kw)]

    with ThreadPoolExecutor(len(mesh)) as pool:
        parts = list(pool.map(step, views, encs, lenss))
    return [torch.cat([p[i] for p in parts]).numpy()[:n] for i in range(5)]

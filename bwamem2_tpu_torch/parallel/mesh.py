"""The fused seed-extend step split over devices along the read axis (the
data half of bwamem2_tpu/parallel/mesh.py; the names are the JAX ones).

A "mesh" here is a list of torch devices.  The index is replicated on each
(a ~8.6 GB human index fits one 80 GB card whole), the batch is padded
with empty reads to a multiple of the device count and split, each device
runs ops/entry.py:seed_extend_step on its slice with no collective, each
from a host thread of its own (the step waits on its card between
stages, and the cards must not wait on one another), and the parts are
concatenated in order and trimmed to the batch.  The
genome-bucket sharded index (sharded_seed_extend_sharded_index) is not
ported.
"""

from __future__ import annotations

import dataclasses
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..ops import resolve_devices
from ..ops.device_index import DeviceFMIndex


def make_mesh(n_devices: int | None = None, devices=None
              ) -> list[torch.device]:
    """The devices of a data axis: every visible card (at most 8) by
    default, or the given `devices` (e.g. ["cpu"] * 3), cut to
    n_devices."""
    devs = ([torch.device(d) for d in devices] if devices is not None
            else resolve_devices("cuda"))
    return devs[:n_devices] if n_devices is not None else devs


def shard_batch(mesh: list, enc: np.ndarray, lens: np.ndarray):
    """Pad the batch with empty reads (code 4, length 0) to a multiple of
    the device count and split it: ([enc part per device], [lens part per
    device], N)."""
    n_dev = len(mesh)
    N = enc.shape[0]
    pad = (-N) % n_dev
    if pad:
        enc = np.concatenate([enc, np.full((pad, enc.shape[1]), 4,
                                           enc.dtype)])
        lens = np.concatenate([lens, np.zeros(pad, lens.dtype)])
    per = enc.shape[0] // n_dev
    encs = [torch.from_numpy(np.ascontiguousarray(enc[i * per:(i + 1) * per]))
            .to(d) for i, d in enumerate(mesh)]
    lenss = [torch.from_numpy(np.ascontiguousarray(
        lens[i * per:(i + 1) * per])).to(d) for i, d in enumerate(mesh)]
    return encs, lenss, N


def replicate_index(mesh: list, dfm: DeviceFMIndex) -> list[DeviceFMIndex]:
    """One DeviceFMIndex per device of the mesh, each holding its own copy
    of the index's tables (the same object where it already lives)."""
    out = []
    for d in mesh:
        if d == dfm.device:
            out.append(dfm)
            continue
        moved = {f.name: getattr(dfm, f.name).to(d)
                 for f in dataclasses.fields(dfm)
                 if isinstance(getattr(dfm, f.name), torch.Tensor)}
        out.append(dataclasses.replace(dfm, device=d, **moved))
    return out


def sharded_seed_extend(mesh: list, dfm: DeviceFMIndex, enc, lens, **kw):
    """seed_extend_step with the reads split over the mesh's devices and
    the index replicated on each; returns its five outputs as numpy
    arrays over the whole batch.  `kw` are the step's scores.  Each device's
    slice runs in a thread of its own, so the devices work side by side."""
    from ..ops.entry import seed_extend_step
    dfms = replicate_index(mesh, dfm)
    encs, lenss, n = shard_batch(mesh, np.asarray(enc), np.asarray(lens))

    def step(d, e, ln):
        return [x.cpu() for x in seed_extend_step(d, e, ln, **kw)]

    with ThreadPoolExecutor(len(mesh)) as pool:
        parts = list(pool.map(step, dfms, encs, lenss))
    return [torch.cat([p[i] for p in parts]).numpy()[:n] for i in range(5)]


def merge_shards(chunks: dict[int, str]) -> str:
    """Deterministic SAM merge: concatenate per-chunk outputs by index."""
    return "".join(chunks[i] for i in sorted(chunks))

"""Device side of the port: the device-resident index, the seeding and
extension dispatch with their plain PyTorch versions, and the bindings of
the hand-written CUDA kernels."""

from __future__ import annotations

import torch

# the most cards one process drives with data parallelism (one backend
# per card), as the JAX package's CLI takes devs[:8]
MAX_CARDS = 8


def round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def bucket_pow2(n: int, lo: int = 256) -> int:
    """Smallest bucket >= max(n, lo) from {lo, 1.5lo, 2lo, 3lo, 4lo, ...}:
    the lane counts of the per-stage seeding (ops/backend.py), as the JAX
    package buckets them (there to bound its compiles)."""
    b = lo
    while b < n:
        if b + (b >> 1) >= n:
            return b + (b >> 1)
        b <<= 1
    return b


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: "cuda" unless the caller asks
    for "cpu".  Asking for CUDA without a usable card raises: there is no
    silent fallback to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device 'cuda' requested but torch.cuda.is_available() is "
                "False; pass device='cpu' (CLI: --device cpu) to run on "
                "the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev


def resolve_devices(device=None) -> list[torch.device]:
    """Every device a data-parallel entry point drives: for "cuda" (the
    default) each visible card, at most MAX_CARDS; for "cpu" or a device
    with an index, that one device.  Raises as resolve_device does."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and dev.index is None:
        resolve_device(dev)             # raises without a card
        n = min(torch.cuda.device_count(), MAX_CARDS)
        return [torch.device("cuda", i) for i in range(n)]
    return [resolve_device(dev)]

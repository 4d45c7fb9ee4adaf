"""Random row-gather throughput vs table size on the device.

The port of tools/gather_scale_probe.py.  For a table of int32[nblocks,
16] rows (64-byte occ4-layout rows) and P = 32768 random row indices it
measures, per table size:
  (a) one_shot   tab[idx] as one PyTorch call, then a sum;
  (b) chain      a 16-step dependent gather chain, the shape of an LF walk:
                 each step's indices come from the rows the previous step
                 read;
  (c) kernel     the hand-written row_gather kernel (csrc/row_gather.cu),
                 then a sum — the port of the TPU probe's Pallas kernel;
and prints rows/s for each, timed with CUDA events (best of `reps`).

    python -m bwamem2_tpu_torch.tools.gather_scale_probe [MB ...]
        [--device cuda|cpu] [--reps N]

Sizes default to 4 16 64 256 1024 2048 4096 MB.  `--device cpu` runs the
same modes with the plain versions, on the host clock (a functional check,
not a measurement of any device).  `probe()` returns the rows as dicts.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from ..ops import resolve_device
from ..ops.row_gather import row_gather

P = 32768
STEPS = 16
W = 16
SIZES_MB = (4, 16, 64, 256, 1024, 2048, 4096)


def one_shot(tab, idx):
    return tab[idx.long()].sum(dtype=torch.int64)


def chain(tab, idx):
    n = tab.shape[0]
    ix = idx.long()
    acc = torch.zeros_like(ix)
    for _ in range(STEPS):
        rows = tab[ix]
        acc = acc + rows.sum(1, dtype=torch.int64)
        ix = (ix * 1103515245 + rows[:, 0].long() + 12345) % n
    return acc.sum()


def kernel(tab, idx):
    return row_gather(tab, idx).sum(dtype=torch.int64)


def _time(fn, tab, idx, reps: int) -> float:
    """Best-of-`reps` seconds of one call: CUDA events on the card, the
    host clock on the CPU."""
    fn(tab, idx)                                  # warm (and build)
    best = float("inf")
    for _ in range(reps):
        if tab.is_cuda:
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            fn(tab, idx)
            e1.record()
            torch.cuda.synchronize()
            best = min(best, e0.elapsed_time(e1) / 1e3)
        else:
            t = time.perf_counter()
            fn(tab, idx)
            best = min(best, time.perf_counter() - t)
    return best


def make_table(mb: float, device, seed: int = 1, p: int = P):
    """int32[nblocks, 16] table of `mb` MB (values made on the device) and
    `p` random row indices made with numpy from `seed`."""
    nblocks = max(int(mb * (1 << 20)) // (4 * W), 1)
    tab = (torch.arange(nblocks * W, dtype=torch.int32, device=device)
           .reshape(nblocks, W) & 0xFFFF)
    rng = np.random.default_rng(seed)
    idx = torch.from_numpy(rng.integers(0, nblocks, p).astype(np.int32)
                           ).to(device)
    return tab, idx


def probe(sizes_mb=SIZES_MB, device=None, reps: int = 3,
          out=sys.stdout) -> list[dict]:
    dev = resolve_device(device)
    where = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
             else "cpu (plain versions, host clock)")
    out.write(f"device={where} P={P} steps={STEPS} W={W}\n")
    rows = []
    for mb in sizes_mb:
        tab, idx = make_table(mb, dev)
        t1 = _time(one_shot, tab, idx, reps)
        tc = _time(chain, tab, idx, reps)
        tk = _time(kernel, tab, idx, reps)
        r = dict(mb=mb, nblocks=tab.shape[0], one_shot_s=t1, chain_s=tc,
                 kernel_s=tk)
        rows.append(r)
        out.write(f"size={mb:5}MB nblocks={tab.shape[0]:>10}  "
                  f"one_shot={P / t1 / 1e6:8.1f} Mrow/s ({t1 * 1e3:7.3f} ms)  "
                  f"chain={P * STEPS / tc / 1e6:8.1f} Mrow/s "
                  f"({tc * 1e3:7.3f} ms)  "
                  f"kernel={P / tk / 1e6:8.1f} Mrow/s ({tk * 1e3:7.3f} ms)\n")
        out.flush()
        del tab, idx
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("sizes", nargs="*", type=float, default=list(SIZES_MB),
                    help="table sizes in MB")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--reps", type=int, default=3)
    a = ap.parse_args(argv)
    probe(a.sizes, a.device, a.reps)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Plain local alignment: the best Smith-Waterman score of each read
against a stretch of the genome, with BWA-MEM's scoring.

Scoring (bwa's `bwa_fill_scmat` and `ksw`): a match scores `a`, a
mismatch `-b`, a pair with an N `-1`; a deletion of k reference bases
costs `o_del + k * e_del`, an insertion of k read bases `o_ins + k * e_ins`;
the alignment may start and end anywhere (local).  Any alignment the
program reports inside a stretch scores at most this best.

Gotoh's recurrence, one read base a step, all the batch's stretches at
once: E (an insertion) comes from the row above; F (a deletion) runs
along the row, taken in one pass as a running maximum of H + e * j
(opening a deletion from a cell that a deletion reached never beats
extending it).  Plain PyTorch in int32, on whatever device the tensors
are given.  `saturate` (the control) clamps every sum to the range of
that many signed bits, as saturating 8-bit SIMD arithmetic does.

Imports nothing of the program.
"""

from __future__ import annotations

import numpy as np
import torch

PAD_Q, PAD_T = 5, 6
NEG = -(1 << 20)


def _pad(seqs: list[np.ndarray], fill: int) -> np.ndarray:
    n = max((len(s) for s in seqs), default=0)
    out = np.full((len(seqs), max(n, 1)), fill, np.uint8)
    for i, s in enumerate(seqs):
        out[i, :len(s)] = s
    return out


def best_local(queries: list[np.ndarray], targets: list[np.ndarray],
               sc: dict, device="cpu", saturate: int | None = None
               ) -> np.ndarray:
    """Best local score of queries[i] (codes 0-3) against targets[i]
    (codes 0-4, 4 = N), for every i; int64[len(queries)]."""
    if not queries:
        return np.zeros(0, np.int64)
    a, b = int(sc["a"]), int(sc["b"])
    oi, ei = int(sc["o_ins"]), int(sc["e_ins"])
    od, ed = int(sc["o_del"]), int(sc["e_del"])
    q = torch.as_tensor(_pad(queries, PAD_Q), device=device)
    t = torch.as_tensor(_pad(targets, PAD_T), device=device)
    B, T = t.shape
    i32 = torch.int32
    if saturate:
        hi, lo = (1 << (saturate - 1)) - 1, -(1 << (saturate - 1))

        def sat(x):
            return x.clamp_(lo, hi)
    else:
        def sat(x):
            return x
    tt = t.long()
    t_pad = tt == PAD_T
    t_n = tt == 4
    jj = torch.arange(T + 1, device=device, dtype=i32)[None, :]
    zero_col = torch.zeros(B, 1, dtype=i32, device=device)
    neg_col = torch.full((B, 1), NEG, dtype=i32, device=device)
    H = torch.zeros(B, T + 1, dtype=i32, device=device)
    E = torch.full((B, T + 1), NEG, dtype=i32, device=device)
    best = torch.zeros(B, dtype=i32, device=device)
    for i in range(q.shape[1]):
        qi = q[:, i:i + 1].long()
        s = torch.where(qi == tt, a, -b).to(i32)
        s = torch.where(t_n | (qi == 4), torch.tensor(-1, dtype=i32,
                                                      device=device), s)
        s = torch.where(t_pad | (qi == PAD_Q),
                        torch.tensor(NEG, dtype=i32, device=device), s)
        diag = sat(H[:, :-1] + s)
        e = torch.maximum(sat(H[:, 1:] - (oi + ei)), sat(E[:, 1:] - ei))
        hp = torch.clamp_min(torch.maximum(diag, e), 0)
        g = torch.cat([zero_col, hp], 1) + ed * jj
        run = torch.cummax(g, 1).values[:, :-1]
        f = sat(run - od - ed * jj[:, 1:])
        h = torch.maximum(hp, f)
        best = torch.maximum(best, h.max(1).values)
        H = torch.cat([zero_col, h], 1)
        E = torch.cat([neg_col, e], 1)
    return best.cpu().numpy().astype(np.int64)


"""Exact replica of klib ks_introsort's permutation behavior.

bwa-mem's output depends on the ORDER of equal-keyed elements after sorting
(e.g. which of two equal-weight chains is recorded as the "first shadowed"
hit for MAPQ).  ks_introsort (reference src/ksort.h:185-236) is an introsort
whose quicksort partitioning permutes ties deterministically; a stable sort
gives different (valid but non-identical) output.  This module reproduces the
exact element permutation: median-of-3 pivot, Hoare-ish partition, explicit
stack, combsort fallback on depth exhaustion, final insertion-sort pass over
blocks <= 16.
"""

from __future__ import annotations

_SHRINK = 1.2473309501039786540366528676643


def _insertsort(a, lt, s, t):
    # sorts a[s:t] (t exclusive)
    for i in range(s + 1, t):
        j = i
        while j > s and lt(a[j], a[j - 1]):
            a[j], a[j - 1] = a[j - 1], a[j]
            j -= 1


def _combsort(a, lt, s, n):
    gap = n
    while True:
        if gap > 2:
            gap = int(gap / _SHRINK)
            if gap in (9, 10):
                gap = 11
        do_swap = False
        for i in range(s, s + n - gap):
            j = i + gap
            if lt(a[j], a[i]):
                a[i], a[j] = a[j], a[i]
                do_swap = True
        if not (do_swap or gap > 2):
            break
    if gap != 1:
        _insertsort(a, lt, s, s + n)


def ks_introsort(a: list, lt) -> None:
    """In-place sort of list `a` with strict-less comparator `lt`, producing
    exactly the permutation ks_introsort produces."""
    n = len(a)
    if n < 1:
        return
    if n == 2:
        if lt(a[1], a[0]):
            a[0], a[1] = a[1], a[0]
        return
    d = 2
    while (1 << d) < n:
        d += 1
    d <<= 1
    stack = []
    s, t = 0, n - 1
    while True:
        if s < t:
            d -= 1
            if d == 0:
                _combsort(a, lt, s, t - s + 1)
                t = s
                continue
            i, j = s, t
            k = i + ((j - i) >> 1) + 1
            if lt(a[k], a[i]):
                if lt(a[k], a[j]):
                    k = j
            else:
                k = i if lt(a[j], a[i]) else j
            rp = a[k]
            if k != t:
                a[k], a[t] = a[t], a[k]
            while True:
                i += 1
                while lt(a[i], rp):
                    i += 1
                j -= 1
                while i <= j and lt(rp, a[j]):
                    j -= 1
                if j <= i:
                    break
                a[i], a[j] = a[j], a[i]
            a[i], a[t] = a[t], a[i]
            if i - s > t - i:
                if i - s > 16:
                    stack.append((s, i - 1, d))
                s = (i + 1) if t - i > 16 else t
            else:
                if t - i > 16:
                    stack.append((i + 1, t, d))
                t = (i - 1) if i - s > 16 else s
        else:
            if not stack:
                _insertsort(a, lt, 0, n)
                return
            s, t, d = stack.pop()

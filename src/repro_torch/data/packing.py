"""Sequence packing: best-fit-decreasing to per-rank capacity C
(ByteScale Alg. 1 lines 7–9).  Host-side numpy/python — runs in the
single-controller scheduler, never on device."""
from __future__ import annotations

import bisect
from typing import List, Sequence, Tuple


def best_fit_decreasing(lengths: Sequence[int], capacity: int,
                        ids: Sequence[int] | None = None
                        ) -> List[List[Tuple[int, int]]]:
    """Pack (id, length) items into bins of `capacity`.

    Returns a list of bins; each bin is a list of (id, length).  Items longer
    than capacity are rejected (callers shard those across ranks instead).
    """
    if ids is None:
        ids = list(range(len(lengths)))
    items = sorted(zip(ids, lengths), key=lambda t: -t[1])
    # bins kept as sorted list of (free_space, bin_index)
    bins: List[List[Tuple[int, int]]] = []
    free: List[Tuple[int, int]] = []          # sorted by free space
    for sid, ln in items:
        if ln > capacity:
            raise ValueError(f"sequence {sid} (len {ln}) exceeds capacity")
        # best fit: smallest free space >= ln
        k = bisect.bisect_left(free, (ln, -1))
        if k < len(free):
            space, bidx = free.pop(k)
            bins[bidx].append((sid, ln))
            new_space = space - ln
            bisect.insort(free, (new_space, bidx))
        else:
            bins.append([(sid, ln)])
            bisect.insort(free, (capacity - ln, len(bins) - 1))
    return bins


def zigzag_chunks(length: int, group: int) -> List[Tuple[int, Tuple[int, int], Tuple[int, int]]]:
    """ByteScale Fig. 14 layout: split a sequence into 2·g chunks; rank j of
    the group holds chunks j and 2g-1-j (symmetric), so every rank covers an
    equal area of the causal attention mask.

    Returns [(rank_in_group, (lo_start, lo_end), (hi_start, hi_end))].
    Chunk boundaries are token indices; the final chunk absorbs remainders.
    """
    n = 2 * group
    base = length // n
    rem = length % n
    bounds = [0]
    for i in range(n):
        bounds.append(bounds[-1] + base + (1 if i < rem else 0))
    out = []
    for j in range(group):
        lo = (bounds[j], bounds[j + 1])
        hi = (bounds[n - 1 - j], bounds[n - j])
        out.append((j, lo, hi))
    return out

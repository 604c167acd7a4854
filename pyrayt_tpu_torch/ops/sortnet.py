"""Static sorting networks for tiny leading axes.

Counterpart of ``pyrayt_tpu.ops.sortnet``.  Every sort in the tracer runs
along a static, tiny event axis (2 to ~16 CSG events), so it is a Batcher
odd-even mergesort network of compare-exchange steps that carries payload
rows (surface ids, parity signs) through the same permutation.  The CUDA
kernel (csrc/fused_trace.cu) runs the same comparator pairs, computed here
on the host, so exact ties resolve the same way in every engine.
"""

from __future__ import annotations

from functools import lru_cache
from typing import List, Sequence, Tuple

import torch

__all__ = ["batcher_pairs", "sort_rows", "sort_rows_with_payloads", "rows", "unrows"]


@lru_cache(maxsize=None)
def batcher_pairs(n: int) -> Tuple[Tuple[int, int], ...]:
    """Comparator (i, j) pairs of a Batcher odd-even mergesort network on n
    wires; applying compare-exchange in order sorts any input."""
    pairs: List[Tuple[int, int]] = []
    p = 1
    while p < n:
        k = p
        while k >= 1:
            for j in range(k % p, n - k, 2 * k):
                for i in range(min(k, n - j - k)):
                    if (i + j) // (2 * p) == (i + j + k) // (2 * p):
                        pairs.append((i + j, i + j + k))
            k //= 2
        p *= 2
    return tuple(pairs)


def rows(x) -> List[torch.Tensor]:
    """Split an (m, ...) tensor into a list of m rows."""
    return [x[i] for i in range(x.shape[0])]


def unrows(row_list: Sequence[torch.Tensor]) -> torch.Tensor:
    return torch.stack(list(row_list), dim=0)


def sort_rows_with_payloads(keys, payloads=(), stable=False):
    """Sort row lists ascending by key, permuting payload row lists along.

    ``stable=True`` breaks key ties by original row order (lexicographic
    (key, source-row) comparison), which the CSG parity semantics need:
    a coincident entry/exit pair keeps entry-first order.
    """
    keys = list(keys)
    payloads = [list(p) for p in payloads]
    m = len(keys)
    if m <= 1:
        return keys, payloads

    ranks = None
    if stable:
        ranks = [
            torch.full(keys[0].shape, i, dtype=torch.int32, device=keys[0].device)
            for i in range(m)
        ]

    for i, j in batcher_pairs(m):
        ki, kj = keys[i], keys[j]
        if stable:
            ri, rj = ranks[i], ranks[j]
            swap = (kj < ki) | ((kj == ki) & (rj < ri))
            ranks[i] = torch.where(swap, rj, ri)
            ranks[j] = torch.where(swap, ri, rj)
        else:
            swap = kj < ki
        keys[i] = torch.where(swap, kj, ki)
        keys[j] = torch.where(swap, ki, kj)
        for p in payloads:
            pi, pj = p[i], p[j]
            p[i] = torch.where(swap, pj, pi)
            p[j] = torch.where(swap, pi, pj)
    return keys, payloads


def sort_rows(x) -> torch.Tensor:
    """Network-sorted ``torch.sort(x, dim=0)`` for a small static
    ``x.shape[0]``."""
    if x.shape[0] == 2:
        return torch.stack((torch.minimum(x[0], x[1]), torch.maximum(x[0], x[1])))
    keys, _ = sort_rows_with_payloads(rows(x))
    return unrows(keys)

"""Constructive solid geometry interval engine (general trees).

Counterpart of ``pyrayt_tpu.core.csg``.  Each child contributes a sorted,
even-length list of entry/exit parameters; merging both lists and
summing +/-1 (entering/leaving a solid) counts the solids that contain
the ray at each event, and only boundary events of the combined solid are
kept (the rest become ``+inf``).  The merge is a stable Batcher network
(ops/sortnet.py) that carries the parity signs and surface ids; the union
boundary test keeps the reference's wraparound pairing.
"""

from __future__ import annotations

import enum

import torch

from pyrayt_tpu_torch.core.operations import INF
from pyrayt_tpu_torch.ops.sortnet import rows, sort_rows_with_payloads, unrows

__all__ = ["Operation", "array_csg", "csg_combine_with_ids", "entry_signs"]


class Operation(enum.Enum):
    UNION = 1
    INTERSECT = 2
    DIFFERENCE = 3


def entry_signs(m1: int, m2: int, operation: Operation):
    """Static +/-1 entry/exit sign per merged source row (pre-merge)."""
    signs = [1 if i % 2 == 0 else -1 for i in range(m1)]
    if operation == Operation.DIFFERENCE:
        # the subtracted solid's inside counts against
        signs += [-1 if i % 2 == 0 else 1 for i in range(m2)]
    else:
        signs += [1 if i % 2 == 0 else -1 for i in range(m2)]
    return signs


def _merge_and_count(hit_rows, sign_rows, payload_rows, operation: Operation):
    """Network-merge event rows; return (sorted hits, inside counts, payloads)."""
    payloads = (sign_rows,) + ((payload_rows,) if payload_rows else ())
    keys, moved = sort_rows_with_payloads(hit_rows, payloads, stable=True)
    counts = []
    running = None
    for s in moved[0]:
        running = s if running is None else running + s
        counts.append(running)
    if operation == Operation.DIFFERENCE:
        counts = [c + 1 for c in counts]
    return keys, counts, (moved[1] if payload_rows else None)


def _boundary_rows(counts, operation: Operation):
    m = len(counts)
    if operation == Operation.UNION:
        occupied = [c != 0 for c in counts]
        # wraparound pairing: row 0 compares against the last row, correct
        # because counts return to 0 at the +/-inf sentinels
        return [occupied[i] ^ occupied[i - 1] for i in range(m)]
    is_two = [c == 2 for c in counts]
    return [is_two[i] | is_two[i - 1] for i in range(m)]


def _combine(hit_rows, id_rows, m1, m2, operation):
    signs = entry_signs(m1, m2, operation)
    sign_rows = [torch.full_like(hit_rows[0], s) for s in signs]
    keys, counts, id_rows = _merge_and_count(hit_rows, sign_rows, id_rows, operation)
    boundary = _boundary_rows(counts, operation)
    return [torch.where(b, k, INF) for b, k in zip(boundary, keys)], id_rows


def array_csg(array1, array2, operation: Operation, sort_output: bool = True):
    """Combine two sorted even-length hit arrays (1-D or ``(m, n)`` with
    rays as columns) with a CSG op; non-boundary events become ``+inf``."""
    squeeze = array1.ndim == 1
    a1 = array1[:, None] if squeeze else array1
    a2 = array2[:, None] if squeeze else array2
    csg_rows, _ = _combine(rows(a1) + rows(a2), None, a1.shape[0], a2.shape[0], operation)
    if sort_output:
        csg_rows, _ = sort_rows_with_payloads(csg_rows, stable=True)
    out = unrows(csg_rows)
    return out[:, 0] if squeeze else out


def csg_combine_with_ids(l_hits, l_ids, r_hits, r_ids, operation: Operation):
    """CSG-combine two children's (hits, surface-ids) matrices.

    Returns ``(hits, ids)``, both ``(m1+m2, n)``, sorted ascending by hit
    with ``+inf`` for removed events (their ids travel with the sort).
    """
    csg_rows, id_rows = _combine(
        rows(l_hits) + rows(r_hits),
        rows(l_ids) + rows(r_ids),
        l_hits.shape[0],
        r_hits.shape[0],
        operation,
    )
    csg_rows, (id_rows,) = sort_rows_with_payloads(csg_rows, (id_rows,), stable=True)
    return unrows(csg_rows), unrows(id_rows)

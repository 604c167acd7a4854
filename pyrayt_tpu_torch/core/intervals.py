"""Closed-form interval CSG (the fast path for factory-shaped trees).

Counterpart of ``pyrayt_tpu.core.intervals``.  Every leaf intersector
returns one (entry, exit) interval per ray, and every factory-built CSG
tree combines a left subtree with a *leaf* right child by intersect or
difference; on that shape CSG is a few min/max/where ops per node.  Trees
with union nodes or non-leaf right children take the general network path
(core.csg).

Interval encoding: ``(lo, hi, lo_id, hi_id)``; misses are ``(+inf, +inf)``.
The surface ids travel with each endpoint and are chosen by strict ``>`` /
``<`` comparisons, so exact ties keep the left operand's id.
"""

from __future__ import annotations

import torch

from pyrayt_tpu_torch.core.operations import INF

__all__ = [
    "tree_supports_intervals",
    "interval_intersect",
    "interval_difference",
    "eval_tree_intervals",
    "leaf_intervals_from_hits",
]

LEAF = "leaf"


def tree_supports_intervals(tree) -> bool:
    if tree[0] == LEAF:
        return True
    op_name, l_tree, r_tree = tree
    return (
        op_name in ("intersect", "difference")
        and r_tree[0] == LEAF
        and tree_supports_intervals(l_tree)
    )


def interval_intersect(iv, b):
    """[a0,a1] ∩ [b0,b1] with surface ids travelling on each endpoint."""
    a0, a1, i0, i1 = iv
    b0, b1, j0, j1 = b
    lo = torch.maximum(a0, b0)
    hi = torch.minimum(a1, b1)
    lo_id = torch.where(b0 > a0, j0, i0)
    hi_id = torch.where(b1 < a1, j1, i1)
    empty = lo > hi
    return (torch.where(empty, INF, lo), torch.where(empty, INF, hi), lo_id, hi_id)


def interval_difference(iv, b):
    """[a0,a1] − [b0,b1] -> two intervals (the general convex case)."""
    a0, a1, i0, i1 = iv
    b0, b1, j0, j1 = b
    # piece 1: [a0, min(a1, b0)] — the part before the subtracted solid
    p1_hi = torch.minimum(a1, b0)
    p1_hi_id = torch.where(b0 < a1, j0, i1)
    e1 = a0 > p1_hi
    p1 = (torch.where(e1, INF, a0), torch.where(e1, INF, p1_hi), i0, p1_hi_id)
    # piece 2: [max(a0, b1), a1] — the part after it
    p2_lo = torch.maximum(a0, b1)
    p2_lo_id = torch.where(b1 > a0, j1, i0)
    e2 = p2_lo > a1
    p2 = (torch.where(e2, INF, p2_lo), torch.where(e2, INF, a1), p2_lo_id, i1)
    return [p1, p2]


def eval_tree_intervals(tree, leaf_intervals):
    """Evaluate a supports-intervals tree to a list of id-carrying
    intervals ``(lo, hi, lo_id, hi_id)``, in the fold order every engine
    uses (difference pieces expand depth first)."""
    if tree[0] == LEAF:
        return [leaf_intervals[tree[1]]]
    op_name, l_tree, r_tree = tree
    left = eval_tree_intervals(l_tree, leaf_intervals)
    b = leaf_intervals[r_tree[1]]
    if op_name == "intersect":
        return [interval_intersect(iv, b) for iv in left]
    out = []
    for iv in left:
        out.extend(interval_difference(iv, b))
    return out


def leaf_intervals_from_hits(sorted_leaf_hits):
    """Attach leaf-slot ids to a list of sorted ``(2, ...)`` hit pairs."""
    out = []
    for slot, hits in enumerate(sorted_leaf_hits):
        ids = torch.full(hits.shape[1:], slot, dtype=torch.int32, device=hits.device)
        out.append((hits[0], hits[1], ids, ids))
    return out

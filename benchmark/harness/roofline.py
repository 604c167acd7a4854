"""The least time the card needs for the functions a step or call computes.

Bytes and operations are counted from the run's own masks, each input byte
read once and each output byte written once, at the published peaks of one
NVIDIA H100 SXM (NVIDIA's data sheet, dense, 700 W).  The arithmetic is
that of ``chip_smoke.py`` (``bound``, ``narrow_bwd_bytes``, the K1 and K2
byte counts, ``flops_per_ray_generation``), copied here so that the
yardstick stays fixed.  The counts belong to the functions, not to a
kernel: the forward trace (rays and scene tables in, every generation's
records, masks and the final state out) and the loss's backward (the
records of the generations each ray ran, the masks and the initial state
in, the state and table cotangents out), whichever kernels compute them.
"""

from __future__ import annotations

import torch

PEAK_BYTES = 3.35e12  # HBM bytes/s
PEAK_F32 = 67e12  # float32 FLOP/s outside the tensor cores

# floating-point operations per ray and generation run, counted from the
# CUDA sources (an FMA counts 2, a compare or select 0): a leaf's
# world-to-object transform and intersector, the hit leaf's normal,
# refraction with its Sellmeier index, record, tilt and push-off; the
# backward adds the re-intersection and the adjoints, and the sums of the
# hit leaf's 18 and the glass row's 7 parameter cotangents
LOCAL_RAY = 33
INTERSECT = {"sphere": 26, "paraboloid": 30, "plane": 12, "cube": 14, "cylinder": 28}
INTERACT = 140
ADJOINT = 400
PARAM_SUMS = 18 + 7


def bound(bytes_moved: float, flops: float):
    """(least ms, "bytes" or "operations") at the published peaks."""
    t_bytes = bytes_moved / PEAK_BYTES * 1e3
    t_ops = flops / PEAK_F32 * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def generations_ran(records, masks):
    """(G, n) bool: generation 0 for every ray; generation g > 0 where the
    mask of g - 1 is set and the record's input direction is nonzero."""
    ran = torch.zeros_like(masks)
    ran[0] = True
    ran[1:] = masks[:-1] & (records[1:, 12:15] != 0).any(dim=1)
    return ran


def table_bytes(n_leaves: int, n_glass: int, item: int) -> int:
    """The scene tables read and their cotangents written (22 numbers a
    leaf, 7 a glass row)."""
    return item * (22 * n_leaves + 7 * n_glass) * 2


def forward_bytes(masks, n_leaves: int, n_glass: int, item: int) -> int:
    """The trace: every generation's 15 record rows and its mask written,
    the 13 state rows in and out, the scene tables."""
    g, n = masks.shape
    return item * (15 * g * n + 2 * 13 * n) + g * n + table_bytes(n_leaves, n_glass, item)


def backward_bytes(records, masks, n_leaves: int, n_glass: int, item: int) -> int:
    """The loss's backward (``narrow_bwd_bytes``' loss-fused count): 15
    record rows per generation a ray ran, 3 tilt rows per generation it did
    not run after a set mask, masks[0..G-2] and the last run mask, 11 state
    rows in and 13 written, the tables."""
    g, n = masks.shape
    run = generations_ran(records, masks)
    ran = int(run.sum())
    skip_checks = int((masks[:-1] & ~run[1:]).sum())
    return (item * (15 * ran + 3 * skip_checks + 11 * n + 13 * n) + (g - 1) * n
            + int(run[-1].sum()) + table_bytes(n_leaves, n_glass, item))


def ray_generations(records, masks) -> int:
    return int(generations_ran(records, masks).sum())


def forward_flops(ran: int, leaf_kinds_per_ray) -> int:
    """``ran`` ray-generations, each testing the leaves in
    ``leaf_kinds_per_ray`` (every leaf of a narrow scene; the single trees
    and one tree of a batched group in a wide one, the least a cull
    leaves), then one interaction."""
    return ran * (sum(LOCAL_RAY + INTERSECT[k] for k in leaf_kinds_per_ray) + INTERACT)


def backward_flops(ran: int, leaf_kinds_per_ray) -> int:
    return forward_flops(ran, leaf_kinds_per_ray) + ran * (ADJOINT + PARAM_SUMS)


def step_bound(records, masks, n_leaves, n_glass, leaf_kinds_per_ray, item, backward):
    """(least ms, bounding resource, bytes, flops) of a forward trace, plus
    its loss backward when ``backward``."""
    ran = ray_generations(records, masks)
    n_bytes = forward_bytes(masks, n_leaves, n_glass, item)
    flops = forward_flops(ran, leaf_kinds_per_ray)
    if backward:
        n_bytes += backward_bytes(records, masks, n_leaves, n_glass, item)
        flops += backward_flops(ran, leaf_kinds_per_ray)
    ms, by = bound(n_bytes, flops)
    return ms, by, n_bytes, flops

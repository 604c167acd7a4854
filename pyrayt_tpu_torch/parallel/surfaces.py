"""Surface-axis (tensor-parallel) sharding of the nearest-hit pass
(counterpart of ``pyrayt_tpu.parallel.surfaces``).

When a scene's leaf count is large (lens and microlens arrays), the
(leaves x rays) intersection sweep is the term that grows with the scene.
This module shards the LEAF axis over the ranks of a mesh axis: each rank
intersects every ray against its own leaves, folds a local nearest
positive hit, and two MIN all-reduces combine (distance, then winning
global leaf index; losers send 2**31 - 1), so ties resolve to the smallest
global leaf index, the replicated fold's order.  Rays and results are
replicated along the axis; the axis must span the whole mesh.

Scope, as in the JAX package: :func:`build_surface_sharded_nearest_hit`
folds homogeneous scenes (one primitive type, plain surfaces);
:func:`build_wide_sharded_trace_fn` runs a complete trace with the tree
axis of every wide group (``engine.wide_plan``) split over the ranks.  No
kernel sits behind either: they run the plain engine's fold, as the JAX
package runs its XLA engine.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from pyrayt_tpu_torch.core.operations import INF, affine_inverse
from pyrayt_tpu_torch.parallel.mesh import Mesh
from pyrayt_tpu_torch.tracer import engine

__all__ = [
    "pad_leaf_tables",
    "build_surface_sharded_nearest_hit",
    "build_wide_sharded_trace_fn",
]

_NO_LEAF = 2**31 - 1


def pad_leaf_tables(world, prim_params, multiple: int):
    """Pad (S, 4, 4) world transforms and (S, P) primitive params so S
    divides ``multiple``.  Padding leaves are identity transforms moved to
    x = 1e30 with zero primitive params: no representable ray reaches
    them, so they never win the fold.  Returns ``(world, prim, S)``."""
    s = world.shape[0]
    s_pad = -(-s // multiple) * multiple
    if s_pad == s:
        return world, prim_params, s
    pad = torch.eye(4, dtype=world.dtype, device=world.device)
    pad[0, 3] = 1e30
    world = torch.cat((world, pad.expand(s_pad - s, 4, 4)))
    prim_params = torch.cat(
        (prim_params, prim_params.new_zeros((s_pad - s, prim_params.shape[1])))
    )
    return world, prim_params, s


def _local_nearest(type_code, world, prim_params, rays, leaf_offset):
    """Nearest positive hit over these leaves: ``world`` (S, 4, 4),
    ``prim_params`` (S, P), ``rays`` (2, 4, n) -> ((n,) distance, (n,)
    global leaf index int32, -1 where nothing hit)."""
    local = engine._local_xyz_rays_batched(affine_inverse(world), rays)
    hits = engine._leaf_intersect_batched(type_code, local, prim_params)  # (2, S, n)
    cand = torch.where(hits > 0, hits, INF).amin(dim=0)  # (S, n) per-leaf nearest
    win = torch.argmin(cand, dim=0)  # the first (smallest index) wins ties
    dist_ = torch.gather(cand, 0, win[None])[0]
    leaf = torch.where(torch.isinf(dist_), -1, win + leaf_offset).to(torch.int32)
    return dist_, leaf


def _min_combine(mesh: Mesh, dist_, leaf):
    """The global nearest over the mesh: MIN of the distances, then MIN of
    the winning leaf index among the ranks that hold the minimum."""
    g_dist = mesh.all_reduce(dist_, dist.ReduceOp.MIN)
    cand = torch.where((dist_ == g_dist) & (leaf >= 0), leaf, _NO_LEAF)
    g_leaf = mesh.all_reduce(cand, dist.ReduceOp.MIN)
    return g_dist, torch.where(torch.isinf(g_dist), -1, g_leaf).to(torch.int32)


def _axis_rank(mesh: Mesh, axis_name: str):
    """(axis size, this rank's index) of ``axis_name``, which must span the
    mesh: the MIN combine reduces over every rank."""
    n_shards = mesh.shape[axis_name]
    if n_shards != mesh.size:
        raise ValueError(
            f"axis {axis_name!r} of size {n_shards} must span the mesh's {mesh.size} ranks"
        )
    return n_shards, mesh.index(axis_name)


def build_surface_sharded_nearest_hit(type_code: int, mesh: Mesh, axis_name: str = "surfaces"):
    """``fn(world (S,4,4), prim_params (S,P), rays (2,4,n)) ->
    (hit_distances (n,), hit_leaf (n,))`` with the leaf axis sharded over
    ``mesh[axis_name]``: every rank passes the full tables and folds its
    contiguous block of S / axis-size leaves.  S must be divisible by the
    axis size (:func:`pad_leaf_tables`).  Ties resolve to the smallest
    global leaf index; ``-1`` where nothing hit."""
    n_shards, shard = _axis_rank(mesh, axis_name)

    def fn(world, prim_params, rays):
        s = world.shape[0]
        if s % n_shards:
            raise ValueError(f"{s} leaves not divisible by axis {axis_name!r} of size {n_shards}")
        s_local = s // n_shards
        lo = shard * s_local
        d, leaf = _local_nearest(
            type_code, world[lo:lo + s_local], prim_params[lo:lo + s_local], rays, lo
        )
        return _min_combine(mesh, d, leaf)

    return fn


def replicated_nearest_hit(type_code: int, world, prim_params, rays):
    """Single-device version of the same fold (the reference of the
    equality tests)."""
    return _local_nearest(type_code, world, prim_params, rays, 0)


# ---------------------------------------------------------------------------
# The surface-sharded trace
#
# Scene tables stay replicated (they are small); what shards is the
# (trees x rays) sweep of every wide group.  Each rank folds its block of
# every group's trees plus the (replicated) other trees, the MIN combine
# merges the folds, and the rest of the generation step runs replicated
# from the combined winner.
# ---------------------------------------------------------------------------


class _ShardedNearest(torch.autograd.Function):
    """The MIN combine of the ranks' partial folds, differentiable.

    Backward: the distance cotangent goes to the rank(s) whose fold holds
    the minimum, split evenly among tied ranks (the subgradient of the JAX
    package's ``jnp.min(all_gather(dist))``); each rank differentiates its
    own fold (recomputed), and the cotangents of the tables and rays are
    summed over the ranks in rank order, so every rank returns the whole
    gradient, bit-identical across ranks."""

    @staticmethod
    def forward(ctx, obj_tx, prim, rays, local_fold, mesh):
        d, leaf = local_fold(obj_tx, prim, rays)
        g_dist, g_leaf = _min_combine(mesh, d, leaf)
        ctx.save_for_backward(obj_tx, prim, rays, d, g_dist)
        ctx.local_fold, ctx.mesh = local_fold, mesh
        ctx.mark_non_differentiable(g_leaf)
        return g_dist, g_leaf

    @staticmethod
    def backward(ctx, d_gdist, d_gleaf):
        del d_gleaf
        obj_tx, prim, rays, d, g_dist = ctx.saved_tensors
        mesh = ctx.mesh
        tie = (d == g_dist).to(d.dtype)
        count = mesh.all_reduce(tie, dist.ReduceOp.SUM)
        d_local = torch.where(tie > 0, d_gdist / count, 0.0)
        inputs = [t.detach().requires_grad_(need)
                  for t, need in zip((obj_tx, prim, rays), ctx.needs_input_grad[:3])]
        wanted = [t for t in inputs if t.requires_grad]
        with torch.enable_grad():
            local_d, _ = ctx.local_fold(*inputs)
            grads = torch.autograd.grad(local_d, wanted, d_local, allow_unused=True)
        grads = iter(mesh.ordered_sum(
            [torch.zeros_like(t) if g is None else g for t, g in zip(wanted, grads)]))
        return tuple(next(grads) if t.requires_grad else None for t in inputs) + (None, None)


def build_wide_sharded_trace_fn(scene, config, mesh: Mesh, axis_name: str = "surfaces"):
    """``fn(params, rays: RaySet) -> TraceResult`` with every wide tree
    group's trees split over ``mesh[axis_name]``; every rank passes the
    same rays and gets the whole result.  The plain engine runs the trace
    (``engine._build_trace_fn`` with the combined fold as its
    ``nearest_fn``); reverse mode through it gives every rank the whole
    gradient.

    Raises ValueError when the scene has no batchable group
    (``engine.wide_plan``) or a group's tree count does not divide the axis
    size.
    """
    spec, materials = scene.spec, scene.materials
    _, groups = engine.wide_plan(spec)
    if not groups:
        raise ValueError(
            "scene has no batchable tree group (need >= "
            f"{engine._WIDE_GROUP_MIN} same-shape components); use ray-axis DP"
        )
    n_shards, shard = _axis_rank(mesh, axis_name)
    for _, _, slot_matrix in groups:
        if len(slot_matrix) % n_shards:
            raise ValueError(
                f"group of {len(slot_matrix)} trees not divisible by "
                f"axis '{axis_name}' of size {n_shards}"
            )
    local_blocks = {}
    for gi, (_, _, slot_matrix) in enumerate(groups):
        t_local = len(slot_matrix) // n_shards
        local_blocks[gi] = torch.as_tensor(
            slot_matrix[shard * t_local:(shard + 1) * t_local], dtype=torch.long,
            device=mesh.device)

    def local_fold(obj_tx, prim, rays):
        return engine.scene_nearest_hit(
            spec, {"obj_tx": obj_tx, "prim": prim}, rays,
            group_slots_fn=lambda gi, slot_matrix: local_blocks[gi])

    def sharded_nearest(tables, rays):
        return _ShardedNearest.apply(tables["obj_tx"], tables["prim"], rays, local_fold, mesh)

    return engine._build_trace_fn(spec, materials, config, nearest_fn=sharded_nearest)

"""The plain PyTorch trace engine (narrow scenes).

Counterpart of the narrow part of ``pyrayt_tpu.tracer.engine``: the
INITIALIZE -> (PROPAGATE -> INTERACT)* -> FINISH loop over fixed-size
structure-of-arrays tensors.

* PROPAGATE: every leaf surface is intersected against every ray; static
  CSG trees combine the leaf intervals (closed-form intervals, or the
  comparator network for general trees); a min-fold picks the nearest
  positive hit.
* INTERACT: normals per leaf under that leaf's hit mask, materials per
  material slot under dispatch masks.
* RECORD: each generation writes a ``(15, n)`` block of a preallocated
  ``(G, 15, n)`` buffer; dead rays are masked, never compacted.

Autograd differentiates the whole loop; every ``where`` that selects
between a live and a guarded branch keeps the guard on the argument of
``sqrt`` and of each division, so an unselected branch never leaks a NaN
cotangent.  This engine is the autograd oracle of the backward kernels
(ops/fused_grad.py).

Two loop drivers share the step: an early-exit loop (stops when all rays
are dead) and ``fixed_loop`` (always ``generation_limit`` steps).  This
engine runs on any device and is the reference the CUDA kernel
(ops/fused_trace.py) is tested against.  Scenes past 32 leaves need the
wide engine, which the port has not reached yet.
"""

from __future__ import annotations

import dataclasses
from functools import lru_cache

import torch
from torch.utils.checkpoint import checkpoint

from pyrayt_tpu_torch import materials as matl
from pyrayt_tpu_torch.config import TraceConfig
from pyrayt_tpu_torch.core import primitives as prim
from pyrayt_tpu_torch.core.csg import csg_combine_with_ids
from pyrayt_tpu_torch.core.intervals import eval_tree_intervals, tree_supports_intervals
from pyrayt_tpu_torch.core.operations import (
    INF,
    _norm_rows,
    _sum_rows,
    affine_inverse,
    isclose,
    reflect,
    refract,
    safe_normalize,
)
from pyrayt_tpu_torch.scene.compile import LEAF, OP_BY_NAME, CompiledScene, SceneSpec
from pyrayt_tpu_torch.tracer.rayset import RaySet

__all__ = [
    "TraceResult",
    "trace_rays",
    "build_trace_fn",
    "scene_tables",
    "N_RECORD_COLS",
    "MAX_NARROW_LEAVES",
]

# record columns: generation, intensity, wavelength, index, id, surface,
#                 x0, y0, z0, x1, y1, z1, x_tilt, y_tilt, z_tilt
N_RECORD_COLS = 15

# leaf count past which a scene needs the wide engine (not ported yet)
MAX_NARROW_LEAVES = 32


@dataclasses.dataclass
class TraceResult:
    records: torch.Tensor  # (G, 15, n)
    record_mask: torch.Tensor  # (G, n) bool
    final_rays: RaySet
    generations_run: torch.Tensor  # scalar int


def check_narrow(spec: SceneSpec) -> None:
    """Raise for scenes the narrow engines do not cover."""
    if spec.n_leaves > MAX_NARROW_LEAVES:
        raise NotImplementedError(
            f"scene has {spec.n_leaves} leaf surfaces; past {MAX_NARROW_LEAVES} "
            "it needs the wide engine, which the port has not reached yet "
            "(ROADMAP.md, modules to port: wide engine, kernel K2)"
        )


def scene_tables(params):
    """Per-trace scene tables: object transforms ``obj_tx`` (S, 4, 4) =
    inverse of ``world``, plus the ``prim`` and ``glass`` rows."""
    return {
        "obj_tx": affine_inverse(params["world"]),
        "prim": params["prim"],
        "glass": params["glass"],
    }


# ---------------------------------------------------------------------------
# PROPAGATE: nearest-hit search over the flattened scene
# ---------------------------------------------------------------------------


def _local_xyz_rays(m, rays):
    """Object-space (2, 3, n) xyz rays as scalar multiply-adds (an affine
    ``m``, last row 0,0,0,1): no matmul, so no reduced-precision path."""
    p, v = rays[0], rays[1]
    lo = torch.stack(
        [m[i, 0] * p[0] + m[i, 1] * p[1] + m[i, 2] * p[2] + m[i, 3] * p[3] for i in range(3)]
    )
    ld = torch.stack([m[i, 0] * v[0] + m[i, 1] * v[1] + m[i, 2] * v[2] for i in range(3)])
    return torch.stack((lo, ld))


def _sorted_pair(pair):
    return torch.stack((torch.minimum(pair[0], pair[1]), torch.maximum(pair[0], pair[1])))


def _eval_tree(tree, leaf_hits):
    """Evaluate a static CSG tree -> sorted (hits, leaf-slot ids)."""
    if tree[0] == LEAF:
        slot = tree[1]
        hits = leaf_hits[slot]
        ids = torch.full(hits.shape, slot, dtype=torch.int32, device=hits.device)
        return hits, ids
    op_name, l_tree, r_tree = tree
    l_hits, l_ids = _eval_tree(l_tree, leaf_hits)
    r_hits, r_ids = _eval_tree(r_tree, leaf_hits)
    return csg_combine_with_ids(l_hits, l_ids, r_hits, r_ids, OP_BY_NAME[op_name])


def _tree_slots(tree):
    if tree[0] == LEAF:
        return (tree[1],)
    return _tree_slots(tree[1]) + _tree_slots(tree[2])


def scene_nearest_hit(spec: SceneSpec, tables, rays):
    """Nearest positive hit over all components: ``(hit_distances (n,),
    hit_leaf (n,) int32)`` with ``hit_leaf = -1`` for rays that hit nothing.

    Trees fold in order; interval trees fold lo then hi per interval, in
    ``eval_tree_intervals`` order, network trees row by row; the fold is a
    strict ``<``, so the first of equal candidates wins.
    """
    n = rays.shape[-1]
    obj_tx = tables["obj_tx"]
    hit_distances = torch.full((n,), INF, dtype=rays.dtype, device=rays.device)
    hit_leaf = torch.full((n,), -1, dtype=torch.int32, device=rays.device)

    def fold(cand, ids):
        nonlocal hit_distances, hit_leaf
        cand = torch.where(cand > 0, cand, INF)
        new_min = cand < hit_distances
        hit_distances = torch.where(new_min, cand, hit_distances)
        hit_leaf = torch.where(new_min, ids, hit_leaf)

    for tree in spec.trees:
        hits = {
            s: _sorted_pair(
                prim.leaf_intersect(
                    spec.leaf_types[s], _local_xyz_rays(obj_tx[s], rays), tables["prim"][s]
                )
            )
            for s in _tree_slots(tree)
        }
        if tree_supports_intervals(tree):
            intervals = {}
            for s, h in hits.items():
                ids = torch.full((n,), s, dtype=torch.int32, device=rays.device)
                intervals[s] = (h[0], h[1], ids, ids)
            for lo, hi, lo_id, hi_id in eval_tree_intervals(tree, intervals):
                fold(lo, lo_id)
                fold(hi, hi_id)
        else:
            shape_hits, shape_ids = _eval_tree(tree, hits)
            for row in range(shape_hits.shape[0]):
                fold(shape_hits[row], shape_ids[row])
    return hit_distances, hit_leaf


# ---------------------------------------------------------------------------
# INTERACT: normals + masked material physics
# ---------------------------------------------------------------------------


def leaf_needs_normal(spec: SceneSpec, s: int) -> bool:
    """False for leaves whose packed absorber never reads a normal."""
    slot = spec.leaf_mat_slot[s]
    return not (spec.mat_packed[slot] and spec.mat_kinds[slot] == matl.KIND_ABSORB)


def _world_normals(spec: SceneSpec, tables, hit_leaf, hit_points):
    """Per-ray world normals of each ray's hit leaf, masked-accumulated
    (inverse-transpose transform, renormalized with a zero-length guard,
    times the leaf's normal scale)."""
    normals = torch.zeros_like(hit_points)
    for s, type_code in enumerate(spec.leaf_types):
        if not leaf_needs_normal(spec, s):
            continue
        m = tables["obj_tx"][s]
        hp = hit_points
        local_points = torch.stack(
            [
                m[i, 0] * hp[0] + m[i, 1] * hp[1] + m[i, 2] * hp[2] + m[i, 3] * hp[3]
                for i in range(3)
            ]
            + [hp[3]]
        )
        ln = prim.leaf_normal(type_code, local_points, tables["prim"][s])
        world = torch.stack(
            [m[0, i] * ln[0] + m[1, i] * ln[1] + m[2, i] * ln[2] for i in range(3)]
            + [torch.zeros_like(ln[0])]
        )
        sq = _sum_rows(world * world)
        zero = sq == 0
        world = torch.where(zero, world, world / torch.sqrt(torch.where(zero, 1.0, sq)))
        world = world * spec.leaf_normal_scale[s]
        normals = torch.where(hit_leaf == s, world, normals)
    return normals


def _apply_materials(
    spec: SceneSpec,
    materials,
    tables,
    config: TraceConfig,
    ray_slot,
    no_hit,
    directions,
    normals,
    wavelength,
    index,
    intensity,
):
    """Masked material dispatch: ``(new_dir, new_index, new_intensity)``."""
    new_dir = torch.where(no_hit, 0.0, directions)
    new_index = index
    new_intensity = intensity
    for slot, kind in enumerate(spec.mat_kinds):
        mask = (ray_slot == slot) & ~no_hit
        packed = spec.mat_packed[slot]
        if packed and kind == matl.KIND_ABSORB:
            d2, i2, t2 = torch.zeros_like(directions), index, intensity
        elif packed and kind == matl.KIND_MIRROR:
            d2, i2, t2 = reflect(directions, normals), index, intensity
        elif packed and kind == matl.KIND_GLASS:
            n2 = matl.index_from_coeffs(tables["glass"][slot], wavelength)
            d2, i2 = refract(directions, normals, index, n2, n_global=config.world_index)
            t2 = intensity
        else:
            d2, i2, t2 = materials[slot].pure_trace(
                directions, normals, wavelength, index, intensity
            )
        new_dir = torch.where(mask, d2, new_dir)
        new_index = torch.where(mask, i2, new_index)
        new_intensity = torch.where(mask, t2, new_intensity)
    return new_dir, new_index, new_intensity


# ---------------------------------------------------------------------------
# one generation step
# ---------------------------------------------------------------------------


def generation_step(spec, materials, config, tables, state):
    """One PROPAGATE + INTERACT + RECORD step on masked SoA state.

    ``state`` is ``(rays: RaySet, alive: (n,) bool)``; returns the new
    state, the (15, n) record block and its row mask (``living``).
    """
    rays_state, alive = state
    p_old = rays_state.positions
    v_old = rays_state.directions
    rays = torch.stack((p_old, v_old))

    hit_distances, hit_leaf = scene_nearest_hit(spec, tables, rays)
    no_hit = hit_leaf < 0

    # advance to the hit point (no-hit rays stay put)
    t_safe = torch.where(no_hit, 0.0, hit_distances)
    p_hit = p_old + t_safe * v_old

    normals = _world_normals(spec, tables, hit_leaf, p_hit)

    ray_slot = torch.zeros_like(hit_leaf)
    for s, slot in enumerate(spec.leaf_mat_slot):
        ray_slot = torch.where(hit_leaf == s, slot, ray_slot)
    new_dir, new_index, new_intensity = _apply_materials(
        spec,
        materials,
        tables,
        config,
        ray_slot,
        no_hit,
        v_old,
        normals,
        rays_state.wavelength,
        rays_state.index,
        rays_state.intensity,
    )

    # death rules (the intensity test is opt-in, as in the JAX package)
    absorbed = isclose(_norm_rows(v_old), 0)
    dead = absorbed | no_hit
    if config.apply_intensity_threshold:
        dead = dead | (rays_state.intensity < config.intensity_threshold)
    living = alive & ~dead

    # record block: old metadata + hit surface + segment endpoints + tilts
    public_id = torch.zeros(hit_leaf.shape, dtype=rays.dtype, device=rays.device)
    for s, leaf_id in enumerate(spec.leaf_ids):
        public_id = torch.where(hit_leaf == s, float(leaf_id), public_id)
    tilt = safe_normalize(v_old[:3], dim=0)
    record = torch.cat((rays_state.metadata, public_id[None], p_old[:3], p_hit[:3], tilt))

    # state update: epsilon push-off, generation bump
    new_positions = p_hit + config.ray_offset * new_dir
    next_rays = rays_state.replace(
        positions=torch.where(living, new_positions, p_hit),
        directions=new_dir,
        generation=torch.where(living, rays_state.generation + 1, rays_state.generation),
        index=new_index,
        intensity=new_intensity,
    )
    return (next_rays, living), record, living


# ---------------------------------------------------------------------------
# loop drivers
# ---------------------------------------------------------------------------


@lru_cache(maxsize=64)
def build_trace_fn(spec: SceneSpec, materials, config: TraceConfig):
    """The plain trace for a static scene: ``fn(params, initial_rays) ->
    TraceResult``.  ``config.fixed_loop`` runs every generation; otherwise
    the loop stops once no ray is alive.  Differentiable by autograd;
    ``config.remat`` recomputes each generation in the backward pass."""
    check_narrow(spec)
    generations = config.generation_limit

    def step(*args):
        # remat: keep only each generation's inputs for reverse mode and
        # recompute its intermediates there (jax.checkpoint in the JAX
        # package); without grad there is nothing to save either way
        if config.remat and torch.is_grad_enabled():
            return checkpoint(generation_step, *args, use_reentrant=False)
        return generation_step(*args)

    def trace(params, initial_rays: RaySet) -> TraceResult:
        tables = scene_tables(params)
        n = initial_rays.n_rays
        kw = dict(device=initial_rays.device)
        records = torch.zeros((generations, N_RECORD_COLS, n), dtype=initial_rays.dtype, **kw)
        masks = torch.zeros((generations, n), dtype=torch.bool, **kw)
        carry = (initial_rays, torch.ones(n, dtype=torch.bool, **kw))
        for g in range(generations):
            if not config.fixed_loop and not bool(carry[1].any()):
                break
            carry, records[g], masks[g] = step(spec, materials, config, tables, carry)
        return TraceResult(
            records=records,
            record_mask=masks,
            final_rays=carry[0],
            generations_run=masks.any(dim=1).sum(),
        )

    return trace


def trace_rays(scene: CompiledScene, initial_rays: RaySet, config: TraceConfig) -> TraceResult:
    """Trace an initial RaySet through a compiled scene.

    Dispatch (ops.fused_trace.pick_fused): CUDA tensors with a scene whose
    materials are all packed (absorber / mirror / glass) run the CUDA
    kernel; ``config.use_fused=False``, custom Python materials and CPU
    tensors run this plain engine.  ``use_fused=True`` demands the kernel
    and raises where it cannot run.
    """
    from pyrayt_tpu_torch.ops import fused_trace as ft

    if ft.pick_fused(scene.spec, config, initial_rays.device):
        fn = ft.build_fused_trace_fn(scene.spec, scene.materials, config)
    else:
        fn = build_trace_fn(scene.spec, scene.materials, config)
    return fn(scene.params, initial_rays)

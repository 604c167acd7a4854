"""The plain PyTorch trace engine.

Counterpart of ``pyrayt_tpu.tracer.engine``: the INITIALIZE -> (PROPAGATE
-> INTERACT)* -> FINISH loop over fixed-size structure-of-arrays tensors.

* PROPAGATE: every leaf surface is intersected against every ray; static
  CSG trees combine the leaf intervals (closed-form intervals, or the
  comparator network for general trees); a min-fold picks the nearest
  positive hit.  Wide scenes (lens and microlens arrays) batch each group
  of same-shape trees (:func:`wide_plan`) into one (trees, rays) sweep.
* INTERACT: normals per leaf under that leaf's hit mask, materials per
  material slot under dispatch masks; wide scenes gather each ray's hit
  leaf from one packed per-leaf table instead.
* RECORD: each generation writes a ``(15, n)`` block of a preallocated
  ``(G, 15, n)`` buffer; dead rays are masked, never compacted.

Autograd differentiates the whole loop; every ``where`` that selects
between a live and a guarded branch keeps the guard on the argument of
``sqrt`` and of each division, so an unselected branch never leaks a NaN
cotangent.  This engine is the autograd oracle of the backward kernels
(ops/fused_grad.py).

Two loop drivers share the step: an early-exit loop (stops when all rays
are dead) and ``fixed_loop`` (always ``generation_limit`` steps).  This
engine runs on any device and is the reference the CUDA kernels
(ops/fused_trace.py) are tested against.  A wide group's (T, n) arrays
take T times the memory of a ray row (2 GiB each for the 16x16 array at
2^20 rays in float64), so on the card this engine serves as a reference on
a subset of the rays: chip_smoke.py holds the staged gradients against it
on every 64th ray.
"""

from __future__ import annotations

import dataclasses
from functools import lru_cache, partial

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
    "wide_plan",
    "N_RECORD_COLS",
    "MAX_NARROW_LEAVES",
]

# record columns: generation, intensity, wavelength, index, id, surface,
#                 x0, y0, z0, x1, y1, z1, x_tilt, y_tilt, z_tilt
N_RECORD_COLS = 15

# leaf count of the narrow kernels; wider scenes take the wide kernels
MAX_NARROW_LEAVES = 32


@dataclasses.dataclass
class TraceResult:
    records: torch.Tensor  # (G, 15, n)
    record_mask: torch.Tensor  # (G, n) bool
    final_rays: RaySet
    generations_run: torch.Tensor  # scalar int

    def replace(self, **changes) -> "TraceResult":
        """A copy with the named fields replaced (the JAX dataclass's
        ``replace``)."""
        return dataclasses.replace(self, **changes)


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


# ---------------------------------------------------------------------------
# Wide scenes: batched same-shape CSG trees (lens and microlens arrays)
#
# Trees of one shape signature (CSG structure and primitive types; the
# transforms, parameters, materials, normal scales and ids may all differ)
# stack along a tree axis T and evaluate the interval CSG once on (T, n)
# tensors.  A group folds into the nearest hit at its first member's
# position, and inside the group the lowest tree index wins a tie (the JAX
# engine's rule; exact cross-component ties have measure zero).
# ---------------------------------------------------------------------------

_WIDE_GROUP_MIN = 8  # trees of one signature before batching pays


def _tree_template(tree):
    """The tree with its leaf slots replaced by in-order positions 0..L-1."""

    def rec(t, counter):
        if t[0] == LEAF:
            counter[0] += 1
            return (LEAF, counter[0] - 1)
        return (t[0], rec(t[1], counter), rec(t[2], counter))

    return rec(tree, [0])


def _tree_sig(spec: SceneSpec, tree):
    """Shape signature: equal signatures share CSG structure and primitive
    types, so the trees batch."""
    if tree[0] == LEAF:
        return (LEAF, spec.leaf_types[tree[1]])
    return (tree[0], _tree_sig(spec, tree[1]), _tree_sig(spec, tree[2]))


@lru_cache(maxsize=256)
def wide_plan(spec: SceneSpec):
    """Static fold plan ``(order, groups)``: ``groups[i] = (template,
    types_pos, slot_matrix)`` is a batchable set of at least
    ``_WIDE_GROUP_MIN`` same-shape interval trees; ``order`` interleaves
    ``("group", i)`` (at the first member's position) with ``("single",
    tree_index)`` for every other tree."""
    by_sig = {}
    for ti, tree in enumerate(spec.trees):
        if tree_supports_intervals(tree):
            by_sig.setdefault(_tree_sig(spec, tree), []).append(ti)
    groups = []
    first_of_group = {}
    grouped = set()
    for tis in by_sig.values():
        if len(tis) >= _WIDE_GROUP_MIN:
            first = spec.trees[tis[0]]
            types_pos = tuple(spec.leaf_types[s] for s in _tree_slots(first))
            slot_matrix = tuple(_tree_slots(spec.trees[t]) for t in tis)
            first_of_group[tis[0]] = len(groups)
            groups.append((_tree_template(first), types_pos, slot_matrix))
            grouped.update(tis)
    order = []
    for ti in range(len(spec.trees)):
        if ti in first_of_group:
            order.append(("group", first_of_group[ti]))
        elif ti not in grouped:
            order.append(("single", ti))
    return tuple(order), tuple(groups)


def _local_xyz_rays_batched(m, rays):
    """(T, 4, 4) object transforms x (2, 4, n) rays -> (2, 3, T, n) local
    rays, as broadcast multiply-adds (no matmul)."""
    p, v = rays[0], rays[1]
    lo = torch.stack(
        [
            m[:, i, 0, None] * p[0] + m[:, i, 1, None] * p[1]
            + m[:, i, 2, None] * p[2] + m[:, i, 3, None] * p[3]
            for i in range(3)
        ]
    )
    ld = torch.stack(
        [m[:, i, 0, None] * v[0] + m[:, i, 1, None] * v[1] + m[:, i, 2, None] * v[2]
         for i in range(3)]
    )
    return torch.stack((lo, ld))


def _leaf_intersect_batched(type_code, local, pr):
    """``prim.leaf_intersect`` over a (T,)-batch of one leaf position:
    ``local`` (2, 3, T, n), ``pr`` (T, P) broadcast as (T, 1) columns."""
    return prim.leaf_intersect(type_code, local, [pr[:, i, None] for i in range(pr.shape[1])])


def _wide_group_candidates(template, types_pos, slots, prim_table, obj_tx, rays):
    """Per-tree nearest positive hit of one batched group: ``slots`` (T, L)
    global leaf slots -> ``(dist (T, n), leaf (T, n) int32)``, -1 where a
    tree hits nothing."""
    t_count, l_count = slots.shape
    n = rays.shape[-1]
    leaf_intervals = []
    for j in range(l_count):
        sj = slots[:, j]
        pair = _leaf_intersect_batched(
            types_pos[j], _local_xyz_rays_batched(obj_tx[sj], rays), prim_table[sj]
        )
        ids = sj.to(torch.int32)[:, None].expand(t_count, n)
        leaf_intervals.append(
            (torch.minimum(pair[0], pair[1]), torch.maximum(pair[0], pair[1]), ids, ids)
        )
    dist = torch.full((t_count, n), INF, dtype=rays.dtype, device=rays.device)
    leaf = torch.full((t_count, n), -1, dtype=torch.int32, device=rays.device)
    for lo, hi, lo_id, hi_id in eval_tree_intervals(template, leaf_intervals):
        for cand, ids in ((lo, lo_id), (hi, hi_id)):
            cand = torch.where(cand > 0, cand, INF)
            new_min = cand < dist
            dist = torch.where(new_min, cand, dist)
            leaf = torch.where(new_min, ids, leaf)
    return dist, leaf


def _reduce_tree_axis(dist, leaf):
    """(T, n) per-tree candidates -> per-ray nearest; ties pick the lowest
    tree index (``argmin`` returns the first minimum) for the leaf, while
    the distance is ``amin``, whose backward splits the cotangent evenly
    among tied trees, as the JAX engine's ``jnp.min`` does.  The wide
    kernels and their plain versions give it all to the first tree, as the
    JAX package's wide kernels do."""
    dmin = torch.amin(dist, dim=0)
    win = torch.argmin(dist, dim=0)
    lmin = torch.gather(leaf, 0, win[None])[0]
    return dmin, torch.where(torch.isinf(dmin), -1, lmin).to(torch.int32)


def scene_nearest_hit(spec: SceneSpec, tables, rays, group_slots_fn=None):
    """Nearest positive hit over all components: ``(hit_distances (n,),
    hit_leaf (n,) int32)`` with ``hit_leaf = -1`` for rays that hit nothing.

    Trees fold in order; interval trees fold lo then hi per interval, in
    ``eval_tree_intervals`` order, network trees row by row; the fold is a
    strict ``<``, so the first of equal candidates wins.  A wide group
    (:func:`wide_plan`) folds its per-ray nearest at its first member's
    position.

    ``group_slots_fn(group_index, slot_matrix) -> (T', L) long tensor``
    optionally restricts each wide group to a subset of its trees: the
    surface-sharded trace (``parallel/surfaces.py``) passes each rank's
    block and MIN-combines the partial folds.
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

    order, groups = wide_plan(spec)
    for kind, idx in order:
        if kind == "group":
            template, types_pos, slot_matrix = groups[idx]
            if group_slots_fn is not None:
                slots = group_slots_fn(idx, slot_matrix)
            else:
                slots = torch.as_tensor(slot_matrix, dtype=torch.long, device=rays.device)
            fold(*_reduce_tree_axis(*_wide_group_candidates(
                template, types_pos, slots, tables["prim"], obj_tx, rays)))
            continue
        for cand, ids in tree_candidates(spec, spec.trees[idx], tables, rays):
            fold(cand, ids)
    return hit_distances, hit_leaf


def tree_candidates(spec: SceneSpec, tree, tables, rays):
    """The hit candidates ``[(distance (n,), leaf slot (n,) int32), ...]``
    of one tree in fold order: lo then hi per interval, in
    ``eval_tree_intervals`` order, or the network's rows."""
    n = rays.shape[-1]
    obj_tx = tables["obj_tx"]
    hits = {
        s: _sorted_pair(
            prim.leaf_intersect(
                spec.leaf_types[s], _local_xyz_rays(obj_tx[s], rays), tables["prim"][s]
            )
        )
        for s in _tree_slots(tree)
    }
    if not tree_supports_intervals(tree):
        shape_hits, shape_ids = _eval_tree(tree, hits)
        return [(shape_hits[row], shape_ids[row]) for row in range(shape_hits.shape[0])]
    intervals = {}
    for s, h in hits.items():
        ids = torch.full((n,), s, dtype=torch.int32, device=rays.device)
        intervals[s] = (h[0], h[1], ids, ids)
    out = []
    for lo, hi, lo_id, hi_id in eval_tree_intervals(tree, intervals):
        out += [(lo, lo_id), (hi, hi_id)]
    return out


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


def _gathered_leaf_table(spec: SceneSpec, tables):
    """One packed (S, 16 + P + 5) per-leaf table for the wide INTERACT:
    object transform, primitive params, then type code, needs-normal,
    normal scale, material slot and public id as floats (all exactly
    representable)."""
    s_count = spec.n_leaves
    obj_tx = tables["obj_tx"]
    static_cols = torch.tensor(
        [
            [spec.leaf_types[s], float(leaf_needs_normal(spec, s)), spec.leaf_normal_scale[s],
             spec.leaf_mat_slot[s], spec.leaf_ids[s]]
            for s in range(s_count)
        ],
        dtype=obj_tx.dtype,
        device=obj_tx.device,
    )
    return torch.cat(
        (obj_tx.reshape(s_count, 16), tables["prim"].to(obj_tx.dtype), static_cols), dim=1
    )


def _world_normals_gathered(spec: SceneSpec, hit_leaf, hit_points, leaf_rows):
    """Per-ray world normals from each ray's gathered leaf row: one dense
    pass per primitive type present, not one per leaf."""
    p_width = leaf_rows.shape[1] - 21
    m16 = leaf_rows[:, :16]
    pr = [leaf_rows[:, 16 + i] for i in range(p_width)]
    types_of = leaf_rows[:, 16 + p_width]
    needs = leaf_rows[:, 17 + p_width] > 0.5
    scale = leaf_rows[:, 18 + p_width]
    hp = hit_points
    lp = [
        m16[:, 4 * i] * hp[0] + m16[:, 4 * i + 1] * hp[1]
        + m16[:, 4 * i + 2] * hp[2] + m16[:, 4 * i + 3] * hp[3]
        for i in range(3)
    ]
    valid = (hit_leaf >= 0) & needs
    n3 = [torch.zeros_like(hp[0]) for _ in range(3)]
    live_types = sorted(
        {spec.leaf_types[s] for s in range(spec.n_leaves) if leaf_needs_normal(spec, s)}
    )
    for t in live_types:
        mask = valid & (types_of == t)
        ln3 = prim.leaf_normal_raw3(t, lp, pr)
        # inverse-transpose: world_i = sum_j m[j][i] * ln_j
        wn3 = [m16[:, i] * ln3[0] + m16[:, 4 + i] * ln3[1] + m16[:, 8 + i] * ln3[2]
               for i in range(3)]
        n3 = [torch.where(mask, w, old) for w, old in zip(wn3, n3)]
    wn = torch.stack(n3)
    sq = _sum_rows(wn * wn)
    zero = sq == 0
    wn = torch.where(zero, wn, wn / torch.sqrt(torch.where(zero, 1.0, sq))) * scale
    return torch.cat((wn, torch.zeros_like(wn[:1])))


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


def generation_step(spec, materials, config, tables, state, nearest_fn=None):
    """One PROPAGATE + INTERACT + RECORD step on masked SoA state.

    ``state`` is ``(rays: RaySet, alive: (n,) bool)``; returns the new
    state, the (15, n) record block and its row mask (``living``).
    ``nearest_fn(tables, rays) -> (hit_distances, hit_leaf)`` overrides the
    PROPAGATE search (the surface-sharded trace of ``parallel/surfaces.py``
    injects its collective fold here).
    """
    rays_state, alive = state
    p_old = rays_state.positions
    v_old = rays_state.directions
    rays = torch.stack((p_old, v_old))

    nearest = nearest_fn if nearest_fn is not None else partial(scene_nearest_hit, spec)
    hit_distances, hit_leaf = nearest(tables, rays)
    no_hit = hit_leaf < 0

    # advance to the hit point (no-hit rays stay put)
    t_safe = torch.where(no_hit, 0.0, hit_distances)
    p_hit = p_old + t_safe * v_old

    wide = bool(wide_plan(spec)[1])
    if wide:
        # one packed-table gather feeds the normals, the material slot and
        # the record's public id
        leaf_rows = _gathered_leaf_table(spec, tables)[hit_leaf.clamp(0, spec.n_leaves - 1).long()]
        p_width = leaf_rows.shape[1] - 21
        normals = _world_normals_gathered(spec, hit_leaf, p_hit, leaf_rows)
        ray_slot = torch.where(no_hit, 0.0, leaf_rows[:, 19 + p_width])
    else:
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
    if wide:
        public_id = torch.where(no_hit, 0.0, leaf_rows[:, 20 + p_width])
    else:
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
    return _build_trace_fn(spec, materials, config)


def _build_trace_fn(spec: SceneSpec, materials, config: TraceConfig, nearest_fn=None):
    """Uncached builder; ``nearest_fn(tables, rays)`` optionally replaces
    the PROPAGATE search (see ``parallel/surfaces.py``)."""
    generations = config.generation_limit

    def step(*args):
        # remat: keep only each generation's inputs for reverse mode and
        # recompute its intermediates there (jax.checkpoint in the JAX
        # package); without grad there is nothing to save either way
        if config.remat and torch.is_grad_enabled():
            return checkpoint(generation_step, *args, nearest_fn=nearest_fn,
                              use_reentrant=False)
        return generation_step(*args, nearest_fn=nearest_fn)

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
    materials are all packed (absorber / mirror / glass) run the narrow
    kernel K1, or past 32 leaves the wide kernel K2 when the scene has a
    batchable group of same-shape trees; ``config.use_fused=False``,
    custom Python materials, wide scenes with no batchable group and CPU
    tensors run this plain engine.  ``use_fused=True`` demands a kernel
    and raises where none can run.
    """
    from pyrayt_tpu_torch.ops import fused_trace as ft

    if ft.pick_fused(scene.spec, config, initial_rays.device):
        fn = ft.build_fused_trace_fn(scene.spec, scene.materials, config)
    else:
        fn = build_trace_fn(scene.spec, scene.materials, config)
    return fn(scene.params, initial_rays)

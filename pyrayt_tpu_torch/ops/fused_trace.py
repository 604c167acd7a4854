"""The forward trace kernels on CUDA, their wrappers and their plain
PyTorch versions: the narrow K1 (at most 32 leaves) and the wide K2 (lens
and microlens arrays: more leaves, in groups of same-shape trees).

The kernel (``csrc/fused_trace.cu``) replaces the Pallas kernel built by
``pyrayt_tpu/ops/fused_trace.py:_make_step`` and driven by
``_run_while_kernel``: the whole bounce loop of a narrow scene (at most 32
leaf surfaces, packed materials only) in one launch, one thread per ray.
The scene is runtime data: a host-side "scene program" built once per
``SceneSpec`` (:func:`scene_program`) lists the leaves and, per tree, the
interval ops or the comparator-network steps, so one build of the kernel
serves every scene and moving a lens never rebuilds it.

Three functions share one signature ``(spec, config, state, obj_tx, prim,
glass) -> (records (G, 15, n), masks (G, n) bool, final state (13, n))``:

* :func:`fused_trace` — the wrapper: CUDA tensors launch the kernel (or
  raise); CPU tensors run the plain version;
* :func:`fused_trace_plain` — the plain version, built on the plain
  engine's generation step (tracer/engine.py);
* the kernel itself, reached only through the wrapper.

Contract, shared by both versions (the per-ray exit):

* a ray runs generation g when it was alive after generation g-1 (every
  ray runs generation 0); it stops after the generation in which it died
  or was absorbed (its new direction is zero);
* masks, masked records, the final state and ``generations_run`` equal
  those of the JAX engine, whose loop instead steps every ray until all
  are dead; unmasked record rows of generations a ray did not run are
  zero, and a stopped ray keeps its state;
* a global loop keeps stepping dead rays, so the final state differs
  where a dead ray still moves: with ``apply_intensity_threshold=True`` a
  threshold-killed ray keeps advancing there, and a zero-direction ray
  inside a glass paraboloid's volume "hits" it and refracts to a nonzero
  direction.  Here both keep their last state.

The wide kernel (``csrc/wide_trace.cu``) replaces the Pallas kernel of
``pyrayt_tpu/ops/fused_trace.py:_make_step_wide``.  Its host tables
(:func:`wide_tables`, :func:`wide_runtime_tables`, :func:`leaf_meta_table`,
:func:`wide_fold_plan`) equal the JAX package's, so its win codes name the
same trees; its scene program is :func:`wide_program`, and it culls by the
port's own tight boxes (:func:`wide_cull_tables`).  :func:`fused_trace_wide`,
its plain version :func:`fused_trace_wide_plain` and the kernel share the
per-ray exit contract above, and with ``save_fold`` also return the fold
(``fold5``, ``win``) the staged backward reads.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from functools import lru_cache
from pathlib import Path

import numpy as np
import torch

from pyrayt_tpu_torch import materials as matl
from pyrayt_tpu_torch.config import TraceConfig
from pyrayt_tpu_torch.core import primitives as prim_mod
from pyrayt_tpu_torch.core.intervals import tree_supports_intervals
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
from pyrayt_tpu_torch.ops.sortnet import batcher_pairs
from pyrayt_tpu_torch.scene.compile import LEAF, OP_BY_NAME, SceneSpec
from pyrayt_tpu_torch.tracer import engine
from pyrayt_tpu_torch.tracer.rayset import RaySet

__all__ = [
    "supports_fused",
    "pick_fused",
    "scene_program",
    "build_kernels",
    "KERNEL_SOURCES",
    "fused_trace",
    "fused_trace_plain",
    "kernel_inputs",
    "build_fused_trace_fn",
]

_PACKED_KINDS = (matl.KIND_ABSORB, matl.KIND_MIRROR, matl.KIND_GLASS)

# capacities of the kernel's per-thread CSG lists; keep equal to
# kMaxIntervals / kMaxRows in csrc/fused_trace.cu
MAX_INTERVALS = 16
MAX_NET_ROWS = 16

# scene-program opcodes; keep equal to the Opcode enum in csrc/fused_trace.cu
IV_LOAD, IV_AND, IV_SUB, IV_FOLD, NET_PUSH, NET_COMBINE, NET_FOLD = range(7)

_CSRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
# one shared library per kernel source; every source includes the headers
KERNEL_SOURCES = ("fused_trace.cu", "fused_grad.cu", "wide_trace.cu", "wide_grad.cu",
                  "wide_fused_grad.cu")
_HEADERS = ("trace_common.cuh", "adjoint_common.cuh", "wide_common.cuh", "row_reduce.cuh")
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"


def supports_fused(spec: SceneSpec) -> bool:
    """The kernel covers narrow scenes whose materials are all packed
    (absorber / mirror / glass); custom Python materials run the plain
    engine, as in the JAX package."""
    return (
        0 < spec.n_leaves <= engine.MAX_NARROW_LEAVES
        and all(spec.mat_packed)
        and all(k in _PACKED_KINDS for k in spec.mat_kinds)
    )


def supports_fused_wide(spec: SceneSpec) -> bool:
    """True when the wide kernel K2 (and the wide backward, K5-K7 or K8) covers
    the scene: packed materials, more than 32 leaves, at least one
    batchable group of same-shape trees (``engine.wide_plan``), and at most
    32 leaves in the trees outside the groups.  A wide scene with no
    batchable group runs the plain engine, as in the JAX package.

    The JAX package also caps wide scenes at 4096 leaves: its kernels hold
    every scene table in the TPU's scalar memory.  K2 reads the group
    tables from global memory, so that cap has no counterpart here and is
    dropped; only the singles' tables and the program sit in shared memory.
    The backward's table reduce (``csrc/row_reduce.cuh``) is a counting
    sort by row key, so its work grows as rays + leaves; its shared-memory
    row counters cap a group's or K8's reduce at 51,200 leaves, and its
    int32 indices at 2**31 - 1 entries.  The gradient's dispatch
    (``ops.fused_grad.pick_fused_grad``) sends a scene past those limits to
    the plain engine; the trace keeps K2.  Scenes above 513 leaves were not
    measured.
    """
    if not (
        spec.n_leaves > engine.MAX_NARROW_LEAVES
        and all(spec.mat_packed)
        and all(k in _PACKED_KINDS for k in spec.mat_kinds)
    ):
        return False
    order, groups = engine.wide_plan(spec)
    if not groups:
        return False
    single_leaves = sum(
        len(engine._tree_slots(spec.trees[idx])) for kind, idx in order if kind == "single"
    )
    return single_leaves <= engine.MAX_NARROW_LEAVES


def pick_fused(spec: SceneSpec, config: TraceConfig, device) -> bool:
    """The kernel-vs-plain dispatch rule of ``trace_rays`` and
    ``analysis.build_objective``.

    ``use_fused=None`` picks the kernels for CUDA tensors when the scene is
    supported (narrow: K1 and K3/K4; wide: K2 and K5-K7 or K8); ``True`` demands
    them and raises for an unsupported scene or for tensors that are not on
    a CUDA device; ``False`` never picks them.  The backward kernels cover
    the scenes their forward kernel covers up to the limits of their table
    reduce (at most 51,200 rows and 2**31 - 1 entries): the gradient's rule,
    ``ops.fused_grad.pick_fused_grad``, adds that test to this one (the TPU
    rule's VMEM budgets have no counterpart here).
    """
    device = torch.device(device)
    use = config.use_fused
    supported = supports_fused(spec) or supports_fused_wide(spec)
    if use is True:
        if not supported:
            raise ValueError(
                "use_fused=True, but the scene has non-packed materials, no leaves, or "
                "past 32 leaves no batchable group of same-shape trees"
            )
        if device.type != "cuda":
            raise ValueError(f"use_fused=True needs CUDA tensors, got device {device}")
        return True
    return use is None and supported and device.type == "cuda"


# ---------------------------------------------------------------------------
# the scene program
# ---------------------------------------------------------------------------


def _interval_chain(tree):
    """Left-deep interval tree -> [(opcode, leaf slot), ...]."""
    if tree[0] == LEAF:
        return [(IV_LOAD, tree[1])]
    op_name, l_tree, r_tree = tree
    op = IV_AND if op_name == "intersect" else IV_SUB
    return _interval_chain(l_tree) + [(op, r_tree[1])]


class _Emitter:
    """Instructions and comparator pairs of a scene program."""

    def __init__(self):
        self.instrs = []
        self.pairs = []
        self._pair_offset = {}

    def pair_table(self, m):
        if m not in self._pair_offset:
            self._pair_offset[m] = len(self.pairs) // 2
            for i, j in batcher_pairs(m):
                self.pairs.extend((i, j))
        return self._pair_offset[m], len(batcher_pairs(m))

    def tree(self, tree, leaf_of, code=0):
        """Emit one tree; ``leaf_of`` maps a global leaf slot to the index
        the instructions name; the fold carries ``code``."""
        if tree_supports_intervals(tree):
            chain = _interval_chain(tree)
            n_iv = 2 ** sum(op == IV_SUB for op, _ in chain)
            if n_iv > MAX_INTERVALS:
                raise ValueError(
                    f"an interval tree yields {n_iv} intervals; the kernel holds "
                    f"{MAX_INTERVALS}"
                )
            self.instrs.extend((op, leaf_of(slot), 0, 0, 0, 0) for op, slot in chain)
            self.instrs.append((IV_FOLD, code, 0, 0, 0, 0))
            return
        rows = self._network(tree, leaf_of)
        if rows > MAX_NET_ROWS:
            raise ValueError(
                f"a CSG tree yields {rows} event rows; the kernel holds {MAX_NET_ROWS}")
        self.instrs.append((NET_FOLD, code, 0, 0, 0, 0))

    def _network(self, tree, leaf_of):
        if tree[0] == LEAF:
            self.instrs.append((NET_PUSH, leaf_of(tree[1]), 0, 0, 0, 0))
            return 2
        op_name, l_tree, r_tree = tree
        m1 = self._network(l_tree, leaf_of)
        m2 = self._network(r_tree, leaf_of)
        offset, count = self.pair_table(m1 + m2)
        self.instrs.append((NET_COMBINE, OP_BY_NAME[op_name].value, m1, m2, offset, count))
        return m1 + m2


def _leaf_rows(spec: SceneSpec):
    """Per leaf ``[type, mat_slot, normal_scale, needs_normal, public_id]``."""
    rows = []
    for s in range(spec.n_leaves):
        rows.extend(
            (
                spec.leaf_types[s],
                spec.leaf_mat_slot[s],
                spec.leaf_normal_scale[s],
                int(engine.leaf_needs_normal(spec, s)),
                spec.leaf_ids[s],
            )
        )
    return rows


def _int32(program) -> np.ndarray:
    program = np.asarray(program, dtype=np.int64)
    if program.max() >= 2**31:
        raise ValueError("surface ids past int32 cannot be encoded")
    return program.astype(np.int32)


@lru_cache(maxsize=64)
def scene_program(spec: SceneSpec) -> np.ndarray:
    """The int32 scene program the narrow kernels interpret.

    Layout: header ``[n_leaves, n_mats, n_instr, pairs_offset]``; per leaf
    ``[type, mat_slot, normal_scale, needs_normal, public_id]``; per
    material slot its kind; ``n_instr`` instructions of 6 ints
    ``[opcode, a, b, c, d, e]``; then the comparator pairs.  Trees emit in
    scene order.  An interval tree is ``IV_LOAD leaf, (IV_AND|IV_SUB
    leaf)..., IV_FOLD``; a general tree is its postfix walk ``NET_PUSH
    leaf`` / ``NET_COMBINE op m1 m2 pair_offset n_pairs``, then
    ``NET_FOLD``.  Raises ValueError when a tree exceeds the kernel's list
    capacities.
    """
    if not supports_fused(spec):
        raise ValueError("scene has non-packed materials or no leaves; use the plain engine")
    emit = _Emitter()
    for tree in spec.trees:
        emit.tree(tree, lambda slot: slot)
    instrs = emit.instrs
    body = _leaf_rows(spec) + list(spec.mat_kinds) + [v for ins in instrs for v in ins]
    header = [spec.n_leaves, len(spec.mat_kinds), len(instrs), 4 + len(body)]
    return _int32(header + body + emit.pairs)


# ---------------------------------------------------------------------------
# wide scenes: host tables and the wide scene program
# ---------------------------------------------------------------------------

# trees per chunk of a wide group: each chunk has one conservative world
# AABB, and a ray whose box test fails skips the chunk's trees.  Kept equal
# to the JAX package's constant (swept there on a TPU v5e), so the chunk
# table and the win codes match its tables; not tuned on the H100 yet.
WIDE_CHUNK_TREES = 16
# leaves per tree of a wide group the kernels hold; keep equal to
# kMaxGroupLeaves in csrc/wide_common.cuh
MAX_GROUP_LEAVES = 8
# opcode of a group fold in the wide program (after the narrow opcodes)
GROUP = 7
_WIDE_HEADER = 11
_GROUP_WIDTH = 8 + 3 * MAX_GROUP_LEAVES


@lru_cache(maxsize=64)
def wide_tables(spec: SceneSpec):
    """Static plan of the wide kernel: ``(order, groups, offsets, slots_flat,
    chunk_offsets, n_chunks)``: the engine's wide plan plus each group's slot
    matrix flattened row-major into one int32 vector (``offsets[g]`` is
    group g's start, leaf j of tree t at ``offsets[g] + t * L + j``);
    ``chunk_offsets[g]`` indexes group g's rows of the chunk-AABB table
    (``n_chunks[g]`` of them; 0 = the group runs unchunked, below two
    chunks of trees).  Cached per spec: the kernels' wrappers check their
    inputs against it on every call, so callers must not modify it."""
    order, groups = engine.wide_plan(spec)
    offsets, flat, chunk_offsets, n_chunks = [], [], [], []
    total_chunks = 0
    for _, _, slot_matrix in groups:
        offsets.append(len(flat))
        for row in slot_matrix:
            flat.extend(row)
        t_count = len(slot_matrix)
        nc = -(-t_count // WIDE_CHUNK_TREES) if t_count >= 2 * WIDE_CHUNK_TREES else 0
        chunk_offsets.append(total_chunks)
        n_chunks.append(nc)
        total_chunks += nc
    slots_flat = np.asarray(flat if flat else [0], np.int32)
    return order, groups, tuple(offsets), slots_flat, tuple(chunk_offsets), tuple(n_chunks)


def _leaf_world_aabb(type_code, pr, world):
    """Conservative world AABB of a (T,)-batch of one leaf position: ``pr``
    (T, P) primitive params, ``world`` (T, 4, 4) local-to-world transforms
    -> ``(mins (T, 3), maxs (T, 3))``: center ``A c + t``, half-width
    ``|A| h``, as scalar multiply-adds (no matmul, so no TF32 path on the
    card can shrink a box)."""
    zeros = torch.zeros_like(pr[:, 0])
    if type_code == prim_mod.SPHERE:
        r = torch.abs(pr[:, 0])
        c, h = (zeros, zeros, zeros), (r, r, r)
    elif type_code == prim_mod.PARABOLOID:
        f, height = pr[:, 0], pr[:, 1]
        r = 2.0 * torch.sqrt(torch.abs(f * height))
        lo_z, hi_z = torch.minimum(zeros, height), torch.maximum(zeros, height)
        c, h = (zeros, zeros, (lo_z + hi_z) / 2), (r, r, (hi_z - lo_z) / 2)
    elif type_code == prim_mod.PLANE:
        c = (zeros, zeros, zeros)
        h = (torch.abs(pr[:, 0]) / 2, torch.abs(pr[:, 1]) / 2, zeros)
    elif type_code == prim_mod.CUBE:
        c = tuple((pr[:, 2 * a] + pr[:, 2 * a + 1]) / 2 for a in range(3))
        h = tuple((pr[:, 2 * a + 1] - pr[:, 2 * a]) / 2 for a in range(3))
    elif type_code == prim_mod.CYLINDER:
        r = torch.abs(pr[:, 0])
        c = (zeros, zeros, (pr[:, 1] + pr[:, 2]) / 2)
        h = (r, r, (pr[:, 2] - pr[:, 1]) / 2)
    else:  # pragma: no cover - compile_scene only emits the five types
        raise ValueError(f"unknown primitive type code {type_code}")
    a = world[:, :3, :3]
    wc = torch.stack(
        [a[:, i, 0] * c[0] + a[:, i, 1] * c[1] + a[:, i, 2] * c[2] + world[:, i, 3]
         for i in range(3)], dim=1)
    wh = torch.stack(
        [torch.abs(a[:, i, 0]) * h[0] + torch.abs(a[:, i, 1]) * h[1]
         + torch.abs(a[:, i, 2]) * h[2] for i in range(3)], dim=1)
    return wc - wh, wc + wh


# Slope of the cone that bounds each primitive's solid interval in object
# space, per local axis: the intersectors (csrc/trace_common.cuh) decide a
# ray that is nearly parallel to a face or an axis by its origin alone
# (``isclose0`` of a direction component, 1e-8, or of a cylinder's
# d_x^2 + d_y^2, so |d_xy| <= 1e-4), and the ray's points on such an
# interval then stray from the leaf's box by at most that slope times t.
# Doubled as a margin; rounding adds its own (_ROUNDING_SLOPE).  A paraboloid
# is not bounded (below).
_CULL_SLOPE = {
    prim_mod.SPHERE: (0.0, 0.0, 0.0),
    prim_mod.PLANE: (2e-8, 2e-8, 0.0),
    prim_mod.CUBE: (2e-8, 2e-8, 2e-8),
    prim_mod.CYLINDER: (2e-4, 2e-4, 2e-8),
}
# the rounding's slope in units of sqrt(eps) (_wide_box_pass)
_ROUNDING_SLOPE = 8.0


def _chunk_union(lo3, hi3, nc):
    """``(nc, 6)`` unions of consecutive ``WIDE_CHUNK_TREES`` boxes of the
    sorted ``(T, 3)`` corners; ``nc`` is the group's chunk count of
    :func:`wide_tables` (0: unchunked, no rows)."""
    t_count, chunk = lo3.shape[0], WIDE_CHUNK_TREES
    pad = max(nc * chunk - t_count, 0)
    s_min = torch.cat((lo3, lo3.new_full((pad, 3), INF)))[:nc * chunk].reshape(nc, chunk, 3)
    s_max = torch.cat((hi3, hi3.new_full((pad, 3), -INF)))[:nc * chunk].reshape(nc, chunk, 3)
    return torch.cat((s_min.min(dim=1).values, s_max.max(dim=1).values), dim=1)


def _wide_box_pass(spec: SceneSpec, params, dtype):
    """One pass over the groups: ``(slots, aabb, tight)`` where ``slots``
    and ``aabb`` are :func:`wide_runtime_tables`' and ``tight`` holds the
    cull boxes of the wide kernels K2 and K8, per group in fold order:
    ``(tree_box (T, 6), chunk_box (chunks, 6), slope (3,))``.
    ``tree_box`` holds each tree's conservative world box in the sorted
    order of the slot vector, ``chunk_box`` the union of its 16 trees'
    boxes (no rows for an unchunked group), rows ``[lo_xyz, hi_xyz]``.
    Port only (the JAX package culls by the loose chunk boxes alone); not
    differentiable.

    A tree's box folds its interval opcodes: ``IV_LOAD`` starts from the
    leaf's box (:func:`_leaf_world_aabb`), ``IV_AND`` intersects it with
    the leaf's box, ``IV_SUB`` keeps it (a difference only removes points).
    An empty intersection leaves ``lo > hi``.  A candidate of the tree is
    an endpoint of its interval list, which lies inside the interval of
    every loaded or intersected leaf, so the rule is sound where a leaf's
    box holds the leaf's whole solid interval.  From the intersectors of
    ``csrc/trace_common.cuh``:

    * sphere: the chord between the two roots lies in the ball; a ray with
      ``isclose0(|d|^2)`` misses.  Bounded.
    * cube: per axis the slab between its two face parameters; an axis with
      ``isclose0(d_a)`` is decided by the origin alone, so the ray may
      stray |t| |d_a| <= 1e-8 |t| outside the slab.  Bounded up to that.
    * cylinder: the quadratic's chord lies inside the radius, and the slab
      clip bounds z.  With ``isclose0(d_x^2 + d_y^2)`` (|d_xy| <= 1e-4) the
      radial test is the origin's (``isclose0(b)``) or the linear root
      ``-c / b``, whose point has radius^2 = r^2 + a t^2: either way within
      r + 1e-4 |t|; a parallel slab strays 1e-8 |t|.  Bounded up to that.
    * plane: z = 0 exactly at ``-o_z / d_z`` (``isclose0(d_z)`` misses);
      x and y as the cube's slabs.  Bounded up to 1e-8 |t|.
    * paraboloid: NOT bounded.  With ``isclose0(a)`` and ``isclose0(b)``
      the linear root is ``-c / (b + 1)``, a value unrelated to the
      surface (b cancels to 1e-8 for a near-axial ray whose origin lies
      far off the axis), and the slab clip then keeps a segment at any
      radius.  A paraboloid leaf tightens nothing.

    Rounding strays too, and more the farther the origin: a quadratic's
    ``b^2 - 4ac`` cancels, so with its absolute error of about 4 t^2 eps
    (unit direction, t ~ |o|) a computed root lies within
    sqrt(r^2 + 4 t^2 eps) <= r + 2 sqrt(eps) t of the center, and a slab's
    root within eps t of its face.  Each tightening leaf's local slope gets
    ``_ROUNDING_SLOPE`` sqrt(eps) of the table's dtype on every axis, four
    times that bound (at float32 2.8e-3, at float64 1.2e-7).

    ``slope`` bounds those strays in world space for the whole group: per
    world axis the largest ``|A| k`` over the tightening leaves (``k`` the
    local slopes, ``_CULL_SLOPE`` plus the rounding's, ``A`` the leaf's
    world rotation and scale).  The kernels test a ray against each box
    grown by ``slope * t`` at parameter t > 0, which the strays never leave.
    """
    _, groups, offsets, slots_flat, chunk_offsets, n_chunks = wide_tables(spec)
    device = params["world"].device
    slots_out = torch.as_tensor(slots_flat, device=device).clone()
    aabb = torch.zeros((max(sum(n_chunks), 1), 6), dtype=dtype, device=device)
    world = params["world"].detach().to(dtype)
    prims = params["prim"].detach().to(dtype)
    rounding = _ROUNDING_SLOPE * torch.finfo(dtype).eps ** 0.5
    tight_out = []
    for gi, (template, types_pos, slot_matrix) in enumerate(groups):
        nc = n_chunks[gi]
        t_count, l_count = len(slot_matrix), len(types_pos)
        slots_t = torch.as_tensor(slot_matrix, dtype=torch.long, device=device)
        kw = dict(dtype=dtype, device=device)
        mins = torch.full((t_count, 3), INF, **kw)
        maxs = torch.full((t_count, 3), -INF, **kw)
        t_min = torch.full((t_count, 3), -INF, **kw)  # the tight box, folded by opcode
        t_max = torch.full((t_count, 3), INF, **kw)
        slope = torch.zeros((3,), **kw)
        ops = [op for op, _ in _interval_chain(template)]
        for j in range(l_count):
            sj = slots_t[:, j]
            lo, hi = _leaf_world_aabb(types_pos[j], prims[sj], world[sj])
            mins, maxs = torch.minimum(mins, lo), torch.maximum(maxs, hi)
            k_local = _CULL_SLOPE.get(types_pos[j])
            if ops[j] == IV_SUB or k_local is None:
                continue  # IV_SUB keeps the box; an unbounded leaf tightens nothing
            t_min, t_max = torch.maximum(t_min, lo), torch.minimum(t_max, hi)
            a = world[sj, :3, :3].abs()
            k = [k_local[ax] + rounding for ax in range(3)]
            k_world = torch.stack([a[:, i, 0] * k[0] + a[:, i, 1] * k[1] + a[:, i, 2] * k[2]
                                   for i in range(3)], dim=1)
            slope = torch.maximum(slope, k_world.max(dim=0).values)
        if nc:  # an unchunked group keeps its trees in index order
            centers = (mins + maxs) / 2
            spread = centers.max(dim=0).values - centers.min(dim=0).values
            perm = torch.argsort(centers[:, int(torch.argmax(spread))], stable=True)
            off = offsets[gi]
            slots_out[off:off + t_count * l_count] = slots_t[perm].reshape(-1).to(torch.int32)
            start = chunk_offsets[gi]
            aabb[start:start + nc] = _chunk_union(mins[perm], maxs[perm], nc)
        else:
            perm = torch.arange(t_count, device=device)
        tree_box = torch.cat((t_min, t_max), dim=1)[perm]
        tight_out.append((tree_box, _chunk_union(t_min[perm], t_max[perm], nc), slope))
    return slots_out, aabb, tuple(tight_out)


def wide_runtime_tables(spec: SceneSpec, params, dtype):
    """Call-time wide tables from the scene params: the spatially sorted
    flat slot vector (int32) and the chunk AABBs ``(chunks, 6)`` as
    ``[lo_x, lo_y, lo_z, hi_x, hi_y, hi_z]`` rows (one zero row when no
    group is chunked).

    Per group each tree's box is the union of its leaves' boxes; trees sort
    along the axis of largest center spread with a STABLE sort (equal keys,
    such as one row of a square grid, keep their index order, as
    ``jnp.argsort`` does), and chunk boxes are min/maxes over the sorted
    order.  Not differentiable: the tables only order and skip work.
    """
    slots, aabb, _ = _wide_box_pass(spec, params, dtype)
    return slots, aabb


def _pad_box(box):
    """The box grown by ``_box_hit``'s 64 ulps of its coordinates."""
    eps = torch.finfo(box.dtype).eps
    pad = 64 * eps * (1 + box[:, :3].abs() + box[:, 3:].abs())
    return torch.cat((box[:, :3] - pad, box[:, 3:] + pad), dim=1)


def wide_cull_tables(spec: SceneSpec, params, dtype):
    """K2's and K8's call-time tables: ``(slots, aabb, cull)``, the first
    two :func:`wide_runtime_tables`' and ``cull`` (rows, 6) the packed cull
    boxes of :func:`_wide_box_pass`, computed in the same pass.  Group g's
    rows start at ``cull_offsets(spec)[g]`` (the wide program's group
    field 6): its slope ``[s_x, s_y, s_z, 0, 0, 0]``, its chunk boxes, its
    tree boxes, each box padded as ``_box_hit`` pads (64 ulps)."""
    slots, aabb, tight = _wide_box_pass(spec, params, dtype)
    rows = []
    for tree_box, chunk_box, slope in tight:
        rows += [torch.cat((slope, slope.new_zeros(3)))[None], _pad_box(chunk_box),
                 _pad_box(tree_box)]
    return slots, aabb, torch.cat(rows).contiguous()


@lru_cache(maxsize=64)
def cull_offsets(spec: SceneSpec):
    """Each group's first row in :func:`wide_cull_tables`' ``cull`` and the
    table's row count: ``(offsets, rows)``."""
    _, groups, _, _, _, n_chunks = wide_tables(spec)
    offsets, rows = [], 0
    for (_, _, slot_matrix), nc in zip(groups, n_chunks):
        offsets.append(rows)
        rows += 1 + nc + len(slot_matrix)
    return tuple(offsets), rows


def _wide_needs_normal(spec: SceneSpec, slot: int) -> bool:
    return spec.mat_kinds[spec.leaf_mat_slot[slot]] != matl.KIND_ABSORB


def leaf_meta_table(spec: SceneSpec) -> np.ndarray:
    """Static (S, 3) per-slot ``[public id, material slot, normal scale]``:
    per slot, not per group position, so a group may mix materials and
    orientations."""
    return np.stack(
        [
            np.asarray(spec.leaf_ids, np.float64),
            np.asarray(spec.leaf_mat_slot, np.float64),
            np.asarray(spec.leaf_normal_scale, np.float64),
        ],
        axis=1,
    )


@lru_cache(maxsize=64)
def wide_fold_plan(spec: SceneSpec):
    """Per entry of the wide order ``("single", tree_index, info)`` or
    ``("group", group_index, info)``.  Win codes enumerate trees in fold
    order: a single takes one code (``info["code"]``), a group's tree at
    SORTED position t takes ``info["code_base"] + t``.  A group's
    ``needs_pos`` is the OR over its members of each position's
    needs-normal (its normals are computed with that rule)."""
    order, groups, offsets, _, chunk_offsets, n_chunks = wide_tables(spec)
    plan = []
    code = 0
    for kind, idx in order:
        if kind == "single":
            tree = spec.trees[idx]
            slots = engine._tree_slots(tree)
            info = dict(
                template=engine._tree_template(tree),
                fast=tree_supports_intervals(tree),
                slots=slots,
                types_pos=tuple(spec.leaf_types[s] for s in slots),
                scale_pos=tuple(spec.leaf_normal_scale[s] for s in slots),
                needs_pos=tuple(_wide_needs_normal(spec, s) for s in slots),
                code=code,
            )
            code += 1
        else:
            template, types_pos, slot_matrix = groups[idx]
            info = dict(
                template=template,
                fast=True,
                T=len(slot_matrix),
                L=len(types_pos),
                off=offsets[idx],
                types_pos=types_pos,
                needs_pos=tuple(
                    any(_wide_needs_normal(spec, row[j]) for row in slot_matrix)
                    for j in range(len(types_pos))
                ),
                chunk_off=chunk_offsets[idx],
                n_chunks=n_chunks[idx],
                code_base=code,
            )
            code += len(slot_matrix)
        plan.append((kind, idx, info))
    return tuple(plan)


@lru_cache(maxsize=64)
def _fold_needs(spec: SceneSpec) -> np.ndarray:
    """(S,) bool: whether the wide fold computes the normal of a hit on
    each leaf (a group position's OR rule, a single's own rule)."""
    needs = np.zeros(spec.n_leaves, dtype=bool)
    for kind, idx, info in wide_fold_plan(spec):
        if kind == "single":
            needs[list(info["slots"])] = info["needs_pos"]
        else:
            for row in engine.wide_plan(spec)[1][idx][2]:
                needs[list(row)] = info["needs_pos"]
    return needs


@lru_cache(maxsize=64)
def wide_program(spec: SceneSpec) -> np.ndarray:
    """The int32 program of the wide kernels (K2, K5-K8).

    Layout: header ``[n_leaves, n_mats, n_instr, pairs_offset,
    n_single_leaves, n_groups, groups_offset, singles_offset,
    leaf_table_offset, n_single_trees, single_trees_offset]``; the material
    kinds; ``n_instr`` instructions of 6 ints; per group ``[T, L,
    slot_offset, chunk_offset, n_chunks, code_base, cull_offset, 0, op[8],
    needs[8], type[8]]`` (``cull_offset`` the group's first row in
    :func:`wide_cull_tables`' table, ``op[j]`` the interval op that applies leaf position j,
    ``needs[j]`` the position's needs-normal OR); per single leaf
    ``[global slot, type]``; per single tree ``[code, first instruction,
    end instruction]``; the comparator pairs; then the leaf table of
    :func:`scene_program` (per leaf ``[type, mat_slot, normal_scale,
    needs_normal, public_id]``).  The kernels copy everything before the
    leaf table into shared memory and read the leaf table and the group
    tables from global memory.

    The instructions are those of :func:`scene_program`, in wide fold
    order: a single's leaves are named by their compact single index, its
    ``IV_FOLD`` / ``NET_FOLD`` carries its win code, and ``GROUP g`` folds
    group g.  Raises ValueError where a tree exceeds the kernels'
    capacities.
    """
    if not supports_fused_wide(spec):
        raise ValueError(
            "scene has non-packed materials or no batchable tree groups; use the plain engine"
        )
    emit = _Emitter()
    group_rows, single_leaves, single_trees = [], [], []
    n_groups = 0
    for kind, idx, info in wide_fold_plan(spec):
        if kind == "single":
            compact = {}
            for s in info["slots"]:
                compact[s] = len(single_leaves) // 2
                single_leaves.extend((s, spec.leaf_types[s]))
            first = len(emit.instrs)
            emit.tree(spec.trees[idx], compact.__getitem__, code=info["code"])
            single_trees.extend((info["code"], first, len(emit.instrs)))
            continue
        t_count, l_count = info["T"], info["L"]
        if l_count > MAX_GROUP_LEAVES:
            raise ValueError(
                f"a group tree has {l_count} leaves; the kernels hold {MAX_GROUP_LEAVES}")
        chain = _interval_chain(info["template"])
        n_iv = 2 ** sum(op == IV_SUB for op, _ in chain)
        if n_iv > MAX_INTERVALS:
            raise ValueError(
                f"a group tree yields {n_iv} intervals; the kernel holds {MAX_INTERVALS}")
        pad = [0] * (MAX_GROUP_LEAVES - l_count)
        group_rows.extend(
            [t_count, l_count, info["off"], info["chunk_off"], info["n_chunks"],
             info["code_base"], cull_offsets(spec)[0][idx], 0]
            + [op for op, _ in chain] + pad
            + [int(x) for x in info["needs_pos"]] + pad
            + list(info["types_pos"]) + pad
        )
        if idx != n_groups:  # pragma: no cover - wide_plan numbers groups in fold order
            raise ValueError("group rows out of fold order")
        emit.instrs.append((GROUP, idx, 0, 0, 0, 0))
        n_groups += 1
    kinds = list(spec.mat_kinds)
    instr_flat = [v for ins in emit.instrs for v in ins]
    groups_off = _WIDE_HEADER + len(kinds) + len(instr_flat)
    singles_off = groups_off + len(group_rows)
    trees_off = singles_off + len(single_leaves)
    pairs_off = trees_off + len(single_trees)
    leaf_off = pairs_off + len(emit.pairs)
    header = [spec.n_leaves, len(kinds), len(emit.instrs), pairs_off, len(single_leaves) // 2,
              n_groups, groups_off, singles_off, leaf_off, len(single_trees) // 3, trees_off]
    return _int32(header + kinds + instr_flat + group_rows + single_leaves + single_trees
                  + emit.pairs + _leaf_rows(spec))


# ---------------------------------------------------------------------------
# build and bind
# ---------------------------------------------------------------------------


def _nvcc() -> str:
    for candidate in (
        os.environ.get("CUDA_HOME") and os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"),
        shutil.which("nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ):
        if candidate and os.path.exists(candidate):
            return candidate
    raise RuntimeError("nvcc not found: the CUDA kernels are built with the CUDA toolkit")


def _build_one(name: str, digest: str):
    """Start nvcc on one source; returns ``(lib_path, process or None, tmp)``."""
    lib_path = _BUILD_DIR / f"libpyrayt_{Path(name).stem}_{digest}.so"
    if lib_path.exists():
        return lib_path, None, None
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
    os.close(fd)
    cmd = [
        _nvcc(),
        "-gencode", "arch=compute_90a,code=sm_90a",
        "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
        "-Xptxas", "-v",
        "-o", tmp, str(_CSRC_DIR / name),
    ]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return lib_path, proc, tmp


@lru_cache(maxsize=None)
def build_kernels():
    """Compile every source of ``KERNEL_SOURCES`` for sm_90a into
    ``build/torch_kernels`` (once per version of the sources and the shared
    header), one nvcc process per source, all started together.  Returns
    ``{source stem: (library path, seconds, compiler log)}`` (a library
    built earlier: 0 seconds and "cached" before the log kept beside it);
    raises if a build fails."""
    header = b"".join((_CSRC_DIR / h).read_bytes() for h in _HEADERS)
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    start = time.perf_counter()
    started = {}
    for name in KERNEL_SOURCES:
        digest = hashlib.sha256(header + (_CSRC_DIR / name).read_bytes()).hexdigest()[:16]
        started[name] = _build_one(name, digest)
    built = {}
    failures = []
    for name, (lib_path, proc, tmp) in started.items():
        log_path = lib_path.with_suffix(".log")
        if proc is None:
            log = log_path.read_text() if log_path.exists() else ""
            built[Path(name).stem] = (str(lib_path), 0.0, "cached\n" + log)
            continue
        log, _ = proc.communicate()
        seconds = time.perf_counter() - start
        if proc.returncode != 0:
            os.unlink(tmp)
            failures.append(f"nvcc failed on {name} ({proc.returncode}):\n{log}")
            continue
        log_path.write_text(log)
        os.replace(tmp, lib_path)
        built[Path(name).stem] = (str(lib_path), seconds, log)
    if failures:
        raise RuntimeError("\n".join(failures))
    return built


@lru_cache(maxsize=None)
def _library():
    lib = ctypes.CDLL(build_kernels()["fused_trace"][0])
    args = (
        [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int]  # state, n, generations
        + [ctypes.c_void_p] * 4  # obj_tx, prim, glass, program
        + [ctypes.c_int] * 3  # program_len, n_leaves, n_glass
        + [ctypes.c_void_p] * 3  # records, masks, final state
        + [ctypes.c_double] * 3  # ray_offset, world_index, intensity_threshold
        + [ctypes.c_int, ctypes.c_void_p]  # apply_threshold, stream
    )
    for name in ("pyrayt_fused_trace_f32", "pyrayt_fused_trace_f64"):
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = ctypes.c_int
    lib.pyrayt_error_string.argtypes = [ctypes.c_int]
    lib.pyrayt_error_string.restype = ctypes.c_char_p
    return lib


@lru_cache(maxsize=64)
def device_program(spec: SceneSpec, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(scene_program(spec), device=device)


# ---------------------------------------------------------------------------
# the wrapper and its plain version
# ---------------------------------------------------------------------------


def check_inputs(spec, state, obj_tx, prim, glass):
    tensors = {"state": state, "obj_tx": obj_tx, "prim": prim, "glass": glass}
    for name, t in tensors.items():
        if t.device != state.device or t.dtype != state.dtype:
            raise ValueError(f"{name} must be {state.dtype} on {state.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if state.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"the kernel runs float32 or float64, got {state.dtype}")
    s = spec.n_leaves
    shapes = (
        (state, (13, state.shape[-1])),
        (obj_tx, (s, 16)),
        (prim, (s, 6)),
        (glass, (len(spec.mat_kinds), matl.N_GLASS_COEFFS)),
    )
    for t, shape in shapes:
        if tuple(t.shape) != shape:
            raise ValueError(f"expected shape {shape}, got {tuple(t.shape)}")


def fused_trace(spec: SceneSpec, config: TraceConfig, state, obj_tx, prim, glass):
    """Trace ``state`` (13, n) through a narrow scene: ``(records (G, 15,
    n), masks (G, n) bool, final state (13, n))``.

    ``obj_tx`` (S, 16) is the row-major inverse of each leaf's world
    transform, ``prim`` (S, 6) and ``glass`` (M, 7) the scene params.  On
    CUDA tensors this launches the kernel and counts the launch in
    ``fused_trace.launches``; on CPU tensors it runs
    :func:`fused_trace_plain`.
    """
    if state.device.type == "cpu":
        return fused_trace_plain(spec, config, state, obj_tx, prim, glass)
    if state.device.type != "cuda":
        raise ValueError(f"the kernel runs on CUDA tensors, got {state.device}")
    check_inputs(spec, state, obj_tx, prim, glass)
    program = device_program(spec, state.device)
    n = state.shape[1]
    g = config.generation_limit
    records = torch.empty((g, engine.N_RECORD_COLS, n), dtype=state.dtype, device=state.device)
    masks = torch.empty((g, n), dtype=torch.bool, device=state.device)
    fstate = torch.empty_like(state)
    if n == 0:
        return records, masks, fstate
    lib = _library()
    launch = (
        lib.pyrayt_fused_trace_f32 if state.dtype == torch.float32 else lib.pyrayt_fused_trace_f64
    )
    with torch.cuda.device(state.device):
        err = launch(
            state.data_ptr(), n, g,
            obj_tx.data_ptr(), prim.data_ptr(), glass.data_ptr(), program.data_ptr(),
            program.numel(), spec.n_leaves, glass.shape[0],
            records.data_ptr(), masks.data_ptr(), fstate.data_ptr(),
            config.ray_offset, config.world_index, config.intensity_threshold,
            int(config.apply_intensity_threshold),
            torch.cuda.current_stream(state.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(
            f"fused_trace kernel launch failed: {lib.pyrayt_error_string(err).decode()}"
        )
    fused_trace.launches += 1
    return records, masks, fstate


fused_trace.launches = 0


def rays_from_state(state) -> RaySet:
    return RaySet(
        positions=state[0:4],
        directions=state[4:8],
        generation=state[8],
        intensity=state[9],
        wavelength=state[10],
        index=state[11],
        id=state[12],
    )


def fused_trace_plain(spec: SceneSpec, config: TraceConfig, state, obj_tx, prim, glass):
    """Plain PyTorch version of :func:`fused_trace` (same signature, same
    outputs, the per-ray exit contract of the module docstring), built on
    the plain engine's generation step."""
    if not supports_fused(spec):
        raise ValueError("scene has non-packed materials or no leaves; use the plain engine")
    check_inputs(spec, state, obj_tx, prim, glass)
    n = state.shape[1]
    g_limit = config.generation_limit
    tables = {"obj_tx": obj_tx.reshape(-1, 4, 4), "prim": prim, "glass": glass}
    records = torch.zeros(
        (g_limit, engine.N_RECORD_COLS, n), dtype=state.dtype, device=state.device
    )
    masks = torch.zeros((g_limit, n), dtype=torch.bool, device=state.device)
    rays = rays_from_state(state)
    running = torch.ones(n, dtype=torch.bool, device=state.device)
    for g in range(g_limit):
        if not bool(running.any()):
            break
        (nxt, living), record, masks[g] = engine.generation_step(
            spec, None, config, tables, (rays, running)
        )
        records[g] = torch.where(running, record, 0.0)
        rays = RaySet(
            **{
                f: torch.where(running, getattr(nxt, f), getattr(rays, f))
                for f in ("positions", "directions") + RaySet.fields
            }
        )
        running = living & (_sum_rows(nxt.directions * nxt.directions) != 0)
    fstate = torch.cat((rays.positions, rays.directions, rays.metadata))
    fstate[3] = 1.0  # homogeneous w rows, as the kernel writes them
    fstate[7] = 0.0
    return records, masks, fstate


def kernel_inputs(params, rays: RaySet):
    """The kernel's inputs from scene params and rays, in the rays' dtype:
    ``(state (13, n), obj_tx (S, 16), prim (S, 6), glass (M, 7))``, each
    contiguous.  ``obj_tx`` is the inverse of each leaf's world transform."""
    dtype = rays.dtype
    state = torch.cat((rays.positions, rays.directions, rays.metadata))
    obj_tx = affine_inverse(params["world"]).reshape(-1, 16)
    return tuple(
        t.to(dtype).contiguous() for t in (state, obj_tx, params["prim"], params["glass"])
    )


# ---------------------------------------------------------------------------
# the wide forward (K2): its plain version and its wrapper
# ---------------------------------------------------------------------------


def _box_hit(box, p, v):
    """(n,) bool: does each ray meet the AABB ``box`` (6,) at positive t?
    The per-ray counterpart of the JAX kernel's ``_block_any_hit``, with
    its zero-direction conventions (a ray parallel to a slab is inside it
    or misses).  The box grows by 64 ulps of its coordinates, so rounding
    in this test never rejects a real hit at the rim; the growth changes
    only what is skipped, never a candidate.  K2 runs the same test."""
    eps = torch.finfo(p.dtype).eps
    tmin = torch.full_like(p[0], -INF)
    tmax = torch.full_like(p[0], INF)
    for a in range(3):
        pad = 64 * eps * (1 + torch.abs(box[a]) + torch.abs(box[3 + a]))
        lo, hi = box[a] - pad, box[3 + a] + pad
        o, d = p[a], v[a]
        zero = d == 0
        dsafe = torch.where(zero, 1.0, d)
        t0, t1 = (lo - o) / dsafe, (hi - o) / dsafe
        inside = (o >= lo) & (o <= hi)
        a_lo = torch.where(zero, torch.where(inside, -INF, INF), torch.minimum(t0, t1))
        a_hi = torch.where(zero, torch.where(inside, INF, -INF), torch.maximum(t0, t1))
        tmin, tmax = torch.maximum(tmin, a_lo), torch.minimum(tmax, a_hi)
    return (tmax >= tmin) & (tmax > 0)


def cull_hit_plain(boxes, slope, p, v):
    """(k, n) bool: does each ray (``p``, ``v`` (3, n)) enter each padded
    cull box (``boxes`` (k, 6) rows of :func:`wide_cull_tables`) grown by
    ``slope`` (3,) times t at some t > 0?  The plain version of the
    kernels' box test (csrc/wide_common.cuh: ray_cull, cull_hit) without
    their distance prune: per axis t (v + s) >= lo - p and t (v - s) <= hi
    - p."""
    inf = torch.full_like(p[0], INF)
    tmin = -inf.expand(boxes.shape[0], -1)
    tmax = inf.expand(boxes.shape[0], -1)
    for a in range(3):
        u1, u2 = v[a] + slope[a], v[a] - slope[a]
        r1 = torch.where(u1 == 0, INF, 1 / torch.where(u1 == 0, 1.0, u1))
        r2 = torch.where(u2 == 0, -INF, 1 / torch.where(u2 == 0, 1.0, u2))
        x = (boxes[:, a, None] - p[a]) * r1
        y = (boxes[:, 3 + a, None] - p[a]) * r2
        entry_x = u1 >= 0  # v > s, or |v| <= s
        entry_y = u2 <= 0  # v < -s, or |v| <= s
        # a NaN bound (the origin on the face of a parallel slab) binds nothing
        low = torch.where(entry_x & ~torch.isnan(x), x, -INF)
        low = torch.maximum(low, torch.where(entry_y & ~torch.isnan(y), y, -INF))
        high = torch.where((u2 > 0) & ~torch.isnan(y), y, INF)
        high = torch.where((u1 < 0) & ~torch.isnan(x), x, high)
        tmin, tmax = torch.maximum(tmin, low), torch.minimum(tmax, high)
    return (tmin <= tmax) & (tmax > 0) & (tmin < INF)


def wide_fold_plain(spec: SceneSpec, obj_tx, prim, slots, aabb, p, v):
    """The wide nearest-hit fold on rays ``p``, ``v`` (4, k): ``(best_d (k,),
    best_n (4, k), best_mat (k,), best_pub (k,), win (k,) int32, leaf (k,)
    int32)``.  ``obj_tx`` is (S, 4, 4).

    Singles fold in order, each as its own tree; a group's trees fold in
    SORTED order (the slot vector of :func:`wide_runtime_tables`) with a
    strict ``<``, chunk by chunk, a ray skipping a chunk whose box it
    misses (:func:`_box_hit`).  The winner's normal comes from its
    object-space hit point (the local ray at the hit distance),
    inverse-transpose, normalized with the zero guard, times the slot's
    normal scale; material slot and public id are the slot's (0 without a
    hit)."""
    k = p.shape[1]
    device, dtype = p.device, p.dtype
    rays = torch.stack((p, v))
    tables = {"obj_tx": obj_tx, "prim": prim}
    best = torch.full((k,), INF, dtype=dtype, device=device)
    leaf = torch.full((k,), -1, dtype=torch.int32, device=device)
    win = torch.full((k,), -1, dtype=torch.int32, device=device)

    def fold(d, l_slot, code):
        nonlocal best, leaf, win
        better = d < best
        best = torch.where(better, d, best)
        leaf = torch.where(better, l_slot, leaf)
        win = torch.where(better, code, win)

    for kind, idx, info in wide_fold_plan(spec):
        if kind == "single":
            d_t = torch.full((k,), INF, dtype=dtype, device=device)
            l_t = torch.full((k,), -1, dtype=torch.int32, device=device)
            for cand, ids in engine.tree_candidates(spec, spec.trees[idx], tables, rays):
                cand = torch.where(cand > 0, cand, INF)
                new_min = cand < d_t
                d_t, l_t = torch.where(new_min, cand, d_t), torch.where(new_min, ids, l_t)
            fold(d_t, l_t, info["code"])
            continue
        t_count, l_count, off = info["T"], info["L"], info["off"]
        slot_mat = slots[off:off + t_count * l_count].long().reshape(t_count, l_count)
        nc = info["n_chunks"]
        spans = (
            [(c * WIDE_CHUNK_TREES, min((c + 1) * WIDE_CHUNK_TREES, t_count), c) for c in range(nc)]
            if nc else [(0, t_count, None)]
        )
        for t0, t1, c in spans:
            d, l_slot = engine._wide_group_candidates(
                info["template"], info["types_pos"], slot_mat[t0:t1], prim, obj_tx, rays
            )
            if c is not None:
                d = torch.where(_box_hit(aabb[info["chunk_off"] + c], p, v), d, INF)
            for t in range(t1 - t0):
                fold(d[t], l_slot[t], info["code_base"] + t0 + t)

    hit = leaf >= 0
    s = leaf.clamp(min=0).long()
    m = obj_tx[s]
    pr = prim[s]
    lo3 = [m[:, i, 0] * p[0] + m[:, i, 1] * p[1] + m[:, i, 2] * p[2] + m[:, i, 3] for i in range(3)]
    ld3 = [m[:, i, 0] * v[0] + m[:, i, 1] * v[1] + m[:, i, 2] * v[2] for i in range(3)]
    d_safe = torch.where(hit, best, 0.0)
    local_hit = [o + d_safe * d for o, d in zip(lo3, ld3)]
    needs_table = _fold_needs(spec)
    needs = torch.as_tensor(needs_table, device=device)[s] & hit
    types = torch.as_tensor(spec.leaf_types, device=device)[s]
    n3 = [torch.zeros_like(best) for _ in range(3)]
    pr_cols = [pr[:, i] for i in range(pr.shape[1])]
    for t in sorted({spec.leaf_types[q] for q in range(spec.n_leaves) if needs_table[q]}):
        ln3 = prim_mod.leaf_normal_raw3(t, local_hit, pr_cols)
        wn3 = [m[:, 0, i] * ln3[0] + m[:, 1, i] * ln3[1] + m[:, 2, i] * ln3[2] for i in range(3)]
        mask = needs & (types == t)
        n3 = [torch.where(mask, w, old) for w, old in zip(wn3, n3)]
    wn = torch.stack(n3)
    sq = _sum_rows(wn * wn)
    zero = sq == 0
    wn = torch.where(zero, wn, wn / torch.sqrt(torch.where(zero, 1.0, sq)))
    meta = torch.as_tensor(leaf_meta_table(spec), dtype=dtype, device=device)[s]
    wn = wn * meta[:, 2]
    best_n = torch.cat((wn, torch.zeros_like(wn[:1])))
    best_mat = torch.where(hit, meta[:, 1], 0.0)
    best_pub = torch.where(hit, meta[:, 0], 0.0)
    return best, best_n, best_mat, best_pub, win, leaf


def wide_tail(spec: SceneSpec, config: TraceConfig, glass, best_d, best_n, best_mat, best_pub,
              x, alive):
    """The step after the wide fold (the JAX package's ``_wide_tail``):
    INTERACT by the folded material slot with the folded normal, the death
    rules, the record and the push-off.  ``x`` is the input state (13, k);
    returns ``(next state (13, k), record (15, k), living (k,))``.
    Differentiable in ``best_d``, ``best_n``, ``glass`` and ``x``."""
    p, v = x[0:4], x[4:8]
    gen, inten, wav, ridx, rid = x[8], x[9], x[10], x[11], x[12]
    no_hit = torch.isinf(best_d)
    t_safe = torch.where(no_hit, 0.0, best_d)
    p_hit = p + t_safe * v
    new_dir = torch.where(no_hit, 0.0, v)
    new_index, new_inten = ridx, inten
    for slot, kind in enumerate(spec.mat_kinds):
        mask = (best_mat == slot) & ~no_hit
        if kind == matl.KIND_ABSORB:
            d2, i2 = torch.zeros_like(v), ridx
        elif kind == matl.KIND_MIRROR:
            d2, i2 = reflect(v, best_n), ridx
        else:
            n2 = matl.index_from_coeffs(glass[slot], wav)
            d2, i2 = refract(v, best_n, ridx, n2, n_global=config.world_index)
        new_dir = torch.where(mask, d2, new_dir)
        new_index = torch.where(mask, i2, new_index)
    absorbed = isclose(_norm_rows(v), 0)
    dead = absorbed | no_hit
    if config.apply_intensity_threshold:
        dead = dead | (inten < config.intensity_threshold)
    living = alive & ~dead
    tilt = safe_normalize(v[:3], dim=0)
    record = torch.cat((x[8:13], best_pub[None], p[:3], p_hit[:3], tilt))
    new_p = torch.where(living, p_hit + config.ray_offset * new_dir, p_hit)
    new_gen = torch.where(living, gen + 1, gen)
    nxt = torch.cat((new_p, new_dir, torch.stack((new_gen, new_inten, wav, new_index, rid))))
    return nxt, record, living


def _check_wide(spec, state, obj_tx, prim, glass, slots, aabb, cull=None):
    check_inputs(spec, state, obj_tx, prim, glass)
    total_chunks = max(1, sum(wide_tables(spec)[5]))
    if slots.dtype != torch.int32 or slots.device != state.device or not slots.is_contiguous():
        raise ValueError(f"slots must be contiguous int32 on {state.device}")
    if tuple(slots.shape) != (len(wide_tables(spec)[3]),):
        raise ValueError(
            f"slots: expected {len(wide_tables(spec)[3])} entries, got {tuple(slots.shape)}")
    if (aabb.dtype != state.dtype or aabb.device != state.device or not aabb.is_contiguous()
            or tuple(aabb.shape) != (total_chunks, 6)):
        raise ValueError(
            f"aabb must be contiguous {state.dtype} ({total_chunks}, 6) on {state.device}")
    rows = cull_offsets(spec)[1]
    if cull is not None and (cull.dtype != state.dtype or cull.device != state.device
                             or not cull.is_contiguous() or tuple(cull.shape) != (rows, 6)):
        raise ValueError(f"cull must be contiguous {state.dtype} ({rows}, 6) on {state.device}")


def fused_trace_wide_plain(spec: SceneSpec, config: TraceConfig, state, obj_tx, prim, glass,
                           slots, aabb, cull=None, save_fold: bool = False):
    """Plain PyTorch version of :func:`fused_trace_wide` (same signature,
    same outputs): :func:`wide_fold_plain` then :func:`wide_tail` per
    generation, with the per-ray exit contract of the module docstring.
    It culls by the JAX-equal chunk boxes ``aabb`` alone (``cull``, the
    kernel's tight boxes, is checked and not read): the tight boxes change
    only what is skipped, never a candidate.
    With ``save_fold`` it also returns ``fold5`` (G, 5, n) = [best_d,
    n_xyz, best_mat] and ``win`` (G, n) int32, zero and -1 for generations
    a ray did not run."""
    if not supports_fused_wide(spec):
        raise ValueError(
            "scene has non-packed materials or no batchable tree groups; use the plain engine"
        )
    _check_wide(spec, state, obj_tx, prim, glass, slots, aabb, cull)
    n, g_limit = state.shape[1], config.generation_limit
    kw = dict(dtype=state.dtype, device=state.device)
    records = torch.zeros((g_limit, engine.N_RECORD_COLS, n), **kw)
    masks = torch.zeros((g_limit, n), dtype=torch.bool, device=state.device)
    fold5 = torch.zeros((g_limit, 5, n), **kw)
    win = torch.full((g_limit, n), -1, dtype=torch.int32, device=state.device)
    m44 = obj_tx.reshape(-1, 4, 4)
    x = state.clone()
    x[3], x[7] = 1.0, 0.0
    running = torch.ones(n, dtype=torch.bool, device=state.device)
    for g in range(g_limit):
        idx = running.nonzero().squeeze(1)
        if idx.numel() == 0:
            break
        xi = x[:, idx]
        best_d, best_n, best_mat, best_pub, win_g, _ = wide_fold_plain(
            spec, m44, prim, slots, aabb, xi[0:4], xi[4:8])
        alive = torch.ones(idx.numel(), dtype=torch.bool, device=state.device)
        nxt, record, living = wide_tail(spec, config, glass, best_d, best_n, best_mat, best_pub,
                                        xi, alive)
        records[g][:, idx] = record
        masks[g][idx] = living
        fold5[g][:, idx] = torch.cat((best_d[None], best_n[:3], best_mat[None]))
        win[g][idx] = win_g
        x[:, idx] = nxt
        running[idx] = living & (_sum_rows(nxt[4:8] * nxt[4:8]) != 0)
    if save_fold:
        return records, masks, x, fold5, win
    return records, masks, x


@lru_cache(maxsize=None)
def _wide_library():
    lib = ctypes.CDLL(build_kernels()["wide_trace"][0])
    p, i, d = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    args = (
        [p, ctypes.c_longlong, i]  # state, n, generations
        + [p] * 4 + [i] * 3  # obj_tx, prim, glass, program; prefix_len, n_single_leaves, n_glass
        + [p] * 7  # slots, cull, records, masks, final state, fold5, win
        + [d] * 3 + [i, p]  # ray_offset, world_index, intensity_threshold; apply, stream
    )
    for name in ("pyrayt_fused_trace_wide_f32", "pyrayt_fused_trace_wide_f64"):
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = ctypes.c_int
    lib.pyrayt_wide_error_string.argtypes = [ctypes.c_int]
    lib.pyrayt_wide_error_string.restype = ctypes.c_char_p
    return lib


@lru_cache(maxsize=64)
def device_wide_program(spec: SceneSpec, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(wide_program(spec), device=device)


def wide_program_sizes(spec: SceneSpec):
    """``(prefix_len, n_single_leaves)`` of the wide program: the length of
    the part the kernels copy into shared memory (all but the per-leaf
    table) and the count of single leaves whose tables they copy."""
    program = wide_program(spec)
    return int(program[8]), int(program[4])


def fused_trace_wide(spec: SceneSpec, config: TraceConfig, state, obj_tx, prim, glass, slots,
                     aabb, cull=None, save_fold: bool = False):
    """K2: trace ``state`` (13, n) through a wide scene
    (:func:`supports_fused_wide`): ``(records (G, 15, n), masks (G, n)
    bool, final state (13, n))``, plus ``(fold5 (G, 5, n), win (G, n)
    int32)`` with ``save_fold`` (the staged backward's forward).

    ``slots``, ``aabb`` and ``cull`` are :func:`wide_cull_tables` of the
    same params; the kernel culls by ``cull``, the plain version by
    ``aabb``.  On CUDA tensors this launches the kernel (``cull`` is
    required) and counts the launch in ``fused_trace_wide.launches``; on
    CPU tensors it runs :func:`fused_trace_wide_plain`.
    """
    if state.device.type == "cpu":
        return fused_trace_wide_plain(spec, config, state, obj_tx, prim, glass, slots, aabb,
                                      cull, save_fold)
    if state.device.type != "cuda":
        raise ValueError(f"the kernel runs on CUDA tensors, got {state.device}")
    if cull is None:
        raise ValueError("the kernel needs the cull table of wide_cull_tables")
    _check_wide(spec, state, obj_tx, prim, glass, slots, aabb, cull)
    program = device_wide_program(spec, state.device)
    n, g = state.shape[1], config.generation_limit
    kw = dict(dtype=state.dtype, device=state.device)
    records = torch.empty((g, engine.N_RECORD_COLS, n), **kw)
    masks = torch.empty((g, n), dtype=torch.bool, device=state.device)
    fstate = torch.empty_like(state)
    fold5 = torch.empty((g, 5, n), **kw) if save_fold else None
    win = torch.empty((g, n), dtype=torch.int32, device=state.device) if save_fold else None
    outs = (records, masks, fstate) + ((fold5, win) if save_fold else ())
    if n == 0:
        return outs
    lib = _wide_library()
    launch = (lib.pyrayt_fused_trace_wide_f32 if state.dtype == torch.float32
              else lib.pyrayt_fused_trace_wide_f64)
    with torch.cuda.device(state.device):
        err = launch(
            state.data_ptr(), n, g,
            obj_tx.data_ptr(), prim.data_ptr(), glass.data_ptr(), program.data_ptr(),
            *wide_program_sizes(spec), glass.shape[0],
            slots.data_ptr(), cull.data_ptr(),
            records.data_ptr(), masks.data_ptr(), fstate.data_ptr(),
            fold5.data_ptr() if save_fold else None, win.data_ptr() if save_fold else None,
            config.ray_offset, config.world_index, config.intensity_threshold,
            int(config.apply_intensity_threshold),
            torch.cuda.current_stream(state.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(
            f"fused_trace_wide kernel launch failed: {lib.pyrayt_wide_error_string(err).decode()}"
        )
    fused_trace_wide.launches += 1
    return outs


fused_trace_wide.launches = 0


def wide_kernel_inputs(spec: SceneSpec, params, rays: RaySet):
    """K2's inputs from scene params and rays: :func:`kernel_inputs` plus
    ``(slots, aabb, cull)`` from :func:`wide_cull_tables`."""
    inputs = kernel_inputs(params, rays)
    return inputs + wide_cull_tables(spec, params, rays.dtype)


@lru_cache(maxsize=64)
def build_fused_trace_fn(spec: SceneSpec, materials, config: TraceConfig,
                         save_fold: bool = False):
    """``fn(params, initial_rays) -> TraceResult`` through :func:`fused_trace`
    (K1 on CUDA tensors) or, past 32 leaves, :func:`fused_trace_wide` (K2).
    Same contract as ``engine.build_trace_fn``; ``materials`` is accepted
    for its signature.  ``save_fold`` (wide scenes only) makes it return
    ``(TraceResult, fold5 (G, 5, n), win (G, n) int32)``, the staged
    backward's forward."""
    del materials  # packed kinds are read from the spec and the glass rows
    wide = not supports_fused(spec)
    if wide and not supports_fused_wide(spec):
        raise ValueError(
            "scene has non-packed materials, no leaves, or no batchable tree groups; "
            "use the plain engine"
        )
    if save_fold and not wide:
        raise ValueError("save_fold is a wide-kernel (staged backward) mode")

    def trace(params, initial_rays: RaySet):
        if wide:
            out = fused_trace_wide(spec, config, *wide_kernel_inputs(spec, params, initial_rays),
                                   save_fold=save_fold)
        else:
            out = fused_trace(spec, config, *kernel_inputs(params, initial_rays))
        records, masks, fstate = out[:3]
        result = engine.TraceResult(
            records=records,
            record_mask=masks,
            final_rays=rays_from_state(fstate),
            generations_run=masks.any(dim=1).sum(),
        )
        return (result,) + tuple(out[3:]) if save_fold else result

    return trace

"""Scene flattening: builder objects -> static spec + params.

Counterpart of ``pyrayt_tpu.scene.compile``.  A compiled scene splits
into a hashable ``SceneSpec`` (primitive type codes, CSG tree shapes,
id/material wiring; equal field by field to the JAX package's) and
``params``, a dict of tensors: ``world`` (S, 4, 4) local-to-world
transforms, ``prim`` (S, 6) packed primitive parameters and ``glass``
(M, 7) dispersion rows.  The engines and the CUDA kernel read only these.
A scene rebuilt from tensors that require grad (scene/_backend.py) gets
params whose graph reaches those tensors; its ``SceneSpec`` is the same as
a plain build's.

A run of consecutive lenslet handles of one grid (scene/lenslets.py)
compiles in one batched pass; every other component, a built and changed
lenslet included, leaf by leaf.  Counters: ``compile_scene.grid_leaves``
and ``.object_leaves``, the leaves compiled each way.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import numpy as np
import torch

from pyrayt_tpu_torch import materials as matl
from pyrayt_tpu_torch import tracing
from pyrayt_tpu_torch.config import default_device
from pyrayt_tpu_torch.core import primitives as prim_mod
from pyrayt_tpu_torch.core.csg import Operation
from pyrayt_tpu_torch.core.intervals import LEAF
from pyrayt_tpu_torch.scene._factors import compose
from pyrayt_tpu_torch.scene.csg import CSGSurface
from pyrayt_tpu_torch.scene.lenslets import Lenslet
from pyrayt_tpu_torch.scene.objects import ObjectGroup, TracerSurface

__all__ = ["SceneSpec", "CompiledScene", "compile_scene", "LEAF", "OP_BY_NAME"]

_OP_NAMES = {
    Operation.UNION: "union",
    Operation.INTERSECT: "intersect",
    Operation.DIFFERENCE: "difference",
}
OP_BY_NAME = {name: op for op, name in _OP_NAMES.items()}

_PACKED_TYPES = (
    matl.BasicRefractor,
    matl.SellmeierRefractor,
    matl._AbsorbingMaterial,
    matl._ReflectingMaterial,
)


@dataclasses.dataclass(frozen=True)
class SceneSpec:
    """Static scene structure (hashable)."""

    leaf_types: Tuple[int, ...]  # primitive type code per leaf slot
    leaf_ids: Tuple[int, ...]  # public surface id per leaf slot
    leaf_normal_scale: Tuple[int, ...]  # +1 / -1 per leaf slot
    leaf_mat_slot: Tuple[int, ...]  # material slot per leaf
    mat_kinds: Tuple[int, ...]  # KIND_* per material slot
    mat_packed: Tuple[bool, ...]  # True -> engines use the packed glass row
    trees: Tuple[Any, ...]  # per top-level component: nested tuples

    @property
    def n_leaves(self) -> int:
        return len(self.leaf_types)

    def __hash__(self) -> int:
        # the kernels' wrappers look up their host tables by spec several
        # times per launch, and a wide scene's nested tuples are slow to
        # hash: hash once per instance (not pickled, since str hashes differ
        # between processes)
        h = self.__dict__.get("_hash")
        if h is None:
            h = hash(tuple(getattr(self, f.name) for f in dataclasses.fields(self)))
            object.__setattr__(self, "_hash", h)
        return h

    def __getstate__(self):
        state = dict(self.__dict__)
        state.pop("_hash", None)
        return state


@dataclasses.dataclass
class CompiledScene:
    spec: SceneSpec
    params: Dict[str, torch.Tensor]
    materials: Tuple[matl.TracableMaterial, ...]  # one per material slot


def _stack(entries, empty_shape, dtype, device) -> torch.Tensor:
    """Stack per-material rows into one ``dtype`` tensor on ``device``.
    Plain rows stack on NumPy; when any row is a tensor (a differentiable
    rebuild) they stack with ``torch.stack``, so the result's graph reaches
    the traced values."""
    if not entries:
        return torch.zeros(empty_shape, dtype=dtype, device=device)
    if any(isinstance(e, torch.Tensor) for e in entries):
        return torch.stack(
            [torch.as_tensor(e, dtype=dtype, device=device) for e in entries]
        )
    return torch.as_tensor(np.stack(entries), dtype=dtype, device=device)


def _leaf_tables(chains, prims, n_leaves, dtype, device):
    """``world`` (S, 4, 4) and ``prim`` (S, 6) from each leaf's transform
    chain and primitive entries (objects.py), given as ``(slots, chain)``
    and ``(slots, prim)`` pairs: one slot and one leaf's, or an index array
    and a grid's stacked leaves (lenslets.py).  The plain rows fill NumPy
    tables, and the traced leaves come from one batched composition
    (scene/_factors.py), placed in slot order with one index op each."""
    world = np.empty((n_leaves, 4, 4))
    prim = np.empty((n_leaves, prim_mod.PARAM_WIDTH))
    for slots, (m0, _) in chains:
        world[slots] = m0
    for slots, (row, _) in prims:
        prim[slots] = row
    world = torch.as_tensor(world, dtype=dtype, device=device)
    prim = torch.as_tensor(prim, dtype=dtype, device=device)
    traced_world = [(slots, chain) for slots, chain in chains if chain[1]]
    traced_prim = [(slots, entry) for slots, entry in prims if entry[1]]
    if not traced_world and not traced_prim:
        return world, prim
    rows_world, rows_prim = compose([c for _, c in traced_world], [p for _, p in traced_prim])
    slots = [s for s, _ in traced_world + traced_prim]
    slots = torch.as_tensor(np.hstack(slots).astype(np.int64), device=device)
    n_world = sum(np.size(s) for s, _ in traced_world)
    if traced_world:
        world = world.index_copy(0, slots[:n_world], rows_world.to(dtype=dtype, device=device))
    if traced_prim:
        prim = prim.index_copy(0, slots[n_world:], rows_prim.to(dtype=dtype, device=device))
    return world, prim


def _flatten_components(components):
    flat = []
    for comp in components:
        if isinstance(comp, ObjectGroup):
            flat.extend(_flatten_components(comp.data))
        else:
            flat.append(comp)
    return flat


def compile_scene(
    components,
    require_materials: bool = True,
    device=None,
    dtype: torch.dtype = torch.float32,
) -> CompiledScene:
    """Flatten a list of Intersectables into a CompiledScene whose params
    are ``dtype`` tensors on ``device`` (None: the CUDA device, see
    ``config.default_device``; pass ``device="cpu"`` for the CPU).

    ``require_materials=False`` maps material-less surfaces to the absorber
    so geometry-only scenes still compile.
    """
    with tracing.span("scene.compile"):
        return _compile(components, require_materials, default_device(device), dtype)


def _compile(components, require_materials, device, dtype) -> CompiledScene:
    components = _flatten_components(
        components if hasattr(components, "__iter__") else (components,)
    )

    leaf_types = []
    leaf_ids = []
    leaf_normal_scale = []
    leaf_mat_slot = []
    worlds = []  # (slots, chain) pairs
    prims = []  # (slots, prim) pairs

    materials = []
    mat_slot_of = {}

    def _material_slot(material) -> int:
        if material is None:
            # material-less surfaces absorb (e.g. the subtracted opening of
            # aperture())
            material = matl.absorber
        elif not isinstance(material, matl.TracableMaterial):
            if require_materials:
                raise TypeError(
                    f"material {material!r} is not a TracableMaterial; the "
                    "engines need a pure_trace implementation"
                )
            material = matl.absorber
        # built-in materials compare by value, so rebuilt but identical
        # glasses share a slot
        if material not in mat_slot_of:
            mat_slot_of[material] = len(materials)
            materials.append(material)
        return mat_slot_of[material]

    def _walk(obj):
        if isinstance(obj, CSGSurface):
            return (_OP_NAMES[obj.operation], _walk(obj.l_child), _walk(obj.r_child))
        if isinstance(obj, TracerSurface):
            slot = len(leaf_types)
            leaf_types.append(obj.prim_type)
            leaf_ids.append(obj.get_id())
            leaf_normal_scale.append(obj._normal_scale)
            leaf_mat_slot.append(_material_slot(obj.material))
            worlds.append((slot, obj._world_chain()))
            prims.append((slot, obj._prim_entries()))
            compile_scene.object_leaves += 1
            return (LEAF, slot)
        if isinstance(obj, Lenslet):
            return _walk(obj.materialise())
        raise TypeError(f"cannot compile component of type {type(obj)!r}")

    def _grid(grid, indices):
        """A run of one grid's lenslets in one pass (lenslets.py): per
        lenslet its sphere's slot, then its aperture's, and the tree
        ``intersect(sphere, aperture)``."""
        k = len(indices)
        (s_type, s_ids, s_chain, s_prim), (c_type, c_ids, c_chain, c_prim) = grid.leaves(indices)
        slots = np.arange(len(leaf_types), len(leaf_types) + 2 * k, 2)
        worlds.extend(((slots, s_chain), (slots + 1, c_chain)))
        prims.extend(((slots, s_prim), (slots + 1, c_prim)))
        leaf_types.extend([s_type, c_type] * k)
        leaf_ids.extend(np.stack((s_ids, c_ids), axis=1).ravel().tolist())
        leaf_normal_scale.extend([1] * (2 * k))
        leaf_mat_slot.extend([_material_slot(grid.material)] * (2 * k))
        compile_scene.grid_leaves += 2 * k
        op = _OP_NAMES[Operation.INTERSECT]
        return [(op, (LEAF, s), (LEAF, s + 1)) for s in slots.tolist()]

    trees = []
    position = 0
    while position < len(components):
        comp = components[position]
        if type(comp) is not Lenslet or not comp.on_grid():
            trees.append(_walk(comp))
            position += 1
            continue
        end = position + 1  # the run: consecutive handles of this grid
        while (end < len(components) and type(components[end]) is Lenslet
               and components[end].grid is comp.grid and components[end].on_grid()):
            end += 1
        run = components[position:end]
        trees.extend(_grid(comp.grid, np.fromiter((c.index for c in run), np.int64, len(run))))
        position = end
    trees = tuple(trees)

    spec = SceneSpec(
        leaf_types=tuple(leaf_types),
        leaf_ids=tuple(leaf_ids),
        leaf_normal_scale=tuple(leaf_normal_scale),
        leaf_mat_slot=tuple(leaf_mat_slot),
        mat_kinds=tuple(m.kind for m in materials),
        mat_packed=tuple(type(m) in _PACKED_TYPES for m in materials),
        trees=trees,
    )
    glass_rows = [m.glass_coeffs() for m in materials]
    world, prim = _leaf_tables(worlds, prims, len(leaf_types), dtype, device)
    params = {
        "world": world,
        "prim": prim,
        "glass": _stack(glass_rows, (0, matl.N_GLASS_COEFFS), dtype, device),
    }
    return CompiledScene(spec=spec, params=params, materials=tuple(materials))


compile_scene.grid_leaves = 0
compile_scene.object_leaves = 0

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
    """Stack per-leaf (or per-material) rows into one ``dtype`` tensor on
    ``device``.  Plain rows stack on NumPy; when any row is a tensor (a
    differentiable rebuild) they stack with ``torch.stack``, so the result's
    graph reaches the traced values."""
    if not entries:
        return torch.zeros(empty_shape, dtype=dtype, device=device)
    if any(isinstance(e, torch.Tensor) for e in entries):
        return torch.stack(
            [torch.as_tensor(e, dtype=dtype, device=device) for e in entries]
        )
    return torch.as_tensor(np.stack(entries), dtype=dtype, device=device)


def _leaf_tables(chains, prims, dtype, device):
    """``world`` (S, 4, 4) and ``prim`` (S, 6) from each leaf's transform
    chain and primitive entries (objects.py): the plain rows stack on NumPy
    as before, and the traced leaves come from one batched composition
    (scene/_factors.py), placed in slot order with one index op each."""
    world = _stack([m0 for m0, factors in chains], (0, 4, 4), dtype, device)
    prim = _stack([row for row, _ in prims], (0, prim_mod.PARAM_WIDTH), dtype, device)
    traced_world = [slot for slot, (_, factors) in enumerate(chains) if factors]
    traced_prim = [slot for slot, (_, entries) in enumerate(prims) if entries]
    if not traced_world and not traced_prim:
        return world, prim
    rows_world, rows_prim = compose(
        [chains[slot] for slot in traced_world], [prims[slot] for slot in traced_prim]
    )
    slots = torch.as_tensor(np.asarray(traced_world + traced_prim, dtype=np.int64), device=device)
    if traced_world:
        world = world.index_copy(
            0, slots[: len(traced_world)], rows_world.to(dtype=dtype, device=device)
        )
    if traced_prim:
        prim = prim.index_copy(
            0, slots[len(traced_world):], rows_prim.to(dtype=dtype, device=device)
        )
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
    worlds = []
    prims = []

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
            worlds.append(obj._world_chain())
            prims.append(obj._prim_entries())
            return (LEAF, slot)
        raise TypeError(f"cannot compile component of type {type(obj)!r}")

    trees = tuple(_walk(comp) for comp in components)

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
    world, prim = _leaf_tables(worlds, prims, dtype, device)
    params = {
        "world": world,
        "prim": prim,
        "glass": _stack(glass_rows, (0, matl.N_GLASS_COEFFS), dtype, device),
    }
    return CompiledScene(spec=spec, params=params, materials=tuple(materials))

"""Recorded transforms of a traced scene rebuild, composed in batches.

A world object moved by a traced value (a tensor that requires grad,
scene/_backend.py) does not multiply the move into its world matrix.  From
that transform on it records each elementary factor: its kind, its host
constants and its traced scalars (:class:`Factor`).  The world matrix is
the eager product ``F_k @ ... @ F_1 @ M0`` (the latest factor on the
left), where ``M0`` is the NumPy product of the plain transforms before the
first traced one.

:func:`compose` evaluates many such chains at once.  It groups them by the
signature of their factors, stacks each factor slot over the group, moves
every host constant to the device in one copy, and composes the chain in
the eager order with explicit multiply-adds (never ``matmul``: a float32
product on the card may take TF32).  So a rebuild of an array of lenslets
costs a few tensor ops per signature, not per lenslet, in its forward and
in its backward.  The traced scalars go through one table: distinct 0-d
tensors are stacked once, and 0-d views of one tensor (the radii
``r[i]`` of an array) are gathered from it by one index, whose backward is
one scatter.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "IDENTITY",
    "Factor",
    "entries_factor",
    "rotation_factor",
    "matrix_factor",
    "constant_factor",
    "mat4_mul",
    "compose",
]

IDENTITY = np.identity(4)
IDENTITY.flags.writeable = False


class Factor:
    """One elementary transform of a traced chain.  ``key`` is its part of
    the chain's signature: ``("entries", flat)`` is ``host`` with the
    traced ``values`` at the flat positions ``flat`` (a move or a scale);
    ``("rot", i, j, scale)`` the rotation by ``values[0] * scale`` radians
    in the (i, j) plane; ``("mat",)`` the traced (4, 4) ``values[0]``;
    ``("const",)`` the host matrix ``host``."""

    __slots__ = ("key", "host", "values")

    def __init__(self, key, host, values):
        self.key = key
        self.host = host
        self.values = values


def _scalar(value):
    return value.reshape(()) if value.dim() else value


def entries_factor(template, flat, values) -> Factor:
    """``template`` (host (4, 4)) with traced 0-d ``values`` at the flat
    positions ``flat``."""
    return Factor(("entries", tuple(flat)), template, tuple(_scalar(v) for v in values))


def rotation_factor(axes, angle, scale) -> Factor:
    i, j = axes
    return Factor(("rot", i, j, scale), None, (_scalar(angle),))


def matrix_factor(matrix: torch.Tensor) -> Factor:
    return Factor(("mat",), None, (matrix,))


def constant_factor(matrix) -> Factor:
    return Factor(("const",), np.array(matrix, dtype=float), ())


def mat4_mul(a, b):
    """``a @ b`` over leading batch axes, as explicit multiply-adds summed
    left to right (no TF32 path)."""
    return (
        a[..., :, 0, None] * b[..., None, 0, :]
        + a[..., :, 1, None] * b[..., None, 1, :]
        + a[..., :, 2, None] * b[..., None, 2, :]
        + a[..., :, 3, None] * b[..., None, 3, :]
    )


def _flat_view(t):
    """``(root, flat index)`` when the 0-d tensor ``t`` is a view of one
    element of a contiguous root of its dtype that requires grad: the
    element's value and gradient are then the root's at that index."""
    base = t._base
    if (
        base is None
        or t.dim() != 0
        or base.dtype != t.dtype
        or not base.requires_grad
        or not base.is_contiguous()
    ):
        return None
    offset = t.storage_offset() - base.storage_offset()
    if not 0 <= offset < base.numel():
        return None
    return base, offset


class _Uploads:
    """Host arrays gathered for one copy to the device; ``add`` returns a
    handle that ``view`` turns into a view of the uploaded tensor."""

    def __init__(self, np_dtype):
        self.parts = []
        self.size = 0
        self.np_dtype = np_dtype

    def add(self, array):
        array = np.asarray(array, dtype=self.np_dtype)
        handle = (self.size, array.shape)
        self.parts.append(array.reshape(-1))
        self.size += array.size
        return handle

    def upload(self, dtype, device):
        if not self.parts:
            return None
        return torch.as_tensor(np.concatenate(self.parts), dtype=dtype, device=device)

    @staticmethod
    def view(flat, handle):
        offset, shape = handle
        n = int(np.prod(shape, dtype=np.int64))
        return flat[offset:offset + n].view(shape)


class _Table:
    """The traced scalars of one rebuild, each distinct tensor once."""

    def __init__(self):
        self.handle_of = {}
        self.values = []

    def add(self, t) -> int:
        key = id(t)
        handle = self.handle_of.get(key)
        if handle is None:
            handle = self.handle_of[key] = len(self.values)
            self.values.append(t)
        return handle

    def layout(self, ints):
        """Plan the table: ``(where, plan)`` with ``where[handle]`` the
        position of each value and ``plan`` the parts in table order."""
        where = np.empty(len(self.values), dtype=np.int64)
        roots, bases = [], {}
        for handle, t in enumerate(self.values):
            view = _flat_view(t)
            if view is None:
                roots.append(handle)
            else:
                base, offset = view
                bases.setdefault(id(base), (base, []))[1].append((handle, offset))
        plan, position = [], 0
        if roots:
            plan.append(("stack", [self.values[h] for h in roots]))
            where[roots] = np.arange(position, position + len(roots))
            position += len(roots)
        for base, members in bases.values():
            handles = [h for h, _ in members]
            plan.append(("gather", base, ints.add([o for _, o in members])))
            where[handles] = np.arange(position, position + len(members))
            position += len(members)
        return where, plan

    @staticmethod
    def build(plan, int_flat, dtype, device):
        parts = []
        for part in plan:
            if part[0] == "stack":
                parts.append(torch.stack([t.to(dtype=dtype, device=device) for t in part[1]]))
            else:
                _, base, handle = part
                index = _Uploads.view(int_flat, handle)
                parts.append(base.reshape(-1).index_select(0, index).to(dtype=dtype,
                                                                        device=device))
        return parts[0] if len(parts) == 1 else torch.cat(parts)


def _rotation_flat(i, j):
    """Flat positions of a rotation's (cos, cos, -sin, sin) entries."""
    return (5 * i, 5 * j, 4 * i + j, 4 * j + i)


def compose(chains, prims=()):
    """World matrices of traced chains and packed rows of traced primitives.

    ``chains``: ``(m0, factors)`` per object, ``m0`` a host (4, 4) matrix
    and ``factors`` a sequence of :class:`Factor`; ``prims``: ``(row,
    entries)`` per primitive, ``row`` its host (6,) values and ``entries``
    ``(column, traced 0-d tensor)`` pairs.  The work runs at the first
    traced value's dtype and device, as the eager product did.  Returns
    ``(worlds (len(chains), 4, 4), rows (len(prims), 6))``, either None
    when empty.
    """
    table, matrices = _Table(), _Table()
    floats, ints = _Uploads(np.float64), _Uploads(np.int64)

    groups = {}
    for index, (_, factors) in enumerate(chains):
        groups.setdefault(tuple(f.key for f in factors), []).append(index)
    plans = []
    for signature, members in groups.items():
        slots = []
        for position, key in enumerate(signature):
            factors = [chains[i][1][position] for i in members]
            if key[0] == "const":
                slots.append((floats.add(np.stack([f.host for f in factors])),))
            elif key[0] == "entries":
                slots.append((floats.add(np.stack([f.host for f in factors])), ints.add(key[1]),
                              [[table.add(v) for v in f.values] for f in factors]))
            elif key[0] == "rot":
                slots.append((floats.add(np.broadcast_to(IDENTITY, (len(members), 4, 4))),
                              ints.add(_rotation_flat(key[1], key[2])),
                              [[table.add(f.values[0])] for f in factors]))
            else:
                slots.append((ints.add([matrices.add(f.values[0]) for f in factors]),))
        m0 = floats.add(np.stack([chains[i][0] for i in members]))
        plans.append((signature, members, m0, slots))
    prim_plan = None
    if prims:
        flat, handles = [], []
        for row, (_, entries) in enumerate(prims):
            for column, value in entries:
                flat.append(6 * row + column)
                handles.append(table.add(value))
        prim_plan = [floats.add(np.stack([r for r, _ in prims])), ints.add(flat), handles]

    first = (table.values or matrices.values)[0]
    dtype, device = first.dtype, first.device
    where, table_plan = table.layout(ints)

    def positions(handles):
        return ints.add(where[np.asarray(handles, dtype=np.int64)])

    for _, _, _, slots in plans:
        for s, slot in enumerate(slots):
            if len(slot) == 3:  # entries and rotations: traced scalars
                slots[s] = slot[:2] + (positions(slot[2]),)
    if prim_plan is not None:
        prim_plan[2] = positions(prim_plan[2])
    # the groups' rows come out in group order: back to chain order
    order = np.concatenate([members for _, members, _, _ in plans]) if plans else []
    reorder = None
    if np.any(np.diff(order) < 0):
        inverse = np.empty(len(order), dtype=np.int64)
        inverse[order] = np.arange(len(order))
        reorder = ints.add(inverse)

    float_flat = floats.upload(dtype, device)
    int_flat = ints.upload(torch.int64, device)

    def floats_at(handle):
        return _Uploads.view(float_flat, handle)

    def ints_at(handle):
        return _Uploads.view(int_flat, handle)

    values = _Table.build(table_plan, int_flat, dtype, device) if table.values else None
    mats = (torch.stack([m.to(dtype=dtype, device=device) for m in matrices.values])
            if matrices.values else None)

    outputs = []
    for signature, members, m0, slots in plans:
        world = floats_at(m0)
        k = len(members)
        for key, slot in zip(signature, slots):
            if key[0] == "const":
                factor = floats_at(slot[0])
            elif key[0] == "mat":
                factor = mats[ints_at(slot[0])]
            else:
                traced = values[ints_at(slot[2])]
                if key[0] == "rot":
                    angle = traced[:, 0] * key[3]
                    sin, cos = torch.sin(angle), torch.cos(angle)
                    traced = torch.stack((cos, cos, -sin, sin), dim=1)
                factor = floats_at(slot[0]).reshape(k, 16).index_copy(
                    1, ints_at(slot[1]), traced).view(k, 4, 4)
            world = mat4_mul(factor, world)
        outputs.append(world)

    worlds = None
    if outputs:
        worlds = outputs[0] if len(outputs) == 1 else torch.cat(outputs)
        if reorder is not None:
            worlds = worlds[ints_at(reorder)]
    rows = None
    if prim_plan is not None:
        base = floats_at(prim_plan[0])
        rows = base.reshape(-1).index_copy(
            0, ints_at(prim_plan[1]), values[ints_at(prim_plan[2])]).view(base.shape)
    return worlds, rows

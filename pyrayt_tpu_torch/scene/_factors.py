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

A chain may also come stacked: ``m0`` (k, 4, 4) and factors whose hosts
are (k, 4, 4) and whose traced values are columns (k,) or 0-d tensors
shared by the k members (a grid of lenslets, scene/lenslets.py).  Its
columns join the table as the views of their root they are, so its rows
are those of the k chains given one by one, bit for bit.
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
    cols = a.unsqueeze(-1).unbind(-2)  # a[..., :, k, None]
    rows = b.unsqueeze(-3).unbind(-2)  # b[..., None, k, :]
    return cols[0] * rows[0] + cols[1] * rows[1] + cols[2] * rows[2] + cols[3] * rows[3]


def _flat_view(t):
    """``(root, flat index)`` when the 0-d tensor ``t`` is a view of one
    element of a contiguous root of its dtype that requires grad: the
    element's value and gradient are then the root's at that index.  For a
    column (1-D) ``t`` that is such a root or a view of one, the index is
    the column's (k,) flat indices."""
    if t.dim() == 1:
        base = t if t._base is None else t._base
    elif t.dim() == 0:
        base = t._base
    else:
        return None
    if (
        base is None
        or base.dtype != t.dtype
        or not base.requires_grad
        or not base.is_contiguous()
    ):
        return None
    offset = t.storage_offset() - base.storage_offset()
    if t.dim():
        offset = offset + t.stride(0) * np.arange(t.shape[0])
        if t.shape[0] and not (0 <= offset.min() and offset.max() < base.numel()):
            return None
    elif not 0 <= offset < base.numel():
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
        strides, step = [], 1
        for n in reversed(shape):
            strides.insert(0, step)
            step *= int(n)
        return flat.as_strided(shape, strides, flat.storage_offset() + offset)


class _Table:
    """The traced values of one rebuild, each distinct tensor once: a 0-d
    tensor (or a traced matrix) takes one handle, a column (a 1-D tensor,
    one value per member of a stacked chain) one handle per element."""

    def __init__(self):
        self.handle_of = {}
        self.values = []  # the tensors added
        self.size = 0  # handles so far

    def add(self, t) -> int:
        key = id(t)
        handle = self.handle_of.get(key)
        if handle is None:
            handle = self.handle_of[key] = self.size
            self.values.append(t)
            self.size += 1
        return handle

    def add_column(self, t) -> np.ndarray:
        key = id(t)
        handles = self.handle_of.get(key)
        if handles is None:
            handles = self.handle_of[key] = np.arange(self.size, self.size + t.shape[0])
            self.values.append(t)
            self.size += t.shape[0]
        return handles

    def add_members(self, t, k) -> np.ndarray:
        """The (k,) handles of a stacked chain's traced value: a column's
        own, or a shared 0-d tensor's one handle k times."""
        return self.add_column(t) if t.dim() else np.full(k, self.add(t))

    def layout(self, ints):
        """Plan the table: ``(where, plan)`` with ``where[handle]`` the
        position of each value and ``plan`` the parts in table order."""
        where = np.empty(self.size, dtype=np.int64)
        roots, columns, bases = [], [], {}
        for t in self.values:
            handle = self.handle_of[id(t)]
            view = _flat_view(t)
            if view is None:
                (columns if t.dim() else roots).append((handle, t))
                continue
            base, offset = view
            # a base's 0-d views, then its columns (k handles and offsets each)
            _, views, cols = bases.setdefault(id(base), (base, ([], []), ([], [])))
            part = cols if t.dim() else views
            part[0].append(handle)
            part[1].append(offset)
        plan, position = [], 0
        if roots:
            plan.append(("stack", [t for _, t in roots]))
            where[[h for h, _ in roots]] = np.arange(position, position + len(roots))
            position += len(roots)
        for handles, t in columns:
            plan.append(("column", t))
            where[handles] = np.arange(position, position + len(handles))
            position += len(handles)
        for base, views, cols in bases.values():
            handles, offsets = (np.concatenate([np.asarray(v, dtype=np.int64)] + c)
                                for v, c in zip(views, cols))
            plan.append(("gather", base, ints.add(offsets)))
            where[handles] = np.arange(position, position + len(handles))
            position += len(handles)
        return where, plan

    @staticmethod
    def build(plan, int_flat, dtype, device):
        parts = []
        for part in plan:
            if part[0] == "stack":
                parts.append(torch.stack([t.to(dtype=dtype, device=device) for t in part[1]]))
            elif part[0] == "column":
                parts.append(part[1].to(dtype=dtype, device=device))
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
    ``(column, traced 0-d tensor)`` pairs.  A stacked chain (``m0`` (k, 4,
    4), constant, entries and rotation factors) gives k rows, and a stacked
    primitive (``row`` (k, 6), each traced value a column or a shared 0-d
    tensor) k rows.  The work runs at the first traced value's dtype and
    device, as the eager product did.  Returns ``(worlds (rows of chains,
    4, 4), rows (rows of prims, 6))``, either None when empty.
    """
    table, matrices = _Table(), _Table()
    floats, ints = _Uploads(np.float64), _Uploads(np.int64)

    # chain i's rows start at first[i]; a stacked chain is a group of its own
    sizes = [len(m0) if np.ndim(m0) == 3 else 1 for m0, _ in chains]
    first = np.cumsum([0] + sizes)
    groups = {}
    for index, (m0, factors) in enumerate(chains):
        key = tuple(f.key for f in factors)
        groups.setdefault(key if np.ndim(m0) == 2 else (index,), []).append(index)
    plans = []
    for members in groups.values():
        signature = tuple(f.key for f in chains[members[0]][1])
        stacked = np.ndim(chains[members[0]][0]) == 3
        k = sizes[members[0]] if stacked else len(members)
        slots = []
        for position, key in enumerate(signature):
            if stacked:
                factor = chains[members[0]][1][position]
                hosts = None if factor.host is None else np.broadcast_to(factor.host, (k, 4, 4))
                if key[0] == "mat":
                    raise TypeError("a stacked chain takes no traced matrix factor")
                handles = [table.add_members(v, k) for v in factor.values]
                handles = np.stack(handles, axis=1) if handles else None
            else:
                factors = [chains[i][1][position] for i in members]
                if key[0] == "mat":
                    slots.append((ints.add([matrices.add(f.values[0]) for f in factors]),))
                    continue
                hosts = None if key[0] == "rot" else np.stack([f.host for f in factors])
                handles = [[table.add(v) for v in f.values] for f in factors]
            if key[0] == "const":
                slots.append((floats.add(hosts),))
            elif key[0] == "entries":
                slots.append((floats.add(hosts), ints.add(key[1]), handles))
            else:
                slots.append((floats.add(np.broadcast_to(IDENTITY, (k, 4, 4))),
                              ints.add(_rotation_flat(key[1], key[2])), handles))
        if stacked:
            m0 = floats.add(chains[members[0]][0])
            rows = np.arange(first[members[0]], first[members[0] + 1])
        else:
            m0 = floats.add(np.stack([chains[i][0] for i in members]))
            rows = first[members]
        plans.append((signature, rows, m0, slots))
    prim_plan = None
    if prims:
        flat, handles, start = [], [], 0
        for row, entries in prims:
            k = len(row) if np.ndim(row) == 2 else 0
            for column, value in entries:
                if k:
                    flat.append(6 * (start + np.arange(k)) + column)
                    handles.append(table.add_members(value, k))
                else:
                    flat.append(6 * start + column)
                    handles.append(table.add(value))
            start += max(k, 1)
        base = np.concatenate([np.reshape(r, (-1, 6)) for r, _ in prims])
        prim_plan = [floats.add(base), ints.add(np.hstack(flat)), np.hstack(handles)]

    lead = (table.values or matrices.values)[0]
    dtype, device = lead.dtype, lead.device
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
    order = np.concatenate([rows for _, rows, _, _ in plans]) if plans else []
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
    for signature, rows, m0, slots in plans:
        world = floats_at(m0)
        k = len(rows)
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

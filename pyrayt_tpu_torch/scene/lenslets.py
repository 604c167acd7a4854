"""A grid of plano-convex lenslets as one record.

``components.microlens_array`` makes one :class:`LensletGrid` and returns
a list of :class:`Lenslet` handles to it, one a lenslet, row-major.  The
record holds the radii as given, the spheres' offsets ``-(r - thickness /
2)`` (one op), the grid's y and z offsets, the aperture, the material and
a block of ids, three a lenslet in the order its objects take them
(aperture, sphere, CSG node).  No object is made per lenslet:
``compile_scene`` expands each run of consecutive handles of one grid in
one batched pass (:meth:`LensletGrid.leaves`), with the same spec rows and
the same factors, in the same order, as the lenslets' own objects give,
so its params are theirs bit for bit.

Any other use of a handle than ``get_id()`` (a transform, an attribute of
the CSG objects, a move of an ``ObjectGroup`` that holds it) builds that
lenslet's objects (:meth:`Lenslet.materialise`), exactly as
``plano_convex_lens`` would, with its reserved ids, and forwards the use
to them.  A built lenslet compiles with its grid while its leaves keep the
grid's pose, material and normals, and on the per-object path once one of
them changed.
"""

from __future__ import annotations

import numbers

import numpy as np
import torch

from pyrayt_tpu_torch.scene._backend import host, is_traced, plain
from pyrayt_tpu_torch.scene._factors import IDENTITY, Factor
from pyrayt_tpu_torch.scene.objects import (
    _MOVE_ENTRIES,
    ROTATION_PLANES,
    WorldObject,
    fresh_ids,
    reserve_ids,
)
from pyrayt_tpu_torch.scene.surfaces import Sphere

__all__ = ["LensletGrid", "Lenslet"]

_IDS_PER_LENSLET = 3  # aperture, sphere, CSG node
_Y, _Z = _MOVE_ENTRIES[1], _MOVE_ENTRIES[2]  # a move's flat y and z positions


def _real(value) -> bool:
    return isinstance(value, numbers.Real)


def _batchable(r, thickness, pitch, aperture) -> bool:
    """True when the grid's numbers are ones its batched expansion takes:
    plain thickness, pitch and aperture, and radii that are one number, a
    tensor of at most one axis, or a flat NumPy array or list of numbers."""
    shape = aperture if isinstance(aperture, (tuple, list)) else (aperture,)
    if not all(_real(v) for v in (thickness, pitch, *shape)):
        return False
    if isinstance(r, torch.Tensor):
        return r.dim() <= 1
    if isinstance(r, np.ndarray):
        return r.ndim <= 1 and r.dtype.kind in "fiu"
    if isinstance(r, (tuple, list)):
        return all(_real(v) for v in r)
    return _real(r)


def _moves(flat, offsets):
    """Stacked moves: the identity with ``offsets`` at the flat position
    ``flat``, as ``WorldObject.move`` makes them one by one."""
    tx = np.broadcast_to(IDENTITY, (len(offsets), 4, 4)).reshape(-1, 16).copy()
    tx[:, flat] = offsets
    return tx.reshape(-1, 4, 4)


class LensletGrid:
    """The numbers of one ``microlens_array(r, thickness, nx, ny, pitch,
    aperture, material)`` call; ``plano_convex(r, thickness, sphere_z,
    aperture, material)`` builds one lenslet before its rotations.  When
    the numbers are not ones the batched expansion takes (``batched``
    False: traced thickness, pitch or aperture, or radii of another form),
    every lenslet compiles on the per-object path."""

    def __init__(self, r, thickness, nx, ny, pitch, aperture, material, plano_convex):
        self.nx, self.ny, self.n = nx, ny, nx * ny
        self.r, self.thickness, self.pitch = r, thickness, pitch
        self.aperture, self.material = aperture, material
        self.plano_convex = plano_convex
        self.per_lenslet = np.ndim(r) > 0
        self.batched = self.n > 0 and _batchable(r, thickness, pitch, aperture)
        self.traced = is_traced(r)
        # the spheres' offsets in one op: a tensor's (traced or not) as a
        # tensor, views of which the built lenslets take
        radii = plain(r)
        self.sphere_z = -(radii - thickness / 2) if isinstance(radii, torch.Tensor) else None
        if self.batched and not self.traced:
            # host values, as each lenslet's objects read them on its build
            values = r if isinstance(r, torch.Tensor) else np.array(r)
            offsets = self.sphere_z if self.sphere_z is not None else -(values - thickness / 2)
            self.radii_host, self.sphere_z_host = host(values), host(offsets)
        self.first_id = reserve_ids(_IDS_PER_LENSLET * self.n)
        self._tables = None

    def lenslets(self):
        return [Lenslet(self, i) for i in range(self.n)]

    def ids(self, i):
        """The ids of lenslet ``i``'s aperture, sphere and CSG node."""
        first = self.first_id + _IDS_PER_LENSLET * i
        return first, first + 1, first + 2

    def _position(self, i):
        iy, iz = divmod(i, self.nx)
        return ((iy - (self.ny - 1) / 2.0) * self.pitch,
                (iz - (self.nx - 1) / 2.0) * self.pitch)

    def build(self, i):
        """Lenslet ``i``'s objects, with its reserved ids."""
        if self.traced or not self.batched:
            r_i = self.r[i] if self.per_lenslet else self.r
            if self.sphere_z is None:
                z_i = -(r_i - self.thickness / 2)
            else:
                z_i = self.sphere_z[i] if self.per_lenslet else self.sphere_z
        else:
            r_i, z_i = (self.radii_host[i], self.sphere_z_host[i]) if self.per_lenslet else (
                self.radii_host, self.sphere_z_host)
        y, z = self._position(i)
        with fresh_ids(self.first_id + _IDS_PER_LENSLET * i):
            lens = self.plano_convex(r_i, self.thickness, z_i, self.aperture, self.material)
        return lens.rotate_y(90).rotate_x(90).move_y(y).move_z(z)

    def _host_tables(self):
        """The host matrices of every lenslet, made once: the rotations,
        the stacked moves, the aperture's world matrices and its row, and
        for plain radii the spheres' world matrices and rows.  Each product
        is the objects' own, ``new @ tx`` one transform at a time."""
        if self._tables is not None:
            return self._tables
        with fresh_ids():  # a prototype for the aperture leaf's numbers
            cap = self.plano_convex(1.0, self.thickness, 0.0, self.aperture, self.material).r_child
        ry = WorldObject._rotation(ROTATION_PLANES["y"], 90, "deg")
        rx = WorldObject._rotation(ROTATION_PLANES["x"], 90, "deg")
        y = np.repeat((np.arange(self.ny) - (self.ny - 1) / 2.0) * self.pitch, self.nx)
        z = np.tile((np.arange(self.nx) - (self.nx - 1) / 2.0) * self.pitch, self.ny)
        my, mz = _moves(_Y, y), _moves(_Z, z)
        t = {"ry": ry, "rx": rx, "my": my, "mz": mz, "cap_type": cap.prim_type,
             "cap_world": np.matmul(mz, np.matmul(my, rx @ (ry @ cap._world_chain()[0]))),
             "cap_row": np.broadcast_to(cap._prim_entries()[0], (self.n, 6))}
        if not self.traced:
            world = np.matmul(_moves(_Z, np.broadcast_to(self.sphere_z_host, (self.n,))),
                              IDENTITY)
            for m in (ry, rx, my, mz):
                world = np.matmul(m, world)
            row = np.zeros((self.n, 6))
            row[:, 0] = self.radii_host
            t["sphere_world"], t["sphere_row"] = world, row
        self._tables = t
        return t

    def _column(self, values, indices):
        """The traced ``values`` (a column over the grid, or a shared 0-d
        tensor) of the lenslets ``indices``: the column itself, a slice of
        it, or one gather."""
        if values.dim() == 0 or len(indices) == self.n and np.array_equal(indices,
                                                                          np.arange(self.n)):
            return values
        if np.array_equal(indices, np.arange(indices[0], indices[0] + len(indices))):
            return values[indices[0]:indices[0] + len(indices)]
        return values[torch.as_tensor(indices, device=values.device)]

    def leaves(self, indices):
        """The lenslets ``indices``, stacked: ``(sphere, aperture)``, each
        ``(prim_type, ids, chain, prim)`` with ``chain`` a stacked ``(m0,
        factors)`` and ``prim`` a stacked ``(rows, entries)``
        (scene/_factors.py:compose)."""
        t = self._host_tables()
        k = len(indices)
        ids = self.first_id + _IDS_PER_LENSLET * indices
        cap = (t["cap_type"], ids, (t["cap_world"][indices], ()), (t["cap_row"][:k], ()))
        if not self.traced:
            chain = (t["sphere_world"][indices], ())
            prim = (t["sphere_row"][indices], ())
        else:
            eye = np.broadcast_to(IDENTITY, (k, 4, 4))
            move = Factor(("entries", (_Z,)), eye, (self._column(self.sphere_z, indices),))
            consts = [Factor(("const",), m, ()) for m in (t["ry"], t["rx"], t["my"][indices],
                                                           t["mz"][indices])]
            chain = (eye, (move, *consts))
            prim = (np.zeros((k, 6)), ((0, self._column(self.r, indices)),))
        return (Sphere.prim_type, ids + 1, chain, prim), cap


class Lenslet:
    """Lenslet ``index`` of a :class:`LensletGrid`: what
    ``microlens_array`` returns in place of the lenslet's CSG object.
    ``get_id()`` reads its reserved id; any other attribute builds the
    lenslet's objects (:meth:`materialise`) and is read from them."""

    __slots__ = ("grid", "index", "_lens", "_marks")

    def __init__(self, grid: LensletGrid, index: int):
        object.__setattr__(self, "grid", grid)
        object.__setattr__(self, "index", index)
        object.__setattr__(self, "_lens", None)
        object.__setattr__(self, "_marks", ())

    def get_id(self) -> int:
        return self.grid.ids(self.index)[2]

    def materialise(self):
        """The lenslet's CSG object, built on first use and kept."""
        if self._lens is None:
            lens = self.grid.build(self.index)
            marks = tuple((leaf, leaf._plain_tx, leaf._factors)
                          for leaf in (lens.l_child, lens.r_child))
            object.__setattr__(self, "_lens", lens)
            object.__setattr__(self, "_marks", marks)
        return self._lens

    def on_grid(self) -> bool:
        """True while the lenslet compiles with its grid: unbuilt, or built
        and its leaves since then not moved, given another material or
        their normals flipped."""
        if self._lens is None or not self.grid.batched:
            return self.grid.batched
        material = self.grid.material
        return all(leaf._plain_tx is tx and leaf._factors is factors
                   and leaf.material is material and leaf._normal_scale == 1
                   for leaf, tx, factors in self._marks)

    def __getattr__(self, name):
        if name.startswith("__") or name in Lenslet.__slots__:
            raise AttributeError(name)
        return getattr(self.materialise(), name)

    def __setattr__(self, name, value):
        if name in Lenslet.__slots__:
            object.__setattr__(self, name, value)
        else:
            setattr(self.materialise(), name, value)

    def __repr__(self):
        return f"Lenslet({self.index} of {self.grid.ny}x{self.grid.nx})"

"""Scene-graph builder objects.

Counterpart of ``pyrayt_tpu.scene.objects``: world objects with the same
movement/chaining API.  These are *builders*: they hold 4x4 NumPy
transforms and packed primitive parameters and compile into the flat
scene representation the trace engines consume (scene/compile.py).

Object identity: every object draws a monotonically increasing id from a
global counter; that id is what appears in the results frame's
``surface`` column.  Wrap a rebuild in ``fresh_ids()`` so ids repeat.
"""

from __future__ import annotations

import abc
import contextlib
import copy
import itertools
import math

import numpy as np
import torch

from pyrayt_tpu_torch.core import primitives as prim
from pyrayt_tpu_torch.core.operations import affine_inverse, transform_rays
from pyrayt_tpu_torch.scene._backend import (
    as_tensor_like,
    first_tensor,
    host,
    is_traced,
    plain,
)

__all__ = [
    "CountedObject",
    "fresh_ids",
    "WorldObject",
    "ObjectGroup",
    "Intersectable",
    "TracerSurface",
    "bounding_box_spans",
]


class CountedObject:
    """Global monotonically-increasing object ids."""

    _ids = itertools.count(0)

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._id = next(CountedObject._ids)

    def get_id(self) -> int:
        return self._id


@contextlib.contextmanager
def fresh_ids(start: int = 0):
    """Reset the global id counter inside the context, restoring it after,
    so a rebuilt scene emits the same ids."""
    saved = CountedObject._ids
    CountedObject._ids = itertools.count(start)
    try:
        yield
    finally:
        CountedObject._ids = saved


def _copy(matrix):
    """A copy that keeps a tensor's graph (``copy.copy`` would cut it)."""
    return matrix.clone() if isinstance(matrix, torch.Tensor) else copy.copy(matrix)


def _transform_operands(new_transform, old):
    """``(new, old)`` ready to multiply: NumPy arrays on the plain path,
    tensors (of the first tensor's dtype and device) when either is one."""
    new_transform = plain(new_transform)
    ref = first_tensor(new_transform, old)
    if ref is None:
        return np.asarray(new_transform, dtype=float), old
    return as_tensor_like(new_transform, ref), as_tensor_like(old, ref)


class WorldObject(CountedObject):
    """An object in 3D space with chainable move/scale/rotate operations
    (deg/rad units, negative scales prohibited).

    Any argument may be a tensor that requires grad; the world transform
    then becomes a tensor carrying that gradient (scene/_backend.py)."""

    @staticmethod
    def _sin_cos(angle, units="deg"):
        if units == "deg":
            scale = math.pi / 180.0
        elif units == "rad":
            scale = 1.0
        else:
            raise ValueError(f"{units} is not a valid option for angle units")
        angle = plain(angle)
        if is_traced(angle):
            return torch.sin(angle * scale), torch.cos(angle * scale)
        return math.sin(float(angle) * scale), math.cos(float(angle) * scale)

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._obj_origin = np.array([0.0, 0.0, 0.0, 1.0])
        self._obj_direction = np.array([0.0, 0.0, 1.0, 0.0])
        self._world_coordinate_transform = np.identity(4)
        self._object_coordinate_transform = np.identity(4)
        self._world_origin = self._obj_origin
        self._world_direction = self._obj_direction
        # callbacks fired whenever the world transform changes
        self.var_watchlist = [self._world_matrix_update_handler]

    # -- transform bookkeeping ------------------------------------------------

    def _world_matrix_update_handler(self):
        tx = self._world_coordinate_transform
        if isinstance(tx, torch.Tensor):
            self._world_origin = tx @ as_tensor_like(self._obj_origin, tx)
            world_dir = tx @ as_tensor_like(self._obj_direction, tx)
            # the norm check needs a concrete value; traced values skip it
            self._world_direction = world_dir / torch.linalg.norm(world_dir)
            self._object_coordinate_transform = affine_inverse(tx)
            return
        self._world_origin = tx @ self._obj_origin
        world_dir = tx @ self._obj_direction
        norm = np.linalg.norm(world_dir)
        if float(norm) < 1e-7:
            raise ValueError(f"Measured Norm of World Vector below tolerance: {norm}")
        self._world_direction = world_dir / norm
        self._object_coordinate_transform = np.linalg.inv(tx)

    def _append_world_transform(self, new_transform):
        new, old = _transform_operands(new_transform, self._world_coordinate_transform)
        self._world_coordinate_transform = new @ old
        for fn in self.var_watchlist:
            fn()

    # -- getters --------------------------------------------------------------

    def get_position(self):
        return self._world_origin

    def get_orientation(self):
        return self._world_direction

    def get_quaternion(self):
        from scipy.spatial import transform as scipy_transform

        r = scipy_transform.Rotation.from_matrix(host(self._world_coordinate_transform)[:-1, :-1])
        return r.as_quat()

    def get_world_transform(self):
        return _copy(self._world_coordinate_transform)

    def get_object_transform(self):
        return _copy(self._object_coordinate_transform)

    def to_object_coordinates(self, coordinates):
        return self._object_coordinate_transform @ np.asarray(coordinates)

    def to_world_coordinates(self, coordinates):
        return self._world_coordinate_transform @ np.asarray(coordinates)

    # -- movement -------------------------------------------------------------

    def move(self, x=0, y=0, z=0):
        x, y, z = plain((x, y, z))
        if is_traced(x, y, z):
            ref = first_tensor(x, y, z)
            tx = torch.eye(4, dtype=ref.dtype, device=ref.device)
            column = as_tensor_like((x, y, z), ref)
            tx = torch.cat((torch.cat((tx[:3, :3], column[:, None]), dim=1), tx[3:]))
        else:
            tx = np.identity(4)
            tx[:-1, -1] = [float(v) for v in (x, y, z)]
        self._append_world_transform(tx)
        return self

    def move_x(self, movement):
        return self.move(x=movement)

    def move_y(self, movement):
        return self.move(y=movement)

    def move_z(self, movement):
        return self.move(z=movement)

    def scale(self, x=1, y=1, z=1):
        x, y, z = plain((x, y, z))
        for val in (x, y, z):
            if not is_traced(val) and float(val) < 0:
                raise ValueError("Negative values for scale operations are prohibited")
        if is_traced(x, y, z):
            ref = first_tensor(x, y, z)
            tx = torch.diag(as_tensor_like((x, y, z, 1.0), ref))
        else:
            tx = np.diag((float(x), float(y), float(z), 1.0))
        self._append_world_transform(tx)
        return self

    def scale_x(self, scale_val):
        return self.scale(x=scale_val)

    def scale_y(self, scale_val):
        return self.scale(y=scale_val)

    def scale_z(self, scale_val):
        return self.scale(z=scale_val)

    def scale_all(self, scale_val):
        return self.scale(scale_val, scale_val, scale_val)

    @staticmethod
    def _rotation_matrix(axes, sin_a, cos_a):
        (i, j) = axes
        if is_traced(sin_a, cos_a):
            ref = first_tensor(sin_a, cos_a)
            entries = {(i, i): cos_a, (j, j): cos_a, (i, j): -sin_a, (j, i): sin_a}
            one = torch.ones((), dtype=ref.dtype, device=ref.device)
            rows = [
                torch.stack(
                    [
                        as_tensor_like(entries.get((r, c), one if r == c else 0.0 * one), ref)
                        for c in range(4)
                    ]
                )
                for r in range(4)
            ]
            return torch.stack(rows)
        tx = np.identity(4)
        tx[i, i] = cos_a
        tx[j, j] = cos_a
        tx[i, j] = -sin_a
        tx[j, i] = sin_a
        return tx

    def rotate_x(self, angle, units="deg"):
        sin_a, cos_a = self._sin_cos(angle, units)
        self._append_world_transform(self._rotation_matrix((1, 2), sin_a, cos_a))
        return self

    def rotate_y(self, angle, units="deg"):
        sin_a, cos_a = self._sin_cos(angle, units)
        self._append_world_transform(self._rotation_matrix((2, 0), sin_a, cos_a))
        return self

    def rotate_z(self, angle, units="deg"):
        sin_a, cos_a = self._sin_cos(angle, units)
        self._append_world_transform(self._rotation_matrix((0, 1), sin_a, cos_a))
        return self

    def transform(self, transform_matrix):
        self._append_world_transform(transform_matrix)
        return self


class ObjectGroup(WorldObject):
    """Rigid assembly: transforms applied to the group propagate to members."""

    def __init__(self, initlist=None, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.data = list(initlist) if initlist is not None else []

    def __iter__(self):
        return iter(self.data)

    def __len__(self):
        return len(self.data)

    def __getitem__(self, item):
        return self.data[item]

    def append(self, item):
        self.data.append(item)

    def _append_world_transform(self, new_transform):
        super()._append_world_transform(new_transform)
        for surface in self.data:
            surface.transform(new_transform)


def bounding_box_spans(point_set):
    """(3, 2) per-axis (min, max) spans of a homogeneous point set (4, k)."""
    point_set = host(point_set)
    return np.stack((np.min(point_set[:3], axis=1), np.max(point_set[:3], axis=1)), axis=1)


class Intersectable(WorldObject, abc.ABC):
    """Base for anything traceable."""

    _normal_scale = 1

    @abc.abstractmethod
    def intersect(self, rays):
        """Eager intersection; returns ``(hits (m, n), surface_ids (m, n))``."""

    @property
    def bounding_box(self):
        """(3, 2) world-space AABB spans (min, max per axis)."""
        return self._aobb_spans

    @property
    def bounding_volume(self):
        return self._aobb_spans

    def attach_to(self, parent_object: WorldObject) -> None:
        self._parent = parent_object
        self.var_watchlist += parent_object.var_watchlist

    def invert_normals(self):
        self._normal_scale = -1

    def reset_normals(self):
        self._normal_scale = 1

    @property
    def surface_ids(self) -> tuple:
        return ((self.get_id(), self),)


def _corners_to_cube_points(spans):
    """8 homogeneous corner points of a (3, 2) span box, shape (4, 8)."""
    spans = host(spans)
    corners = [
        (spans[0, ix], spans[1, iy], spans[2, iz], 1.0)
        for ix in range(2)
        for iy in range(2)
        for iz in range(2)
    ]
    return np.asarray(corners).T


class TracerSurface(Intersectable, abc.ABC):
    """Binds a primitive type code + packed parameters + material + transform.

    Bounding boxes are host-side NumPy values taken from detached numbers:
    the trace never reads them, so no gradient needs to flow through them.
    """

    prim_type: int  # set by subclasses

    def __init__(self, params, bounding_spans, material=None, *args, **kwargs):
        super().__init__(*args, **kwargs)
        params = plain(params)
        if is_traced(params):
            ref = first_tensor(params)
            params = as_tensor_like(params, ref).reshape(-1)
            pad = torch.zeros(
                prim.PARAM_WIDTH - params.shape[0], dtype=ref.dtype, device=ref.device
            )
            packed = torch.cat((params, pad))
        else:
            params = np.asarray(params, dtype=float).reshape(-1)
            packed = np.zeros(prim.PARAM_WIDTH)
            packed[: params.shape[0]] = params
        self._prim_params = packed
        self.material = material
        self._local_bounding_points = _corners_to_cube_points(bounding_spans)
        self._boundary_box_update_fn()
        self.var_watchlist.append(self._boundary_box_update_fn)

    def _boundary_box_update_fn(self):
        self._aobb_spans = bounding_box_spans(self.bounding_points)

    @property
    def bounding_points(self):
        return host(self._world_coordinate_transform) @ self._local_bounding_points

    @property
    def prim_params(self):
        return self._prim_params

    def intersect(self, rays):
        """Eager single-surface intersection of ``(2, 4, n)`` (or ``(2, 4)``)
        world rays; returns ``(hits (2, n), ids (2, n))``."""
        if rays.ndim == 2:
            rays = rays[..., None]
        obj_tx = torch.as_tensor(
            self._object_coordinate_transform, dtype=rays.dtype, device=rays.device
        )
        local_rays = torch.einsum("ij,rjn->rin", obj_tx, rays)
        params = torch.as_tensor(self._prim_params, dtype=rays.dtype, device=rays.device)
        hits = prim.leaf_intersect(self.prim_type, local_rays, params)
        hits = torch.stack((torch.minimum(hits[0], hits[1]), torch.maximum(hits[0], hits[1])))
        ids = torch.full(hits.shape, self.get_id(), dtype=torch.int64, device=rays.device)
        return hits, ids

    def shade(self, rays, distances, **kwargs):
        """Viewport RGBA (4, n) of camera rays ``(2, 4, n)`` (host arrays)
        hitting this surface at ``distances``: the material's shade at the
        hit points and their world normals (black without a material)."""
        from pyrayt_tpu_torch.render import gooch

        rays = np.asarray(rays, dtype=float)
        coordinates = rays[0] + np.asarray(distances, dtype=float) * rays[1]
        normals = host(self.get_world_normals(torch.as_tensor(coordinates, dtype=torch.float64)))
        material = self.material if self.material is not None else gooch.BLACK
        return material.shade(np.stack((coordinates, rays[1]), axis=0), normals, **kwargs)

    def get_world_normals(self, positions):
        """World-space unit normals at (assumed on-surface) ``(4, n)`` or
        ``(4,)`` positions: inverse-transpose transform, w zeroed,
        renormalized, scaled by the inversion flag."""
        single = positions.ndim == 1
        if single:
            positions = positions[:, None]
        obj_tx = torch.as_tensor(
            self._object_coordinate_transform, dtype=positions.dtype, device=positions.device
        )
        params = torch.as_tensor(
            self._prim_params, dtype=positions.dtype, device=positions.device
        )
        local_points = transform_rays(obj_tx, positions)
        local_normals = prim.leaf_normal(self.prim_type, local_points, params)
        world_normals = transform_rays(obj_tx.T, local_normals)
        world_normals = torch.cat((world_normals[:3], torch.zeros_like(world_normals[3:])))
        world_normals = world_normals / torch.linalg.norm(world_normals, dim=0)
        world_normals = world_normals * self._normal_scale
        return world_normals[:, 0] if single else world_normals

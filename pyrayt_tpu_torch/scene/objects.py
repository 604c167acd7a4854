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
from pyrayt_tpu_torch.scene._factors import (
    IDENTITY,
    Factor,
    compose,
    constant_factor,
    entries_factor,
    matrix_factor,
    rotation_factor,
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


def reserve_ids(count: int) -> int:
    """Draw ``count`` consecutive ids at once, as ``count`` new objects
    would; returns the first."""
    first = next(CountedObject._ids)
    if count > 1:
        next(itertools.islice(CountedObject._ids, count - 2, None))
    return first


def _copy(matrix):
    """A copy that keeps a tensor's graph (``copy.copy`` would cut it)."""
    return matrix.clone() if isinstance(matrix, torch.Tensor) else copy.copy(matrix)


_OBJ_ORIGIN = np.array([0.0, 0.0, 0.0, 1.0])
_OBJ_DIRECTION = np.array([0.0, 0.0, 1.0, 0.0])
_MOVE_ENTRIES = (3, 7, 11)  # flat positions of a move's x, y, z
_SCALE_ENTRIES = (0, 5, 10)
ROTATION_PLANES = {"x": (1, 2), "y": (2, 0), "z": (0, 1)}  # rotate_<axis>'s (i, j)


class WorldObject(CountedObject):
    """An object in 3D space with chainable move/scale/rotate operations
    (deg/rad units, negative scales prohibited).

    Any argument may be a tensor that requires grad; the world transform
    then becomes a tensor carrying that gradient (scene/_backend.py).  From
    the first such transform on, the object records each elementary factor
    (scene/_factors.py) instead of multiplying it in; the world matrix, its
    inverse, the origin, the direction and the bounding boxes are computed
    on first use and kept until the next transform.  ``compile_scene``
    composes the factors of every leaf in a few batched ops, so a rebuild
    computes only what the trace reads."""

    @staticmethod
    def _angle(angle, units="deg"):
        """``(angle, scale to radians)``; a plain angle as a float."""
        if units == "deg":
            scale = math.pi / 180.0
        elif units == "rad":
            scale = 1.0
        else:
            raise ValueError(f"{units} is not a valid option for angle units")
        angle = plain(angle)
        return (angle if is_traced(angle) else float(angle)), scale

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        # the product of the plain transforms, then the recorded factors
        # from the first traced transform on
        self._plain_tx = IDENTITY.copy()
        self._factors = ()
        self._cache = {}
        # callbacks fired whenever the world transform changes
        self.var_watchlist = [self._invalidate]

    # -- transform bookkeeping ------------------------------------------------

    def _append_world_transform(self, new_transform):
        """Apply ``new_transform``: a host (4, 4) matrix or a traced
        :class:`~pyrayt_tpu_torch.scene._factors.Factor`."""
        if isinstance(new_transform, Factor) or self._factors:
            if not isinstance(new_transform, Factor):
                new_transform = constant_factor(new_transform)
            self._factors = self._factors + (new_transform,)
        else:
            tx = new_transform @ self._plain_tx
            direction = tx[:, 2]  # tx @ (0, 0, 1, 0)
            if float(direction @ direction) < 1e-14:
                norm = np.linalg.norm(direction)
                raise ValueError(f"Measured Norm of World Vector below tolerance: {norm}")
            self._plain_tx = tx
        for fn in self.var_watchlist:
            fn()

    def _invalidate(self):
        self._cache.clear()

    def _world_chain(self):
        """``(m0, factors)``: the host product of the plain transforms and
        the factors recorded after them (empty for a plain object)."""
        return self._plain_tx, self._factors

    def _cached(self, name, fn):
        value = self._cache.get(name)
        if value is None:
            value = self._cache[name] = fn()
        return value

    @property
    def _world_coordinate_transform(self):
        if not self._factors:
            return self._plain_tx
        return self._cached("world", lambda: compose([self._world_chain()])[0][0])

    @property
    def _object_coordinate_transform(self):
        def inverse():
            tx = self._world_coordinate_transform
            return affine_inverse(tx) if isinstance(tx, torch.Tensor) else np.linalg.inv(tx)

        return self._cached("inverse", inverse)

    @property
    def _world_origin(self):
        def origin():
            tx = self._world_coordinate_transform
            if isinstance(tx, torch.Tensor):
                return tx @ as_tensor_like(_OBJ_ORIGIN, tx)
            return tx @ _OBJ_ORIGIN

        return self._cached("origin", origin)

    @property
    def _world_direction(self):
        def direction():
            tx = self._world_coordinate_transform
            if isinstance(tx, torch.Tensor):
                # the norm check needs a concrete value; traced values skip it
                world_dir = tx @ as_tensor_like(_OBJ_DIRECTION, tx)
                return world_dir / torch.linalg.norm(world_dir)
            world_dir = tx @ _OBJ_DIRECTION
            return world_dir / np.linalg.norm(world_dir)

        return self._cached("direction", direction)

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

    @staticmethod
    def _entries(flat, values):
        """The identity with ``values`` at the flat positions ``flat``: a
        host matrix, or a traced factor when any value is traced."""
        tx = IDENTITY.copy()
        traced_at, traced = [], []
        for position, value in zip(flat, values):
            if is_traced(value):
                traced_at.append(position)
                traced.append(value)
            else:
                tx.flat[position] = float(value)
        if traced:
            return entries_factor(tx, traced_at, traced)
        return tx

    def move(self, x=0, y=0, z=0):
        self._append_world_transform(self._entries(_MOVE_ENTRIES, plain((x, y, z))))
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
        self._append_world_transform(self._entries(_SCALE_ENTRIES, (x, y, z)))
        return self

    def scale_x(self, scale_val):
        return self.scale(x=scale_val)

    def scale_y(self, scale_val):
        return self.scale(y=scale_val)

    def scale_z(self, scale_val):
        return self.scale(z=scale_val)

    def scale_all(self, scale_val):
        return self.scale(scale_val, scale_val, scale_val)

    @classmethod
    def _rotation(cls, axes, angle, units):
        """The rotation in the ``axes`` plane: a host matrix, or a traced
        factor when the angle is traced."""
        angle, scale = cls._angle(angle, units)
        if is_traced(angle):
            return rotation_factor(axes, angle, scale)
        sin_a, cos_a = math.sin(angle * scale), math.cos(angle * scale)
        (i, j) = axes
        tx = IDENTITY.copy()
        tx[i, i] = cos_a
        tx[j, j] = cos_a
        tx[i, j] = -sin_a
        tx[j, i] = sin_a
        return tx

    def _rotate(self, axes, angle, units):
        self._append_world_transform(self._rotation(axes, angle, units))
        return self

    def rotate_x(self, angle, units="deg"):
        return self._rotate(ROTATION_PLANES["x"], angle, units)

    def rotate_y(self, angle, units="deg"):
        return self._rotate(ROTATION_PLANES["y"], angle, units)

    def rotate_z(self, angle, units="deg"):
        return self._rotate(ROTATION_PLANES["z"], angle, units)

    def transform(self, transform_matrix):
        if isinstance(transform_matrix, np.ndarray) and transform_matrix.dtype == np.float64:
            self._append_world_transform(transform_matrix)
            return self
        transform_matrix = plain(transform_matrix)
        if isinstance(transform_matrix, Factor):
            self._append_world_transform(transform_matrix)
        elif is_traced(transform_matrix):
            ref = first_tensor(transform_matrix)
            self._append_world_transform(matrix_factor(as_tensor_like(transform_matrix, ref)))
        else:
            self._append_world_transform(np.asarray(transform_matrix, dtype=float))
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

    ``params`` are plain numbers, or entries some of which are traced (or a
    traced vector); the packed row is made on first use and
    ``compile_scene`` packs every leaf's traced entries at once.
    ``bounding_spans`` is a (3, 2) array or a function of the host packed
    row that returns one.  Bounding boxes are host-side NumPy values taken
    from detached numbers, made on first use: the trace never reads them,
    so no gradient needs to flow through them.
    """

    prim_type: int  # set by subclasses

    def __init__(self, params, bounding_spans, material=None, *args, **kwargs):
        super().__init__(*args, **kwargs)
        params = plain(params)
        if is_traced(params):
            self._prim_source = params if isinstance(params, torch.Tensor) else tuple(params)
            self._packed = None
        else:
            params = np.asarray(params, dtype=float).reshape(-1)
            packed = np.zeros(prim.PARAM_WIDTH)
            packed[: params.shape[0]] = params
            self._prim_source = None
            self._packed = packed
        self.material = material
        self._local_spans = bounding_spans
        self._local_points = None

    def _prim_entries(self):
        """``(row, entries)``: the host packed row (zero where traced) and
        the traced ``(column, 0-d tensor)`` entries."""
        if self._prim_source is None:
            return self._packed, ()
        row = np.zeros(prim.PARAM_WIDTH)
        source = self._prim_source
        if isinstance(source, torch.Tensor):
            source = source.reshape(-1)
            return row, tuple((col, source[col]) for col in range(source.shape[0]))
        entries = []
        for col, value in enumerate(source):
            if is_traced(value):
                entries.append((col, value))
            else:
                row[col] = float(value)
        return row, tuple(entries)

    def _host_row(self):
        if self._prim_source is None:
            return self._packed
        row, entries = self._prim_entries()
        row = row.copy()
        for col, value in entries:
            row[col] = float(host(value))
        return row

    @property
    def _local_bounding_points(self):
        if self._local_points is None:
            spans = self._local_spans
            if callable(spans):
                spans = spans(self._host_row())
            self._local_points = _corners_to_cube_points(spans)
        return self._local_points

    @property
    def _aobb_spans(self):
        return self._cached("aobb", lambda: bounding_box_spans(self.bounding_points))

    @property
    def bounding_points(self):
        return host(self._world_coordinate_transform) @ self._local_bounding_points

    @property
    def prim_params(self):
        if self._packed is None:
            ref = first_tensor(self._prim_source)
            params = as_tensor_like(self._prim_source, ref).reshape(-1)
            pad = torch.zeros(
                prim.PARAM_WIDTH - params.shape[0], dtype=ref.dtype, device=ref.device
            )
            self._packed = torch.cat((params, pad))
        return self._packed

    @property
    def _prim_params(self):
        return self.prim_params

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

"""Host-side homogeneous-coordinate helper types (counterpart of
``pyrayt_tpu.core.homogeneous``).

``Point``/``Vector``/``Ray``/``bundle_of_rays`` are small NumPy
conveniences for building and inspecting rays by hand, as in the reference
PyRayT's L1 API; the trace works on :class:`~pyrayt_tpu_torch.RaySet`
tensors and never touches them.  ``interop.rays_from_numpy`` turns a
``(2, 4, n)`` bundle's rows into a RaySet.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "HomogeneousCoordinate",
    "Point",
    "Vector",
    "Ray",
    "bundle_of_rays",
    "bundle_rays",
]


def _component(index: int, doc: str):
    def get(self):
        return self[index]

    def put(self, value):
        self[index] = value

    return property(get, put, doc=doc)


class HomogeneousCoordinate(np.ndarray):
    """A length-4 float array with named x/y/z/w access."""

    def __new__(cls, x=0.0, y=0.0, z=0.0, w=0.0):
        return np.array([x, y, z, w], dtype=float).view(cls)

    # numpy subclass protocol: views created by slicing skip __new__
    def __array_finalize__(self, obj):
        pass

    x = _component(0, "spatial x component")
    y = _component(1, "spatial y component")
    z = _component(2, "spatial z component")
    w = _component(3, "homogeneous coordinate (1 point, 0 vector)")

    def normalize(self) -> "HomogeneousCoordinate":
        """Scale the spatial part to unit length in place; returns self."""
        self[:3] = self[:3] / np.linalg.norm(self[:3])
        return self


class Point(HomogeneousCoordinate):
    """A position: w = 1."""

    def __new__(cls, x=0.0, y=0.0, z=0.0, *args, **kwargs):
        return np.array([x, y, z, 1.0], dtype=float).view(cls)


class Vector(HomogeneousCoordinate):
    """A direction: w = 0."""

    def __new__(cls, x=0.0, y=0.0, z=0.0, *args, **kwargs):
        return np.array([x, y, z, 0.0], dtype=float).view(cls)


class Ray(np.ndarray):
    """A (2, 4) origin + direction pair."""

    def __new__(cls, origin=None, direction=None):
        arr = np.zeros((2, 4), dtype=float).view(cls)
        arr[0] = Point() if origin is None else np.asarray(origin, dtype=float)
        arr[1] = (
            Vector(1.0, 0.0, 0.0)
            if direction is None
            else np.asarray(direction, dtype=float)
        )
        return arr

    def __array_finalize__(self, obj):
        pass

    @property
    def origin(self) -> HomogeneousCoordinate:
        return self[0].view(HomogeneousCoordinate)

    @origin.setter
    def origin(self, value):
        self[0] = value

    @property
    def direction(self) -> HomogeneousCoordinate:
        return self[1].view(HomogeneousCoordinate)

    @direction.setter
    def direction(self, value):
        self[1] = value


def bundle_of_rays(n_rays: int) -> np.ndarray:
    """A zeroed ``(2, 4, n)`` ray bundle whose positions have w = 1."""
    rays = np.zeros((2, 4, n_rays))
    rays[0, 3] = 1.0
    return rays


def bundle_rays(rays) -> np.ndarray:
    """Stack individual ``(2, 4)`` rays into a ``(2, 4, n)`` bundle."""
    return np.stack(list(rays), axis=2)

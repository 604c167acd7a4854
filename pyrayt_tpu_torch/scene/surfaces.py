"""Concrete traceable surfaces (counterpart of ``pyrayt_tpu.scene.surfaces``)."""

from __future__ import annotations

import numpy as np

from pyrayt_tpu_torch.core import primitives as prim
from pyrayt_tpu_torch.scene.objects import TracerSurface, _plain

__all__ = ["Sphere", "Paraboloid", "XYPlane", "Cuboid", "Cylinder"]


class Sphere(TracerSurface):
    prim_type = prim.SPHERE

    def __init__(self, radius=1, material=None, *args, **kwargs):
        (r,) = _plain(radius)
        spans = np.stack((np.array((-r, -r, -r)), np.array((r, r, r))), axis=1)
        super().__init__(
            params=(r,), bounding_spans=spans, material=material, *args, **kwargs
        )

    def get_radius(self):
        return self._prim_params[0]


class Paraboloid(TracerSurface):
    prim_type = prim.PARABOLOID

    def __init__(self, focus=1, height=1, material=None, *args, **kwargs):
        f, h = _plain(focus, height)
        if f <= 0 or h <= 0:
            raise ValueError("Focus and height must be positive numbers")
        radius_at_max = np.sqrt(4.0 * f * h)
        spans = np.stack(
            (
                np.array((-radius_at_max, -radius_at_max, 0.0)),
                np.array((radius_at_max, radius_at_max, h)),
            ),
            axis=1,
        )
        super().__init__(
            params=(f, h), bounding_spans=spans, material=material, *args, **kwargs
        )

    def get_focus(self):
        return self._prim_params[0]


class XYPlane(TracerSurface):
    prim_type = prim.PLANE

    def __init__(self, width=2, length=2, material=None, *args, **kwargs):
        w, l = _plain(width, length)
        spans = np.stack(
            (np.array((-w / 2, -l / 2, -0.01)), np.array((w / 2, l / 2, 0.01))), axis=1
        )
        super().__init__(
            params=(w, l), bounding_spans=spans, material=material, *args, **kwargs
        )


class Cuboid(TracerSurface):
    prim_type = prim.CUBE

    def __init__(
        self, l_corner=(-1, -1, -1), r_corner=(1, 1, 1), material=None, *args, **kwargs
    ):
        lo = np.asarray(_plain(*l_corner), dtype=float)[:3]
        hi = np.asarray(_plain(*r_corner), dtype=float)[:3]
        spans = np.sort(np.stack((lo, hi), axis=1), axis=1)  # (3, 2)
        super().__init__(
            params=spans.reshape(-1),
            bounding_spans=spans,
            material=material,
            *args,
            **kwargs,
        )

    @classmethod
    def from_sides(cls, x=1, y=1, z=1, **kwargs):
        dims = np.asarray(_plain(x, y, z))
        return cls(-0.5 * dims, 0.5 * dims, **kwargs)

    @classmethod
    def from_length(cls, length, **kwargs):
        (length,) = _plain(length)
        half = 0.5 * length
        corner = np.array((half, half, half))
        return cls(-corner, corner, **kwargs)

    @property
    def axis_spans(self):
        return self._prim_params[:6].reshape(3, 2)


class Cylinder(TracerSurface):
    prim_type = prim.CYLINDER

    def __init__(
        self,
        radius=1,
        min_height=-1,
        max_height=1,
        capped=True,
        material=None,
        *args,
        **kwargs,
    ):
        r, h_min, h_max = _plain(radius, min_height, max_height)
        spans = np.stack((np.array((-r, -r, h_min)), np.array((r, r, h_max))), axis=1)
        super().__init__(
            params=(r, h_min, h_max, 1.0 if capped else 0.0),
            bounding_spans=spans,
            material=material,
            *args,
            **kwargs,
        )

    def get_radius(self):
        return self._prim_params[0]

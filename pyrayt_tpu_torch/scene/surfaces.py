"""Concrete traceable surfaces (counterpart of ``pyrayt_tpu.scene.surfaces``).

Parameters are packed on NumPy for plain numbers; when any parameter is a
tensor that requires grad (scene/_backend.py) the surface keeps the entries
and packs them on first use.  The bounding spans are host values either
way, made from the host parameters on first use.
"""

from __future__ import annotations

import numpy as np
import torch

from pyrayt_tpu_torch.core import primitives as prim
from pyrayt_tpu_torch.scene._backend import as_tensor_like, first_tensor, is_traced, plain
from pyrayt_tpu_torch.scene.objects import TracerSurface

__all__ = ["Sphere", "Paraboloid", "XYPlane", "Cuboid", "Cylinder"]


def _params(*values):
    """Parameter values: the entries when any is traced, else floats."""
    values = plain(values)
    if is_traced(values):
        return values
    return np.asarray(values, dtype=float)


def _sphere_spans(p):
    r = float(p[0])
    return np.stack((np.array((-r, -r, -r)), np.array((r, r, r))), axis=1)


def _paraboloid_spans(p):
    f, h = p[0], p[1]
    radius_at_max = np.sqrt(max(4.0 * f * h, 0.0))
    return np.stack(
        (
            np.array((-radius_at_max, -radius_at_max, 0.0)),
            np.array((radius_at_max, radius_at_max, h)),
        ),
        axis=1,
    )


def _plane_spans(p):
    w, l = p[0], p[1]
    return np.stack((np.array((-w / 2, -l / 2, -0.01)), np.array((w / 2, l / 2, 0.01))), axis=1)


def _cube_spans(p):
    return p[:6].reshape(3, 2)


def _cylinder_spans(p):
    r, h_min, h_max = p[0], p[1], p[2]
    return np.stack((np.array((-r, -r, h_min)), np.array((r, r, h_max))), axis=1)


class Sphere(TracerSurface):
    prim_type = prim.SPHERE

    def __init__(self, radius=1, material=None, *args, **kwargs):
        super().__init__(
            params=_params(radius), bounding_spans=_sphere_spans, material=material, *args,
            **kwargs
        )

    def get_radius(self):
        return self._prim_params[0]


class Paraboloid(TracerSurface):
    prim_type = prim.PARABOLOID

    def __init__(self, focus=1, height=1, material=None, *args, **kwargs):
        focus, height = plain((focus, height))
        for value in (focus, height):
            if not is_traced(value) and float(value) <= 0:
                raise ValueError("Focus and height must be positive numbers")
        super().__init__(
            params=_params(focus, height), bounding_spans=_paraboloid_spans, material=material,
            *args, **kwargs
        )

    def get_focus(self):
        return self._prim_params[0]


class XYPlane(TracerSurface):
    prim_type = prim.PLANE

    def __init__(self, width=2, length=2, material=None, *args, **kwargs):
        super().__init__(
            params=_params(width, length), bounding_spans=_plane_spans, material=material, *args,
            **kwargs
        )


class Cuboid(TracerSurface):
    prim_type = prim.CUBE

    def __init__(
        self, l_corner=(-1, -1, -1), r_corner=(1, 1, 1), material=None, *args, **kwargs
    ):
        l_corner, r_corner = plain(tuple(l_corner)), plain(tuple(r_corner))
        if is_traced(l_corner, r_corner):
            ref = first_tensor(l_corner, r_corner)
            lo = as_tensor_like(tuple(l_corner)[:3], ref)
            hi = as_tensor_like(tuple(r_corner)[:3], ref)
            spans = torch.sort(torch.stack((lo, hi), dim=1), dim=1).values  # (3, 2)
        else:
            lo = np.asarray(l_corner, dtype=float)[:3]
            hi = np.asarray(r_corner, dtype=float)[:3]
            spans = np.sort(np.stack((lo, hi), axis=1), axis=1)  # (3, 2)
        super().__init__(
            params=spans.reshape(-1),
            bounding_spans=_cube_spans,
            material=material,
            *args,
            **kwargs,
        )

    @classmethod
    def from_sides(cls, x=1, y=1, z=1, **kwargs):
        dims = plain((x, y, z))
        if is_traced(dims):
            dims = as_tensor_like(dims, first_tensor(dims))
        else:
            dims = np.asarray(dims, dtype=float)
        return cls(tuple(-0.5 * dims), tuple(0.5 * dims), **kwargs)

    @classmethod
    def from_length(cls, length, **kwargs):
        half = 0.5 * _params(length)[0]
        return cls((-half, -half, -half), (half, half, half), **kwargs)

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
        super().__init__(
            params=_params(radius, min_height, max_height, 1.0 if capped else 0.0),
            bounding_spans=_cylinder_spans,
            material=material,
            *args,
            **kwargs,
        )

    def get_radius(self):
        return self._prim_params[0]

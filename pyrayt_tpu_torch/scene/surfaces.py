"""Concrete traceable surfaces (counterpart of ``pyrayt_tpu.scene.surfaces``).

Parameters are packed on NumPy for plain numbers and as torch tensors when
any parameter is a tensor that requires grad (scene/_backend.py); the
bounding spans are host values either way.
"""

from __future__ import annotations

import numpy as np
import torch

from pyrayt_tpu_torch.core import primitives as prim
from pyrayt_tpu_torch.scene._backend import as_tensor_like, first_tensor, host, is_traced, plain
from pyrayt_tpu_torch.scene.objects import TracerSurface

__all__ = ["Sphere", "Paraboloid", "XYPlane", "Cuboid", "Cylinder"]


def _params(*values):
    """Packed parameter values: a tensor when any is traced, else floats."""
    values = plain(values)
    if is_traced(values):
        return as_tensor_like(values, first_tensor(values))
    return np.asarray(values, dtype=float)


class Sphere(TracerSurface):
    prim_type = prim.SPHERE

    def __init__(self, radius=1, material=None, *args, **kwargs):
        params = _params(radius)
        r = float(host(params)[0])
        spans = np.stack((np.array((-r, -r, -r)), np.array((r, r, r))), axis=1)
        super().__init__(params=params, bounding_spans=spans, material=material, *args, **kwargs)

    def get_radius(self):
        return self._prim_params[0]


class Paraboloid(TracerSurface):
    prim_type = prim.PARABOLOID

    def __init__(self, focus=1, height=1, material=None, *args, **kwargs):
        params = _params(focus, height)
        f, h = host(params)
        if (not is_traced(plain(focus)) and f <= 0) or (not is_traced(plain(height)) and h <= 0):
            raise ValueError("Focus and height must be positive numbers")
        radius_at_max = np.sqrt(max(4.0 * f * h, 0.0))
        spans = np.stack(
            (
                np.array((-radius_at_max, -radius_at_max, 0.0)),
                np.array((radius_at_max, radius_at_max, h)),
            ),
            axis=1,
        )
        super().__init__(params=params, bounding_spans=spans, material=material, *args, **kwargs)

    def get_focus(self):
        return self._prim_params[0]


class XYPlane(TracerSurface):
    prim_type = prim.PLANE

    def __init__(self, width=2, length=2, material=None, *args, **kwargs):
        params = _params(width, length)
        w, l = host(params)
        spans = np.stack(
            (np.array((-w / 2, -l / 2, -0.01)), np.array((w / 2, l / 2, 0.01))), axis=1
        )
        super().__init__(params=params, bounding_spans=spans, material=material, *args, **kwargs)


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
            bounding_spans=host(spans),
            material=material,
            *args,
            **kwargs,
        )

    @classmethod
    def from_sides(cls, x=1, y=1, z=1, **kwargs):
        dims = _params(x, y, z)
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
        params = _params(radius, min_height, max_height, 1.0 if capped else 0.0)
        r, h_min, h_max, _ = host(params)
        spans = np.stack((np.array((-r, -r, h_min)), np.array((r, r, h_max))), axis=1)
        super().__init__(params=params, bounding_spans=spans, material=material, *args, **kwargs)

    def get_radius(self):
        return self._prim_params[0]

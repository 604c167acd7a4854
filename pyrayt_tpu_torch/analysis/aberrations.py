"""Host-side aberration analysis (counterpart of
``pyrayt_tpu.analysis.aberrations``).

Spherical and chromatic aberration curves and a coma metric, as in the
reference's lens-design notebook: each traces a small fan of rays through
the system with :class:`~pyrayt_tpu_torch.RayTracer` and analyzes the
results frame with pandas.  The trace runs on the CUDA card unless the
caller passes ``device="cpu"``.  For gradient-based design use the
differentiable metrics of :mod:`pyrayt_tpu_torch.analysis.metrics`.
"""

from __future__ import annotations

import numpy as np
import pandas as pd
import torch

__all__ = ["spherical_aberration", "chromatic_aberration", "coma"]


def _imager_rays(results: pd.DataFrame) -> pd.DataFrame:
    """Each ray's final recorded segment, restricted to the most common
    final surface (the imager): robust to a ray that takes one bounce more
    than the others, where a filter on the largest generation would keep
    only that ray."""
    idx = results.groupby("id")["generation"].idxmax()
    final = results.loc[idx]
    imager_surface = final["surface"].mode().iloc[0]
    return final.loc[final["surface"] == imager_surface]


def _axis_intercept(rays: pd.DataFrame) -> np.ndarray:
    return np.asarray(-rays["x_tilt"] * rays["y0"] / rays["y_tilt"] + rays["x0"])


def _trace(sources, system, rays_per_source, device, dtype) -> pd.DataFrame:
    import pyrayt_tpu_torch as prt

    return prt.RayTracer(sources, system, rays_per_source=rays_per_source, device=device,
                         dtype=dtype).trace()


def spherical_aberration(system, ray_origin: float, max_radius: float, sample_points: int = 11,
                         device=None, dtype: torch.dtype = torch.float32) -> pd.DataFrame:
    """Focal length vs beam radius: a line of rays offset to +y through
    ``system``, each ray's x-axis intercept.  Returns columns ``radius``,
    ``focus``."""
    from pyrayt_tpu_torch import components

    source = components.LineOfRays(0.9 * max_radius).move_x(ray_origin).move_y(max_radius / 2)
    results = _trace(source, system, sample_points, device, dtype)
    imager_rays = _imager_rays(results)
    intercept = _axis_intercept(imager_rays)
    radii = results.loc[np.logical_and(results["generation"] == 0,
                                       results["id"].isin(imager_rays["id"]))]["y0"]
    return pd.DataFrame({"radius": np.asarray(radii), "focus": intercept})


def chromatic_aberration(system, ray_origin: float, test_radius: float, wavelengths,
                         device=None, dtype: torch.dtype = torch.float32) -> pd.DataFrame:
    """Focal length vs wavelength: one ray per wavelength at height
    ``test_radius``.  Returns columns ``wavelength``, ``focus``."""
    from pyrayt_tpu_torch import components

    sources = [components.LineOfRays(0, wavelength=wave).move_y(test_radius).move_x(ray_origin)
               for wave in np.asarray(wavelengths)]
    imager_rays = _imager_rays(_trace(sources, system, 1, device, dtype))
    return pd.DataFrame({"wavelength": np.asarray(imager_rays["wavelength"]),
                         "focus": _axis_intercept(imager_rays)})


def coma(system, ray_origin: float, max_radius: float, angle: float, device=None,
         dtype: torch.dtype = torch.float32) -> float:
    """Mean squared deviation of the sine of the final y tilt from the
    sine of the field angle, over an off-axis fan of 11 rays."""
    from pyrayt_tpu_torch import components

    source = (components.LineOfRays(2 * max_radius).rotate_x(90).move_x(ray_origin)
              .rotate_z(angle))
    ray_set = _imager_rays(_trace(source, system, 11, device, dtype))
    return float(np.mean(np.square(np.sin(ray_set["y_tilt"]) - np.sin(angle * np.pi / 180))))

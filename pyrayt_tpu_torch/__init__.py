"""pyrayt_tpu_torch — the PyTorch and CUDA port of pyrayt_tpu.

The same builder API (components, materials, sources, CSG) and the same
15-column results frame; the trace runs on PyTorch tensors, on an NVIDIA
GPU through a hand-written CUDA kernel (ops/fused_trace.py).  It imports
neither ``jax`` nor ``pyrayt_tpu``.

    import torch
    import pyrayt_tpu_torch as pyrayt
    from pyrayt_tpu_torch import components
    tracer = pyrayt.RayTracer(sources, components_, rays_per_source=100,
                              device="cuda", dtype=torch.float32)
    frame = tracer.trace()
"""

from pyrayt_tpu_torch.config import TraceConfig
from pyrayt_tpu_torch.core.homogeneous import (
    HomogeneousCoordinate,
    Point,
    Ray,
    Vector,
    bundle_of_rays,
    bundle_rays,
)
from pyrayt_tpu_torch.tracer.rayset import RaySet
from pyrayt_tpu_torch.tracer.tracer import RayTracer, pin
from pyrayt_tpu_torch import components, materials, utils
from pyrayt_tpu_torch.utils import lensmakers_equation, wavelength_to_rgb

__version__ = "0.1.0"

__all__ = [
    "RayTracer",
    "RaySet",
    "pin",
    "TraceConfig",
    "HomogeneousCoordinate",
    "Point",
    "Vector",
    "Ray",
    "bundle_of_rays",
    "bundle_rays",
    "components",
    "materials",
    "utils",
    "lensmakers_equation",
    "wavelength_to_rgb",
]

"""The ``doublet`` configuration built with ``pyrayt_tpu_torch``.

The program's side of the cell: the lens-design example's builders,
sources and loss (``examples_torch/lens_design.py``), from the numbers of
``doublet.json``.  ``theta["log_r"]`` is a tensor of log-magnitudes (the
optimised parameters, radii ``sign * exp``) or a NumPy array (a plain
build).
"""

from __future__ import annotations

import numpy as np
import torch

import pyrayt_tpu_torch.materials as matl
from pyrayt_tpu_torch import components as comp
from pyrayt_tpu_torch.analysis import SoftFocusError
from pyrayt_tpu_torch.tracer.rayset import concatenate


def components(cfg, theta):
    log_r = theta["log_r"]
    if isinstance(log_r, torch.Tensor):
        radii = torch.as_tensor(cfg["radius_signs"]).to(log_r) * torch.exp(log_r)
    else:
        radii = np.asarray(cfg["radius_signs"], dtype=float) * np.exp(log_r)
    d, t1, t2 = cfg["lens_diameter"], cfg["l1_thickness"], cfg["l2_thickness"]
    s = cfg["radius_signs"]
    l1 = comp.thick_lens(radii[0], radii[1], t1, aperture=d, material=matl.glass[cfg["crown"]],
                         r1_sign=s[0], r2_sign=s[1])
    l2 = comp.thick_lens(radii[2], radii[3], t2, aperture=d, material=matl.glass[cfg["flint"]],
                         r1_sign=s[2], r2_sign=s[3]).move_x(cfg["l2_gap_factor"] * (t1 + t2) / 2)
    imager = comp.baffle((d, d)).move_x(cfg["system_focus"])
    return [l1, l2, imager]


def sources(cfg):
    d = cfg["lens_diameter"]
    return [comp.LineOfRays(cfg["line_width_factor"] * d / 2, wavelength=wl)
            .move_x(cfg["source_x"]).move_y(cfg["line_offset_factor"] * d)
            for wl in cfg["source_wavelengths_um"]]


def rays(cfg, n_per_source, device, dtype):
    """The example's design rays: every source's line, ids in order."""
    sets = [src.generate_rays(n_per_source, device=device, dtype=dtype) for src in sources(cfg)]
    r = concatenate(sets)
    return r.replace(id=torch.arange(r.n_rays, dtype=r.dtype, device=r.device))


def loss(cfg, surface_id):
    d = cfg["lens_diameter"]
    return SoftFocusError(cfg["system_focus"], float(surface_id), half_widths=(d / 2, d / 2),
                          ramp=cfg["ramp_factor"] * d, tilt_ramp=tuple(cfg["tilt_ramp"]))

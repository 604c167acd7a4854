"""The ``mla16`` configuration built with ``pyrayt_tpu_torch``.

The program's side of the cell: the microlens example's per-lenslet
builders, grid source and lenslet blur
(``examples_torch/microlens_array.py:main_per_lenslet``), from the
numbers of ``mla16.json``.  ``theta`` holds ``radii`` (n^2) and ``det_x``,
tensors (the optimised parameters) or NumPy values (a plain build).
"""

from __future__ import annotations

import torch

from pyrayt_tpu_torch import components as comp
from pyrayt_tpu_torch.analysis.metrics import COL, masked_mean, surface_mask


def components(cfg, theta):
    n, pitch = cfg["n"], cfg["pitch"]
    lenslets = comp.microlens_array(theta["radii"], cfg["thickness"], n, n, pitch)
    size = cfg["detector_size_factor"] * n * pitch
    return lenslets + [comp.baffle((size, size)).move_x(theta["det_x"])]


def sources(cfg):
    span = cfg["n"] * cfg["pitch"] * cfg["span_factor"]
    return [comp.GridOfRays(span, span, wavelength=cfg["wavelength_um"]).move_x(cfg["source_x"])]


def rays(cfg, n_rays, device, dtype):
    r = sources(cfg)[0].generate_rays(n_rays, device=device, dtype=dtype)
    return r.replace(id=torch.arange(n_rays, dtype=r.dtype, device=r.device))


def loss(cfg, surface_id):
    pitch = cfg["pitch"]
    off = 0.0 if cfg["n"] % 2 else pitch / 2.0

    def lenslet_blur(res):
        m = surface_mask(res, surface_id)
        y = res.records[:, COL["y1"], :]
        z = res.records[:, COL["z1"], :]
        dy = y - (pitch * torch.round((y - off) / pitch) + off)
        dz = z - (pitch * torch.round((z - off) / pitch) + off)
        return masked_mean(dy**2 + dz**2, m)

    return lenslet_blur

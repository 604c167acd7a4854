"""Plain reference of the ``mla16`` configuration (``mla16.json``).

A 16 x 16 array of plano-convex lenslets in the YZ plane, optical axes +X,
a square detector behind it and a grid of rays over 0.95 of the array,
from the configuration's numbers alone.  Imports nothing of the program.

Lenslet recipe (the documented plano-convex construction): a sphere of the
lenslet's radius centred ``-(r - t/2)`` along the lenslet's axis,
intersected with a capped cylinder of radius pitch/2 and length t; the
array is row-major, lenslet (iy, iz) at ``((iy - (n-1)/2) p, (iz - (n-1)/2) p)``.
Public ids follow the documented counter: each lenslet builds its cylinder,
its sphere and a CSG node, then comes the detector.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.reference.engine import (
    CYLINDER, PLANE, SPHERE, Group, Leaves, Rays, make_rays, rotation)


def focus(cfg):
    """The lensmaker's focal length of a plano-convex lenslet."""
    return cfg["radius"] / (cfg["glass_index"] - 1)


def theta(cfg, traffic, rng):
    """Every lenslet's radius detuned by the traffic's normal draw, and the
    detector at the traffic's multiple of the nominal focus."""
    n = cfg["n"]
    radii = cfg["radius"] * (1.0 + traffic["detune"] * rng.standard_normal(n * n))
    return {"radii": radii, "det_x": np.float64(focus(cfg) * traffic["det_x_factor"])}


def surface_id(cfg) -> int:
    return 3 * cfg["n"] ** 2


def _centres(cfg):
    n, pitch = cfg["n"], cfg["pitch"]
    i = np.arange(n * n)
    return (i // n - (n - 1) / 2.0) * pitch, (i % n - (n - 1) / 2.0) * pitch


def groups(cfg, th, dtype, device):
    """The array (one group of n^2 trees) and the detector, from
    ``th["radii"]`` and ``th["det_x"]`` (tensors, which may require grad)."""
    n, t, pitch = cfg["n"], cfg["thickness"], cfg["pitch"]
    radii = torch.as_tensor(th["radii"], device=device).to(dtype)
    det_x = torch.as_tensor(th["det_x"], device=device).to(dtype)
    count = n * n
    axis = rotation("x", 90, dtype, device) @ rotation("y", 90, dtype, device)
    y, z = _centres(cfg)
    base = axis.expand(count, 4, 4).clone()
    base[:, 1, 3] = torch.as_tensor(y, dtype=dtype, device=device)
    base[:, 2, 3] = torch.as_tensor(z, dtype=dtype, device=device)
    # the sphere's own move along its axis, carried into world by ``axis``
    offset = -(radii - t / 2)
    sphere_world = base + torch.zeros_like(base).index_put(
        (torch.arange(count, device=device).repeat_interleave(3),
         torch.arange(3, device=device).repeat(count),
         torch.full((3 * count,), 3, device=device)),
        (axis[:3, 2][None, :] * offset[:, None]).reshape(-1))
    zeros = torch.zeros_like(radii)
    sphere = Leaves(SPHERE, sphere_world, torch.stack([radii, zeros, zeros], dim=1),
                    None, [3 * i + 1 for i in range(count)])
    cyl_params = torch.tensor([[pitch / 2, -t / 2, t / 2]], dtype=dtype,
                              device=device).expand(count, 3)
    cyl = Leaves(CYLINDER, base, cyl_params, None, [3 * i for i in range(count)])
    glass = torch.tensor([cfg["glass_index"] ** 2] + [0.0] * 6, dtype=torch.float64,
                         device=device)
    sphere.glass, cyl.glass = glass, glass
    size = cfg["detector_size_factor"] * n * pitch
    det_world = rotation("y", 90, dtype, device).clone()
    det_world = det_world + torch.zeros_like(det_world).index_put(
        (torch.tensor([0], device=device), torch.tensor([3], device=device)), det_x.reshape(1))
    det = Leaves(PLANE, det_world[None], torch.tensor([[size, size, 0.0]], dtype=dtype,
                                                      device=device), None, [surface_id(cfg)])
    return [Group(("intersect", ("leaf", 0), ("leaf", 1)), [sphere, cyl]),
            Group(("leaf", 0), [det])]


def rays(cfg, n_rays, dtype, device) -> Rays:
    """A near-square grid of +X rays, row-major, over the span."""
    span = cfg["n"] * cfg["pitch"] * cfg["span_factor"]
    k = int(math.ceil(math.sqrt(n_rays)))
    rows = int(math.ceil(n_rays / k))
    i = torch.arange(n_rays, device=device)
    p = torch.zeros((3, n_rays), dtype=torch.float64, device=device)
    p[0] = cfg["source_x"]
    p[1] = ((i // k).to(torch.float64) / max(rows - 1, 1) - 0.5) * span
    p[2] = ((i % k).to(torch.float64) / max(k - 1, 1) - 0.5) * span
    direction = torch.zeros_like(p)
    direction[0] = 1.0
    wl = torch.full((n_rays,), cfg["wavelength_um"], dtype=torch.float64, device=device)
    return make_rays(p, direction, wl, i.to(torch.float64), dtype)


def loss_parts(cfg, records, masks):
    """(numerator, denominator) of the lenslet blur: the mean squared
    distance of detector hits to their own cell's centre."""
    pitch = cfg["pitch"]
    off = 0.0 if cfg["n"] % 2 else pitch / 2.0
    hit = masks & (records[:, 5] == surface_id(cfg))
    y, z = records[:, 10], records[:, 11]
    dy = y - (pitch * torch.round((y - off) / pitch) + off)
    dz = z - (pitch * torch.round((z - off) / pitch) + off)
    w = hit.to(records.dtype)
    return ((dy * dy + dz * dz) * w).sum(), w.sum()


def loss_value(a, b):
    return a / torch.clamp(b, min=1.0)


def scene_counts(cfg):
    """(leaves, glass rows, leaf kinds a ray tests) for the roofline: the
    detector and, at the least a cull leaves, one lenslet."""
    return 2 * cfg["n"] ** 2 + 1, 2, ["sphere", "cylinder", "plane"]

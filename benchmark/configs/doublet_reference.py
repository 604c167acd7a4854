"""Plain reference of the ``doublet`` configuration (``doublet.json``).

The 50 mm f/2.4 BK7/SF2 achromatic doublet of PyRayT's lens-design
notebook: its design radii, the scene as reference groups, the six lines
of rays and the soft focus loss, from the configuration's numbers alone.
Imports nothing of the program.

Scene recipe (the documented thick-lens construction, optical axis +X):
a capped cylinder of the aperture's radius, as long as the centre
thickness plus the sag of a concave front or convex back surface, and two
spheres of the signed radii, centred ``r1 - t/2`` and ``r2 + t/2`` along the
lens axis; a front sphere of negative radius is subtracted (its normals
flip), every other surface intersected.  Public ids follow the documented
counter: under a fresh count each object built takes the next id (per lens
the cylinder, the front sphere, a CSG node, the back sphere, a CSG node),
then the imager.
"""

from __future__ import annotations


import numpy as np
import torch

from benchmark.reference.engine import (
    CYLINDER, PLANE, SPHERE, Group, Leaves, Rays, make_rays, rotation, translation)

IDS_PER_LENS = 5


def index(coeffs, wavelength):
    wl2 = np.asarray(wavelength, dtype=float) ** 2
    b, c = coeffs[:3], coeffs[3:]
    return np.sqrt(1 + sum(b[i] * wl2 / (wl2 - c[i]) for i in range(3)))


def design_radii(cfg):
    """Radii split by Abbe number for first-order achromatism."""
    crown, flint = cfg["sellmeier"][cfg["crown"]], cfg["sellmeier"][cfg["flint"]]
    f_line, d_line, c_line = cfg["abbe_lines_um"]

    def abbe(coeffs):
        return (index(coeffs, d_line) - 1) / (index(coeffs, f_line) - index(coeffs, c_line))

    power = 1 / cfg["system_focus"]
    v1, v2 = abbe(crown), abbe(flint)
    p1, p2 = power * v1 / (v1 - v2), power * v2 / (v2 - v1)
    n1 = index(crown, cfg["design_wavelength_um"])
    n2 = index(flint, cfg["design_wavelength_um"])
    r1 = (n1 - 1) * (1 + np.sqrt(1 - p1 * cfg["l1_thickness"] / n1)) / p1
    r4 = 1.0 / (1.0 / -r1 - p2 / (n2 - 1))
    return np.array([r1, -r1, -r1, r4])


def theta(cfg, traffic, rng):
    """The design radii detuned by the traffic's draw, as log-magnitudes."""
    detune = traffic["detune"]
    radii = design_radii(cfg) * (1 + rng.uniform(-detune, detune, 4))
    return {"log_r": np.log(np.abs(radii))}


def surface_id(cfg) -> int:
    return 2 * IDS_PER_LENS


def _glass_row(coeffs, like):
    return torch.tensor([1.0] + list(coeffs), dtype=torch.float64, device=like.device)


def _lens(r1, r2, s1, s2, t, cfg, glass, first_id, move_x, like):
    """One thick lens as a one-tree group."""
    half = cfg["lens_diameter"] / 2

    def sag(r):
        pos = r * r - half**2
        return torch.abs(r) - torch.sqrt(torch.clamp(pos, min=0.0))

    dev = like.device

    def one(v):
        return torch.as_tensor(v, dtype=like.dtype, device=dev).reshape(())

    left = one(t / 2) + (sag(r1) if s1 < 0 else 0.0)
    right = one(t / 2) + (sag(r2) if s2 > 0 else 0.0)
    total, shift = left + right, right - left
    axis = (translation(x=move_x, like=like) @ rotation("x", 90, like.dtype, dev)
            @ rotation("y", 90, like.dtype, dev))

    zero = one(0.0)
    cyl = Leaves(CYLINDER, (axis @ translation(z=shift / 2, like=like))[None],
                 torch.stack([one(half), -total / 2, total / 2])[None], glass, [first_id])
    front = Leaves(SPHERE, (axis @ translation(z=r1 - t / 2, like=like))[None],
                   torch.stack([r1, zero, zero])[None], glass, [first_id + 1],
                   normal_scale=1.0 if s1 > 0 else -1.0)
    back = Leaves(SPHERE, (axis @ translation(z=r2 + t / 2, like=like))[None],
                  torch.stack([r2, zero, zero])[None], glass, [first_id + 3],
                  normal_scale=1.0 if s2 < 0 else -1.0)
    inner = ("intersect" if s1 > 0 else "difference", ("leaf", 0), ("leaf", 1))
    outer = ("intersect" if s2 < 0 else "difference", inner, ("leaf", 2))
    return Group(outer, [cyl, front, back])


def groups(cfg, th, dtype, device):
    """The doublet and its imager from ``th["log_r"]`` (a tensor, which may
    require grad), in ``dtype`` on ``device``."""
    log_r = torch.as_tensor(th["log_r"], device=device).to(dtype)
    signs = torch.tensor(cfg["radius_signs"], dtype=dtype, device=device)
    r = signs * torch.exp(log_r)
    s = cfg["radius_signs"]
    crown = _glass_row(cfg["sellmeier"][cfg["crown"]], r)
    flint = _glass_row(cfg["sellmeier"][cfg["flint"]], r)
    t1, t2 = cfg["l1_thickness"], cfg["l2_thickness"]
    gap = cfg["l2_gap_factor"] * (t1 + t2) / 2
    l1 = _lens(r[0], r[1], s[0], s[1], t1, cfg, crown, 0, 0.0, r)
    l2 = _lens(r[2], r[3], s[2], s[3], t2, cfg, flint, IDS_PER_LENS, gap, r)
    size = cfg["lens_diameter"]
    imager_world = (translation(x=cfg["system_focus"], like=r)
                    @ rotation("y", 90, dtype, device))[None]
    imager = Leaves(PLANE, imager_world,
                    torch.tensor([[size, size, 0.0]], dtype=dtype, device=device), None,
                    [surface_id(cfg)])
    return [l1, l2, Group(("leaf", 0), [imager])]


def rays(cfg, n_per_source, dtype, device) -> Rays:
    """Six lines of rays along +X, one per wavelength, ids in order."""
    d = cfg["lens_diameter"]
    width = cfg["line_width_factor"] * d / 2
    ps, wls = [], []
    for wl in cfg["source_wavelengths_um"]:
        y = torch.linspace(-width / 2, width / 2, n_per_source, dtype=torch.float64,
                           device=device)
        p = torch.zeros((3, n_per_source), dtype=torch.float64, device=device)
        p[0] = cfg["source_x"]
        p[1] = y + cfg["line_offset_factor"] * d
        ps.append(p)
        wls.append(torch.full((n_per_source,), wl, dtype=torch.float64, device=device))
    p = torch.cat(ps, dim=1)
    direction = torch.zeros_like(p)
    direction[0] = 1.0
    ids = torch.arange(p.shape[1], dtype=torch.float64, device=device)
    return make_rays(p, direction, torch.cat(wls), ids, dtype)


def _smoothstep(t):
    t = torch.clamp(t, 0.0, 1.0)
    return t * t * (3.0 - 2.0 * t)


def loss_parts(cfg, records, masks):
    """(numerator, denominator) of the soft focus error: the weighted mean
    of squared axis-intercept errors, weights falling smoothly to zero at
    the imager's edge and for near-axial rays."""
    half = cfg["lens_diameter"] / 2
    ramp = cfg["ramp_factor"] * cfg["lens_diameter"]
    t0, t1 = cfg["tilt_ramp"]
    hit = masks & (records[:, 5] == surface_id(cfg))
    y1, z1 = records[:, 10], records[:, 11]
    w = _smoothstep((half - y1.abs()) / ramp) * _smoothstep((half - z1.abs()) / ramp)
    w = torch.where(hit, w, 0.0)
    x0, y0, xt, yt = records[:, 6], records[:, 7], records[:, 12], records[:, 13]
    w = w * _smoothstep((yt.abs() - t0) / (t1 - t0))
    safe = torch.where(yt.abs() > t0, yt, torch.full_like(yt, t0))
    err = x0 - xt * y0 / safe - cfg["system_focus"]
    return (err * err * w).sum(), w.sum()


def loss_value(a, b):
    return a / torch.clamp(b, min=1e-12)


def spot_parts(cfg, records, masks):
    """(hits, sum y, sum z, sum y^2 + z^2) on the imager, for the RMS spot
    radius about the centroid."""
    hit = masks & (records[:, 5] == surface_id(cfg))
    y = torch.where(hit, records[:, 10], 0.0)
    z = torch.where(hit, records[:, 11], 0.0)
    return hit.sum(), y.sum(), z.sum(), (y * y + z * z).sum()


def scene_counts(cfg):
    """(leaves, glass rows, leaf kinds a ray tests) for the roofline."""
    kinds = ["cylinder", "sphere", "sphere"] * 2 + ["plane"]
    return len(kinds), 3, kinds

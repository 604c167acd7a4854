"""Parity scenes of the port's tests, free of any JAX import.

Each builder takes a namespace of one package's builders (``comp``,
``matl``, ``csg``, ``Sphere``), so the same scene can be built by either
package; ``numpy_rays`` makes one seeded ray set for both.
"""

import types

import numpy as np
import torch

import pyrayt_tpu_torch.components as t_comp
import pyrayt_tpu_torch.materials as t_matl
import pyrayt_tpu_torch.scene.csg as t_csg
from pyrayt_tpu_torch.scene import fresh_ids as t_fresh_ids
from pyrayt_tpu_torch.scene.compile import compile_scene as t_compile
from pyrayt_tpu_torch.scene.surfaces import Sphere as t_Sphere

TORCH_NS = types.SimpleNamespace(
    comp=t_comp, matl=t_matl, csg=t_csg, Sphere=t_Sphere, fresh_ids=t_fresh_ids,
    compile=t_compile,
)


def _condenser(m):
    lens = m.comp.thick_lens(1.0, -1.0, 0.25, aperture=0.5, material=m.matl.glass["BK7"])
    return [lens, m.comp.baffle((1.0, 1.0)).move_x(1.0)]


def _all_primitives(m):
    mirror_p = m.comp.parabolic_mirror(focus=0.5, thickness=0.1, aperture=1.0)
    mirror_s = m.comp.spherical_mirror(radius=2.0, thickness=0.1, aperture=0.5).move_x(2.0)
    prism = m.comp.equilateral_prism(0.5, 0.5, material=m.matl.glass["BK7"]).move_y(1.5)
    return [mirror_p, mirror_s, prism, m.comp.baffle((3.0, 3.0)).move_x(3.0)]


def _prism_tir(m):
    prism = m.comp.equilateral_prism(1.0, 1.0, material=m.matl.glass["BK7"]).rotate_y(-30)
    return [prism, m.comp.baffle((20.0, 20.0)).move_x(5.0)]


def _mirrors(m):
    # two facing plane mirrors: rays never die
    m1 = m.comp.plane_mirror(0.1, aperture=4.0)
    m2 = m.comp.plane_mirror(0.1, aperture=4.0).move_x(2.0)
    return [m1, m2]


def _union(m):
    left = m.Sphere(1.0, material=m.matl.mirror)
    right = m.Sphere(1.0, material=m.matl.mirror).move_x(1.2)
    # the baffle sits behind the source and catches the reflected rays
    return [m.csg.union(left, right), m.comp.baffle((6.0, 6.0)).move_x(-4.0)]


# name -> (builder, source origin, +X cone half-angle in degrees, n rays,
#          generation limit)
SCENES = {
    "condenser": (_condenser, (-0.5, 0.0, 0.0), 10.0, 256, 6),
    "all_primitives": (_all_primitives, (-1.0, 0.0, 0.0), 0.0, 64, 5),
    "prism_tir": (_prism_tir, (-2.0, 0.0, 0.0), 0.0, 64, 8),
    "mirrors": (_mirrors, (1.0, 0.0, 0.0), 0.0, 32, 5),
    "union": (_union, (-3.0, 0.0, 0.0), 20.0, 64, 4),
}


def numpy_rays(origin, half_angle_deg, n, seed=7):
    """(positions (4, n), directions (4, n), metadata (5, n)) from a seed:
    origins jittered around ``origin`` (a line along y for collimated
    sets), directions within a +X cone."""
    rng = np.random.default_rng(seed)
    pos = np.zeros((4, n))
    pos[:3] = np.asarray(origin, dtype=float)[:, None]
    if half_angle_deg == 0.0:
        pos[1] += rng.uniform(-0.4, 0.4, n)
        pos[2] += rng.uniform(-0.05, 0.05, n)
    else:
        pos[:3] += rng.normal(0.0, 1e-3, (3, n))
    pos[3] = 1.0
    theta = np.deg2rad(half_angle_deg) * np.sqrt(rng.uniform(0.0, 1.0, n))
    phi = rng.uniform(0.0, 2 * np.pi, n)
    dirs = np.zeros((4, n))
    dirs[0] = np.cos(theta)
    dirs[1] = np.sin(theta) * np.cos(phi)
    dirs[2] = np.sin(theta) * np.sin(phi)
    meta = np.stack(
        (
            np.zeros(n),
            np.full(n, 100.0),
            rng.choice([0.45, 0.55, 0.633], n),
            np.ones(n),
            np.arange(n, dtype=float),
        )
    )
    return pos, dirs, meta


# ---------------------------------------------------------------------------
# gradient scenes: the five scenes of tests/test_ops/test_fused_grad.py
# ---------------------------------------------------------------------------


def _mirror(m):
    mirror = m.comp.spherical_mirror(radius=2.0, thickness=0.2, aperture=1.0)
    return [mirror, m.comp.baffle((4.0, 4.0)).move_x(3.0)]


def _union_blob(m):
    left = m.Sphere(1.0, material=m.matl.glass["ideal"])
    right = m.Sphere(1.0, material=m.matl.glass["ideal"]).move_x(0.8)
    return [m.csg.union(left, right), m.comp.baffle((6.0, 6.0)).move_x(4.0)]


def _imager(m):
    glass = m.matl.glass["BK7"]
    radius = 2 * (float(glass.index_at(0.532)) - 1) * 50.0
    lens = m.comp.thick_lens(radius, -radius, 5.0, aperture=25.4, material=glass)
    stop = m.comp.aperture(size=(25.4, 25.4), aperture_size=3.0).move_x(25.0)
    return [lens, stop, m.comp.baffle((25.4, 25.4)).move_x(50.0)]


# name -> (builder, rays: (kind, origin, size), n rays, generation limit,
#          wavelength spread)
GRAD_SCENES = {
    "condenser": (_condenser, ("cone", (-0.5, 0.0, 0.0), 10.0), 64, 6, False),
    "mirror": (_mirror, ("line_back", (1.5, 0.0, 0.0), 0.3), 32, 4, False),
    "glass_coeffs": (_condenser, ("cone", (-0.5, 0.0, 0.0), 10.0), 64, 6, True),
    "union_blob": (_union_blob, ("line", (-2.0, 0.0, 0.0), 0.6), 32, 5, False),
    "imager": (_imager, ("circle", (-10.0, 0.0, 0.0), 2.5), 24, 6, False),
}


def grad_rays(name, seed=5):
    """(positions, directions, metadata) of a gradient scene, from a seed:
    a cone of half-angle ``size`` degrees, a line of half-width ``size``
    along y (``line_back`` travels -X), or a circle of radius ``size`` in
    the yz plane, every position jittered by 1e-4."""
    _, (kind, origin, size), n, _, spread = GRAD_SCENES[name]
    rng = np.random.default_rng(seed)
    pos = np.zeros((4, n))
    pos[:3] = np.asarray(origin, dtype=float)[:, None] + rng.normal(0.0, 1e-4, (3, n))
    pos[3] = 1.0
    dirs = np.zeros((4, n))
    dirs[0] = 1.0
    if kind == "cone":
        theta = np.deg2rad(size) * np.sqrt(rng.uniform(0.0, 1.0, n))
        phi = rng.uniform(0.0, 2 * np.pi, n)
        dirs[0] = np.cos(theta)
        dirs[1] = np.sin(theta) * np.cos(phi)
        dirs[2] = np.sin(theta) * np.sin(phi)
    elif kind in ("line", "line_back"):
        pos[1] += np.sort(rng.uniform(-size, size, n))
        if kind == "line_back":
            dirs[0] = -1.0
    else:  # circle
        phi = rng.uniform(0.0, 2 * np.pi, n)
        pos[1] += size * np.sin(phi)
        pos[2] += size * np.cos(phi)
    wavelength = rng.uniform(0.45, 0.65, n) if spread else np.full(n, 0.633)
    meta = np.stack(
        (np.zeros(n), np.full(n, 100.0), wavelength, np.ones(n), np.arange(n, dtype=float))
    )
    return pos, dirs, meta


def follows_float64_path(records32, masks32, records64, masks64):
    """(n,) bool: the rays whose float32 trace has the float64 trace's
    masks and hit surfaces in every generation."""
    same_surface = torch.where(
        masks64, records64[:, 5] == records32[:, 5].to(records64.dtype), True
    )
    return (masks32 == masks64).all(dim=0) & same_surface.all(dim=0)

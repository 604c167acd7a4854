"""Parity scenes of the port's tests, free of any JAX import.

Each builder takes a namespace of one package's builders (``comp``,
``matl``, ``csg``, ``Sphere``), so the same scene can be built by either
package; ``numpy_rays`` makes one seeded ray set for both.
"""

import types

import numpy as np

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

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


def hetero_row(m):
    """The heterogeneous lens wall cut to ten elements (cycling BK7, SF5 and
    SF2) plus its detector: 31 leaves and four material slots, a narrow
    scene; under an unsorted line of rays each warp of the backward holds
    rays on many distinct leaves and glasses."""
    return hetero_wall(m, n_elements=10)


# name -> (builder, rays: (kind, origin, size), n rays, generation limit,
#          wavelength spread)
GRAD_SCENES = {
    "condenser": (_condenser, ("cone", (-0.5, 0.0, 0.0), 10.0), 64, 6, False),
    "mirror": (_mirror, ("line_back", (1.5, 0.0, 0.0), 0.3), 32, 4, False),
    "glass_coeffs": (_condenser, ("cone", (-0.5, 0.0, 0.0), 10.0), 64, 6, True),
    "union_blob": (_union_blob, ("line", (-2.0, 0.0, 0.0), 0.6), 32, 5, False),
    "imager": (_imager, ("circle", (-10.0, 0.0, 0.0), 2.5), 24, 6, False),
    "hetero_row": (hetero_row, ("line_unsorted", (-1.5, 0.0, 0.0), 12.35), 256, 5, True),
}


def grad_rays(name, seed=5, n=None):
    """(positions, directions, metadata) of a gradient scene, from a seed:
    a cone of half-angle ``size`` degrees, a line of half-width ``size``
    along y (sorted along it; ``line_back`` travels -X, ``line_unsorted``
    keeps the draw's order, so neighbouring rays land anywhere on it), or a
    circle of radius ``size`` in the yz plane, every position jittered by
    1e-4; ``n`` rays (default: the scene's count)."""
    _, (kind, origin, size), n_default, _, spread = GRAD_SCENES[name]
    n = n or n_default
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
    elif kind == "line_unsorted":
        pos[1] += rng.uniform(-size, size, n)
    else:  # circle
        phi = rng.uniform(0.0, 2 * np.pi, n)
        pos[1] += size * np.sin(phi)
        pos[2] += size * np.cos(phi)
    wavelength = rng.uniform(0.45, 0.65, n) if spread else np.full(n, 0.633)
    meta = np.stack(
        (np.zeros(n), np.full(n, 100.0), wavelength, np.ones(n), np.arange(n, dtype=float))
    )
    return pos, dirs, meta


# ---------------------------------------------------------------------------
# wide scenes: microlens arrays and the heterogeneous lens wall
# ---------------------------------------------------------------------------

PITCH = 1.0
# lensmakers_equation(2.0, inf, 1.5, 0.25): the lenslets' focal length
MLA_FOCUS = 4.0


def mla(m, n, r=2.0, extra=()):
    """tests/test_ops/test_fused_wide.py:_mla: an n x n array of
    plano-convex lenslets (2 leaves each), any ``extra`` components, and a
    detector at the focal plane."""
    lenslets = m.comp.microlens_array(r, 0.25, n, n, PITCH)
    detector = m.comp.baffle((2.0 * n, 2.0 * n)).move_x(MLA_FOCUS)
    return lenslets + list(extra) + [detector]


def mla_with_csg_singles(m):
    """tests/test_ops/test_fused_wide.py:68: the 5x5 array plus an
    interval-CSG single (a thick lens) and a comparator-network single (a
    union of two mirror spheres)."""
    lens = m.comp.thick_lens(5.0, -5.0, 0.5, aperture=2.0, material=m.matl.glass["BK7"])
    s1 = m.Sphere(0.5, material=m.matl.mirror).move_y(4.0)
    s2 = m.Sphere(0.5, material=m.matl.mirror).move_y(4.3)
    return mla(m, 5, extra=(lens.move_x(-0.6), m.csg.union(s1, s2)))


def hetero_wall(m, n_elements=20, seed=0, pitch=2.6):
    """tests/test_ops/test_fused_wide_hetero.py:32-54: 20 distinct
    biconvex elements (random radii, thickness and aperture, cycling three
    glasses) side by side along y, plus a detector: 61 leaves, one
    shape-only group, 4 material slots."""
    glasses = [m.matl.glass["BK7"], m.matl.glass["SF5"], m.matl.glass["SF2"]]
    rng = np.random.default_rng(seed)
    elements = []
    for i in range(n_elements):
        r1 = 3.0 + 4.0 * rng.random()
        r2 = -(3.0 + 4.0 * rng.random())
        y = (i - (n_elements - 1) / 2.0) * pitch
        elements.append(
            m.comp.thick_lens(r1, r2, 0.3 + 0.2 * rng.random(), aperture=1.5 + rng.random(),
                              material=glasses[i % 3]).move_y(y)
        )
    span = n_elements * pitch
    return elements + [m.comp.baffle((span, span)).move_x(6.0)]


def meniscus_wall(m, n=6, seed=1, pitch=2.2):
    """An n x n grid (in yz) of distinct meniscus lenses, each a cylinder
    minus a sphere (the concave front, r1 < 0) intersected with a sphere
    (the convex back): one same-shape group of n^2 three-leaf trees whose
    interval program holds a difference, in three chunks at n = 6, plus a
    detector."""
    rng = np.random.default_rng(seed)
    elements = []
    for i in range(n * n):
        r1 = -(3.0 + 2.0 * rng.random())
        r2 = -(1.6 + 0.6 * rng.random())
        y, z = ((i // n) - (n - 1) / 2.0) * pitch, ((i % n) - (n - 1) / 2.0) * pitch
        elements.append(
            m.comp.thick_lens(r1, r2, 0.3 + 0.2 * rng.random(), aperture=1.4 + 0.4 * rng.random(),
                              material=m.matl.glass["BK7"]).move(0.0, y, z)
        )
    span = 2.0 * n * pitch
    return elements + [m.comp.baffle((span, span)).move_x(6.0)]


def sphere_lens_wall(m, n=6, pitch=2.2):
    """An n x n grid (in yz) of bare biconvex lenses, each the intersection
    of two unit spheres 1.4 apart along x (no aperture cylinder), plus a
    detector: one same-shape group of n^2 two-sphere trees."""
    elements = []
    for i in range(n * n):
        y, z = ((i // n) - (n - 1) / 2.0) * pitch, ((i % n) - (n - 1) / 2.0) * pitch
        front = m.Sphere(1.0, material=m.matl.glass["BK7"]).move_x(0.7)
        back = m.Sphere(1.0, material=m.matl.glass["BK7"]).move_x(-0.7)
        elements.append(m.csg.intersect(front, back).move(0.0, y, z))
    span = 2.0 * n * pitch
    return elements + [m.comp.baffle((span, span)).move_x(6.0)]


# name -> (builder, grid rays: (width, height, x), n rays, generation limit)
WIDE_SCENES = {
    "mla5": (lambda m: mla(m, 5), (4.2, 4.2, -1.0), 256, 4),
    "mla6": (lambda m: mla(m, 6), (5.4, 5.4, -1.0), 256, 4),
    "csg_singles": (mla_with_csg_singles, (4.2, 4.2, -2.0), 256, 5),
    "hetero": (hetero_wall, (20 * 2.6 * 0.95, 1.0, -1.5), 256, 4),
    "meniscus": (meniscus_wall, (6 * 2.2 * 0.95, 6 * 2.2 * 0.95, -1.5), 1024, 4),
}


def grid_rays(width, height, x, n, wavelength=0.633):
    """(positions, directions, metadata) of ``GridOfRays(width,
    height).move_x(x)``: +X rays on a row-major grid in the yz plane, ids
    0..n-1."""
    k = int(np.ceil(np.sqrt(n)))
    rows = int(np.ceil(n / k))
    i = np.arange(n)
    pos = np.zeros((4, n))
    pos[0] = x
    pos[1] = ((i // k) / max(rows - 1, 1) - 0.5) * width
    pos[2] = ((i % k) / max(k - 1, 1) - 0.5) * height
    pos[3] = 1.0
    dirs = np.zeros((4, n))
    dirs[0] = 1.0
    meta = np.stack(
        (np.zeros(n), np.full(n, 100.0), np.full(n, wavelength), np.ones(n),
         np.arange(n, dtype=float))
    )
    return pos, dirs, meta


def wide_rays(name, n=None):
    _, (width, height, x), n_default, _ = WIDE_SCENES[name]
    return grid_rays(width, height, x, n or n_default)


def far_rays(n, dist, half, seed):
    """Rays from origins ``dist`` behind the plane x = 0 (spread over 2% of
    the distance sideways) to random points within ``half`` of the axis on
    it: (p, v) (3, n) float64 tensors."""
    rng = np.random.default_rng(seed)
    target = np.zeros((3, n))
    target[1:] = rng.uniform(-half, half, (2, n))
    src = np.zeros((3, n))
    src[0] = -dist
    src[1:] = rng.uniform(-half, half, (2, n)) + rng.uniform(-0.02, 0.02, (2, n)) * dist
    d = target - src
    return torch.as_tensor(src), torch.as_tensor(d / np.linalg.norm(d, axis=0))


def follows_float64_path(records32, masks32, records64, masks64):
    """(n,) bool: the rays whose float32 trace has the float64 trace's
    masks and hit surfaces in every generation."""
    same_surface = torch.where(
        masks64, records64[:, 5] == records32[:, 5].to(records64.dtype), True
    )
    return (masks32 == masks64).all(dim=0) & same_surface.all(dim=0)


def quadric_coefficients(kind, pr, o, d):
    """(a, b, c) of a sphere's, paraboloid's or cylinder's quadratic in t
    for local rays (o, d) (3, n), as csrc/trace_common.cuh forms them."""
    if kind == 0:  # sphere
        return (d * d).sum(0), 2 * (d * o).sum(0), (o * o).sum(0) - pr[0] ** 2
    if kind == 1:  # paraboloid
        return ((d[:2] ** 2).sum(0), 2 * (o[:2] * d[:2]).sum(0) - 4 * pr[0] * d[2],
                (o[:2] ** 2).sum(0) - 4 * pr[0] * o[2])
    return (d[:2] ** 2).sum(0), 2 * (d[:2] * o[:2]).sum(0), (o[:2] ** 2).sum(0) - pr[0] ** 2


def rehit_free32(spec, obj_tx, prim, records, masks):
    """(n,) bool: the rays whose float32 trace cannot re-hit the surface it
    just left by rounding.  After a hit the ray starts 1e-6 off the surface
    (the push-off), so that surface's quadratic has a root about 1e-6
    behind it, the small root c / q (q = -(b + sign(b) sqrt(disc)) / 2).
    The intersectors compute it as (-b +- sqrt(disc)) / 2a, whose float32
    rounding reaches eps32 (|b| + sqrt(disc)) / 2a: large for a ray almost
    parallel to a cylinder's axis (small a).  Where the small root is no
    larger than that bound its sign is rounding's to decide, and a float32
    trace may find the surface again 1e-6 ahead; such a ray is left out.
    Computed in float64 from ``records`` (G, 15, n) and ``masks``."""
    eps = float(np.finfo(np.float32).eps)
    rec = records.double().cpu().numpy()
    ran = masks.cpu().numpy()
    obj = obj_tx.double().cpu().numpy().reshape(-1, 4, 4)
    pr = prim.double().cpu().numpy()
    keep = np.ones(rec.shape[2], dtype=bool)
    for g in range(1, rec.shape[0]):
        p, v = rec[g, 6:9], rec[g, 12:15]
        started = ran[g - 1] & (np.abs(v).sum(0) > 0)
        for s, kind in enumerate(spec.leaf_types):
            if kind not in (0, 1, 4):
                continue
            o, d = obj[s, :3, :3] @ p + obj[s, :3, 3:], obj[s, :3, :3] @ v
            a, b, c = quadric_coefficients(kind, pr[s], o, d)
            disc = b * b - 4 * a * c
            real = started & (disc >= 0) & (a > 1e-8)
            root = np.sqrt(np.where(real, disc, 0.0))
            q = -0.5 * (b + np.copysign(root, b))
            small = np.abs(c / np.where(q == 0, 1.0, q))
            bound = eps * (np.abs(b) + root) / (2 * np.where(real, a, 1.0))
            keep &= ~(real & (small < 1e-4) & (small <= bound))
    return torch.as_tensor(keep, device=masks.device)


def reduce_key_sets(n, seed=0):
    """Synthetic tables for the wide backward's row reduce: ``{name: (keys
    (k,) int64, rows)}`` with keys in [-1, rows) (-1: no row), most of
    ``n`` entries: every key -1; every key one row; keys uniform over 4096
    rows; a detector-like skew (a third of the entries in one of 513 rows,
    the rest uniform or -1); one entry; and a length that is a multiple of
    neither the sort's segment (2048) nor its warp step."""
    rng = np.random.default_rng(seed)
    skew = rng.integers(-1, 512, n)
    skew[rng.random(n) < 1 / 3] = 512
    return {
        "all_minus_one": (np.full(n, -1), 16),
        "one_row": (np.full(n, 5), 16),
        "uniform_4096": (rng.integers(0, 4096, n), 4096),
        "detector_skew": (skew, 513),
        "n_one": (np.array([3]), 16),
        "ragged": (rng.integers(-1, 40, 3 * 2048 + 333), 40),
    }


def reduce_inputs(keys, rows, dtype, device, seed=1):
    """(keys int32, vals (k, 18), reduce_slots) for a key set: values
    standard normal from ``seed``, NaN where the key is -1 (no reduce may
    read them), the rows' slots a permutation of rows + 3 slots."""
    rng = np.random.default_rng(seed)
    vals = rng.standard_normal((keys.size, 18))
    vals[keys < 0] = np.nan
    slots = rng.permutation(rows + 3)[:rows]
    return (torch.as_tensor(keys, dtype=torch.int32, device=device),
            torch.as_tensor(vals, dtype=dtype, device=device),
            torch.as_tensor(slots, dtype=torch.int32, device=device))

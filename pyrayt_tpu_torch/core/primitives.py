"""Batched ray/primitive intersection in PyTorch.

Counterpart of ``pyrayt_tpu.core.primitives``.  Each intersector maps a ray
bundle ``rays: (2, 4, n)`` (or ``(2, 3, n)``: row 0 origins, row 1
directions, object space) to a ``(2, n)`` tensor of entry/exit parameters;
each normal function maps object-space points ``(4, n)`` to unit normals.
The +/-inf hit conventions match the JAX package exactly, including the
deviations it documents (a zero-direction ray gives ``(+inf, +inf)`` for a
sphere; guarded divisions never emit NaN).
"""

from __future__ import annotations

import torch

from pyrayt_tpu_torch.core.operations import (
    INF,
    _sum_rows,
    binomial_root,
    element_wise_dot,
    isclose,
    safe_sqrt,
)

__all__ = [
    "SPHERE",
    "PARABOLOID",
    "PLANE",
    "CUBE",
    "CYLINDER",
    "PARAM_WIDTH",
    "sphere_intersect",
    "sphere_normal",
    "paraboloid_intersect",
    "paraboloid_normal",
    "plane_intersect",
    "plane_normal",
    "cube_intersect",
    "cube_normal",
    "cylinder_intersect",
    "cylinder_normal",
    "leaf_intersect",
    "leaf_normal",
    "leaf_normal_raw3",
]

# primitive type codes used by the flattened scene representation
SPHERE = 0
PARABOLOID = 1
PLANE = 2
CUBE = 3
CYLINDER = 4

# width of the packed per-leaf parameter vector:
#   SPHERE     [radius, 0, 0, 0, 0, 0]
#   PARABOLOID [focus, height, 0, 0, 0, 0]
#   PLANE      [width, length, 0, 0, 0, 0]
#   CUBE       [x_min, x_max, y_min, y_max, z_min, z_max]
#   CYLINDER   [radius, h_min, h_max, capped, 0, 0]
PARAM_WIDTH = 6


def _sort2(a, b):
    return torch.stack((torch.minimum(a, b), torch.maximum(a, b)))


def _origins_directions(rays):
    return rays[0, :3], rays[1, :3]


def _const(like, value):
    return torch.full_like(like, value)


def _slab_clip(primary_hits, lo_hit, hi_hit):
    """Clip a sorted ``(2, n)`` interval against a second sorted interval;
    both hits become ``+inf`` when the two do not overlap."""
    entry = torch.maximum(primary_hits[0], lo_hit)
    exit_ = torch.minimum(primary_hits[1], hi_hit)
    hits = torch.stack((entry, exit_))
    return torch.where(hits[0] <= hits[1], hits, INF)


def _slab(origin_z, direction_z, z_lo, z_hi):
    """Entry/exit parameters of the ``z in [z_lo, z_hi]`` slab."""
    parallel = isclose(direction_z, 0)
    inside = (origin_z >= z_lo) & (origin_z <= z_hi)
    denominator = direction_z + parallel
    slab = _sort2((z_lo - origin_z) / denominator, (z_hi - origin_z) / denominator)
    slab_lo = torch.where(
        parallel, torch.where(inside, -INF, _const(origin_z, INF)), slab[0]
    )
    slab_hi = torch.where(parallel, INF, slab[1])
    return slab_lo, slab_hi


# ---------------------------------------------------------------------------
# Sphere
# ---------------------------------------------------------------------------


def sphere_intersect(rays, radius):
    origins, directions = _origins_directions(rays)
    a = element_wise_dot(directions, directions, dim=0)
    b = 2 * element_wise_dot(directions, origins, dim=0)
    c = element_wise_dot(origins, origins, dim=0) - radius**2

    disc = b**2 - 4 * a * c
    root = safe_sqrt(disc)
    degenerate = isclose(a, 0)  # zero-direction (dead) rays never hit
    hits = torch.stack(((-b + root), (-b - root))) / (2 * a + degenerate)
    return torch.where((disc >= 0) & ~degenerate, hits, INF)


def _zero_w(points):
    return torch.cat((points[:3], torch.zeros_like(points[:1])), dim=0)


def _unit(normals):
    # the guard sits on the sqrt argument: d sqrt(s)/ds is infinite at
    # s = 0, and a zero cotangent times inf is NaN under autograd (a
    # cylinder leaf's normal at an on-axis point the ray never hit)
    sq = _sum_rows(normals * normals)
    return normals / torch.sqrt(torch.where(sq == 0, 1.0, sq))


def sphere_normal(points, radius):
    del radius  # radial regardless of radius
    return _unit(_zero_w(points))


# ---------------------------------------------------------------------------
# Paraboloid  (x^2 + y^2 = 4 f z, capped at z = height)
# ---------------------------------------------------------------------------


def paraboloid_intersect(rays, focus, height):
    origins, directions = _origins_directions(rays)
    origins_xy, directions_xy = origins[:2], directions[:2]

    a = element_wise_dot(directions_xy, directions_xy, dim=0)
    b = (
        2 * element_wise_dot(origins_xy, directions_xy, dim=0)
        - 4 * focus * directions[2]
    )
    c = element_wise_dot(origins_xy, origins_xy, dim=0) - 4 * focus * origins[2]

    disc = b**2 - 4 * a * c
    linear_cases = isclose(a, 0)
    root = safe_sqrt(disc)
    parabola_hits = torch.stack(((-b + root), (-b - root))) / (2 * a + linear_cases)
    parabola_hits = torch.where(disc >= 0, parabola_hits, INF)

    # linear case: one real hit plus a signed infinity by travel direction
    linear_hits = torch.stack(
        (
            -c / (b + isclose(b, 0)),
            torch.where(directions[2] >= 0, _const(c, INF), -INF),
        )
    )
    parabola_hits = torch.where(linear_cases, linear_hits, parabola_hits)
    parabola_hits = _sort2(parabola_hits[0], parabola_hits[1])

    slab_lo, slab_hi = _slab(origins[2], directions[2], 0.0, height)
    return _slab_clip(parabola_hits, slab_lo, slab_hi)


def paraboloid_normal(points, focus, height):
    zeros = torch.zeros_like(points[0])
    normals = torch.stack((points[0], points[1], zeros - 2 * focus, zeros))
    cap = isclose(points[2], height)
    cap_normal = torch.stack((zeros, zeros, zeros + 1.0, zeros))
    normals = torch.where(cap, cap_normal, normals)
    return _unit(normals)


# ---------------------------------------------------------------------------
# Plane  (finite patch of z = 0)
# ---------------------------------------------------------------------------


def plane_intersect(rays, width, length):
    origins, directions = _origins_directions(rays)

    lo_bounds = []
    hi_bounds = []
    for axis, dim in ((0, width), (1, length)):
        is_zero = isclose(directions[axis], 0)
        skew_hit = torch.where(
            torch.abs(origins[axis]) <= dim / 2, -INF, _const(origins[axis], INF)
        )
        hit_1 = -(origins[axis] - dim / 2) / (directions[axis] + is_zero)
        hit_2 = -(origins[axis] + dim / 2) / (directions[axis] + is_zero)
        pair = _sort2(
            torch.where(is_zero, skew_hit, hit_1),
            torch.where(is_zero, INF, hit_2),
        )
        lo_bounds.append(pair[0])
        hi_bounds.append(pair[1])

    max_of_min = torch.maximum(lo_bounds[0], lo_bounds[1])
    min_of_max = torch.minimum(hi_bounds[0], hi_bounds[1])

    skew_ray = isclose(directions[2], 0)
    plane_hits = -origins[2] / (directions[2] + skew_ray)
    plane_hits = torch.where(skew_ray, INF, plane_hits)
    in_bounds = (plane_hits >= max_of_min) & (plane_hits <= min_of_max)
    plane_hits = torch.where(in_bounds, plane_hits, INF)
    # duplicated so CSG sees an even hit count (zero-volume solid)
    return torch.stack((plane_hits, plane_hits))


def plane_normal(points, width, length):
    del width, length
    zeros = torch.zeros_like(points[0])
    return torch.stack((zeros, zeros, zeros + 1.0, zeros))


# ---------------------------------------------------------------------------
# Cube / axis-aligned box
# ---------------------------------------------------------------------------


def cube_intersect(rays, axis_spans):
    """``axis_spans`` is a ``(3, 2)`` table of per-axis (min, max)."""
    origins, directions = _origins_directions(rays)

    mins = []
    maxes = []
    for axis in range(3):
        lo, hi = axis_spans[axis][0], axis_spans[axis][1]
        is_zero = isclose(directions[axis], 0)
        inside = (origins[axis] >= lo) & (origins[axis] <= hi)
        skew_min = torch.where(inside, -INF, _const(origins[axis], INF))
        hit_lo = -(origins[axis] - lo) / (directions[axis] + is_zero)
        hit_hi = -(origins[axis] - hi) / (directions[axis] + is_zero)
        pair = _sort2(
            torch.where(is_zero, skew_min, hit_lo),
            torch.where(is_zero, INF, hit_hi),
        )
        mins.append(pair[0])
        maxes.append(pair[1])

    entry = torch.maximum(torch.maximum(mins[0], mins[1]), mins[2])
    exit_ = torch.minimum(torch.minimum(maxes[0], maxes[1]), maxes[2])
    hits = torch.stack((entry, exit_))
    # strict <: a corner graze is a miss
    return torch.where(hits[0] < hits[1], hits, INF)


def cube_normal(points, axis_spans):
    rows = []
    for a in range(3):
        neg = isclose(points[a], axis_spans[a][0])
        pos = isclose(points[a], axis_spans[a][1])
        n = torch.where(neg, -1.0, torch.zeros_like(points[a]))
        rows.append(torch.where(pos, 1.0, n))
    rows.append(torch.zeros_like(points[0]))
    return _unit(torch.stack(rows))


# ---------------------------------------------------------------------------
# Cylinder  (radius about z, z in [h_min, h_max])
# ---------------------------------------------------------------------------


def cylinder_intersect(rays, radius, h_min, h_max):
    origins, directions = _origins_directions(rays)
    origins_2d, directions_2d = origins[:-1], directions[:-1]

    a = element_wise_dot(directions_2d, directions_2d, dim=0)
    b = 2 * element_wise_dot(directions_2d, origins_2d, dim=0)
    c = element_wise_dot(origins_2d, origins_2d, dim=0) - radius**2

    roots = binomial_root(a, b, c)
    sidewall = _sort2(roots[0], roots[1])
    slab_lo, slab_hi = _slab(origins[2], directions[2], h_min, h_max)
    return _slab_clip(sidewall, slab_lo, slab_hi)


def cylinder_normal(points, radius, h_min, h_max, capped=True):
    del radius
    zeros = torch.zeros_like(points[0])
    normals = torch.stack((points[0], points[1], zeros, zeros))
    if capped is not False:
        is_capped = torch.as_tensor(capped, device=points.device) != 0
        z = points[2]
        lo_cap = isclose(z, h_min) & is_capped
        hi_cap = isclose(z, h_max) & is_capped
        down = torch.stack((zeros, zeros, zeros - 1.0, zeros))
        up = torch.stack((zeros, zeros, zeros + 1.0, zeros))
        normals = torch.where(lo_cap, down, normals)
        normals = torch.where(hi_cap, up, normals)
    return _unit(normals)


# ---------------------------------------------------------------------------
# Packed-parameter dispatch used by the flattened scene representation
# ---------------------------------------------------------------------------


def _spans(params):
    return [(params[2 * a], params[2 * a + 1]) for a in range(3)]


def leaf_intersect(type_code: int, rays, params):
    """Intersect using a static type code and a packed ``(PARAM_WIDTH,)``
    parameter vector."""
    if type_code == SPHERE:
        return sphere_intersect(rays, params[0])
    if type_code == PARABOLOID:
        return paraboloid_intersect(rays, params[0], params[1])
    if type_code == PLANE:
        return plane_intersect(rays, params[0], params[1])
    if type_code == CUBE:
        return cube_intersect(rays, _spans(params))
    if type_code == CYLINDER:
        return cylinder_intersect(rays, params[0], params[1], params[2])
    raise ValueError(f"unknown primitive type code {type_code}")


def leaf_normal(type_code: int, points, params):
    """Unit object-space normal using a static type code and packed params."""
    if type_code == SPHERE:
        return sphere_normal(points, params[0])
    if type_code == PARABOLOID:
        return paraboloid_normal(points, params[0], params[1])
    if type_code == PLANE:
        return plane_normal(points, params[0], params[1])
    if type_code == CUBE:
        return cube_normal(points, _spans(params))
    if type_code == CYLINDER:
        return cylinder_normal(points, params[0], params[1], params[2], params[3])
    raise ValueError(f"unknown primitive type code {type_code}")


def leaf_normal_raw3(type_code, pts3, params):
    """Unnormalized object-space normal as three xyz rows.

    Callers renormalize after the world (inverse-transpose) transform, and
    ``normalize(A @ normalize(n)) == normalize(A @ n)``, so this skips the
    per-primitive normalization of :func:`leaf_normal`; directions match.
    ``params`` is the leaf's packed ``(PARAM_WIDTH,)`` vector.
    """
    x, y, z = pts3
    zeros = torch.zeros_like(x)
    ones = zeros + 1.0
    if type_code == SPHERE:
        return [x, y, z]
    if type_code == PARABOLOID:
        focus, height = params[0], params[1]
        cap = isclose(z, height)
        return [
            torch.where(cap, 0.0, x),
            torch.where(cap, 0.0, y),
            torch.where(cap, 1.0, zeros - 2 * focus),
        ]
    if type_code == PLANE:
        return [zeros, zeros, ones]
    if type_code == CUBE:
        out = []
        for a, c in enumerate((x, y, z)):
            neg = isclose(c, params[2 * a])
            pos = isclose(c, params[2 * a + 1])
            out.append(torch.where(pos, 1.0, torch.where(neg, -1.0, zeros)))
        return out
    if type_code == CYLINDER:
        capped = params[3] != 0
        lo_cap = isclose(z, params[1]) & capped
        hi_cap = isclose(z, params[2]) & capped
        cap = lo_cap | hi_cap
        return [
            torch.where(cap, 0.0, x),
            torch.where(cap, 0.0, y),
            torch.where(hi_cap, 1.0, torch.where(lo_cap, -1.0, zeros)),
        ]
    raise ValueError(f"unknown primitive type code {type_code}")

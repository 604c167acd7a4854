"""Plain PyTorch ray tracer: the benchmark's reference.

A straightforward tracer of the semantics that ``pyrayt_tpu_torch`` documents
for the scenes the benchmark runs (spheres, capped cylinders and planar
patches combined by intersect and difference; Sellmeier glass and
absorbers), written from those semantics and imports nothing of the
program.  Any floating dtype (float64 for the truth, bfloat16 for the
control) and any device.

A scene is a list of groups in fold order.  A group holds ``T`` trees of
one shape (``T = 1`` for a single component): a CSG template over leaf
positions and one :class:`Leaves` per position, whose tables carry a leading
tree axis.  Per generation every ray is intersected with every tree; the
nearest positive hit wins (a strict ``<``, so the first of equal candidates
in fold order wins, and inside a group the lowest tree).

Semantics kept from the documented conventions:

* quadratic roots come in pairs, a miss is ``(+inf, +inf)``, a ray along a
  cylinder's axis is inside or outside it for all ``t``;
* ``isclose`` is numpy's (``rtol = 1e-5``, ``atol = 1e-8``);
* a ray that hits nothing, or runs with a zero direction (absorbed), dies;
  a record row is kept for every ray that is alive and hits something;
* the record row holds the input ray's generation, intensity, wavelength,
  index and id, the hit surface's public id (0 for a miss), the segment's
  endpoints and its unit direction;
* refraction flips the normal and targets the world index when the ray
  leaves the medium, and reflects on total internal reflection;
* a surviving ray moves ``ray_offset`` along its new direction.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence, Tuple

import torch

INF = math.inf
SPHERE, CYLINDER, PLANE = "sphere", "cylinder", "plane"


def isclose(a, b, rtol=1e-5, atol=1e-8):
    b = torch.as_tensor(b, dtype=a.dtype, device=a.device)
    return (a - b).abs() <= atol + rtol * b.abs()


def _sqrt_pos(x):
    """sqrt(max(x, 0)) with a finite gradient where x <= 0."""
    pos = x > 0
    return torch.where(pos, torch.sqrt(torch.where(pos, x, torch.ones_like(x))), 0.0)


def _unit(v):
    """Normalise the rows of a (3, ...) stack; a zero vector stays zero."""
    sq = v[0] * v[0] + v[1] * v[1] + v[2] * v[2]
    zero = sq == 0
    return torch.where(zero, v, v / torch.sqrt(torch.where(zero, torch.ones_like(sq), sq)))


# ---------------------------------------------------------------------------
# transforms
# ---------------------------------------------------------------------------


def translation(x=0.0, y=0.0, z=0.0, like=None):
    """A (4, 4) translation; entries may be tensors (their graph is kept)."""
    dtype = like.dtype if like is not None else torch.float64
    device = like.device if like is not None else None

    def t(v):
        return torch.as_tensor(v, dtype=dtype, device=device).reshape(())

    one, zero = t(1.0), t(0.0)
    return torch.stack([
        torch.stack([one, zero, zero, t(x)]),
        torch.stack([zero, one, zero, t(y)]),
        torch.stack([zero, zero, one, t(z)]),
        torch.stack([zero, zero, zero, one]),
    ])


def rotation(axis: str, degrees: float, dtype=torch.float64, device=None):
    """A (4, 4) rotation about a world axis, right-handed."""
    c, s = math.cos(math.radians(degrees)), math.sin(math.radians(degrees))
    i, j = {"x": (1, 2), "y": (2, 0), "z": (0, 1)}[axis]
    m = torch.eye(4, dtype=dtype, device=device)
    m[i, i] = c
    m[j, j] = c
    m[i, j] = -s
    m[j, i] = s
    return m


# ---------------------------------------------------------------------------
# scene
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Leaves:
    """One leaf position of a group: ``T`` primitives of one kind.

    ``world`` (T, 4, 4) object-to-world transforms; ``params`` (T, 3) the
    primitive's sizes (sphere: radius; cylinder: radius, z_min, z_max;
    plane: width, length); ``glass`` the (7,) Sellmeier row
    ``[A, b1, b2, b3, c1, c2, c3]`` or None for an absorber; ``ids`` the
    public surface ids; ``normal_scale`` -1 for a subtracted surface."""

    kind: str
    world: torch.Tensor
    params: torch.Tensor
    glass: Optional[torch.Tensor]
    ids: Sequence[int]
    normal_scale: float = 1.0


@dataclasses.dataclass
class Group:
    """``template``: ("leaf", j) or (op, left_template, ("leaf", j)) with op
    "intersect" or "difference"; ``leaves[j]`` the leaves at position j."""

    template: tuple
    leaves: List[Leaves]

    @property
    def trees(self) -> int:
        return self.leaves[0].world.shape[0]


@dataclasses.dataclass
class Tables:
    """Every leaf of a scene flattened in (group, position, tree) order."""

    obj_tx: torch.Tensor  # (L, 4, 4) world-to-object
    kind: torch.Tensor  # (L,) 0 sphere, 1 cylinder, 2 plane
    params: torch.Tensor  # (L, 3)
    scale: torch.Tensor  # (L,)
    absorb: torch.Tensor  # (L,) bool
    glass: torch.Tensor  # (L, 7)
    ids: torch.Tensor  # (L,)
    offsets: List[List[int]]  # offsets[g][j]: first row of group g's position j
    boxes: List[Optional[torch.Tensor]]  # per group of CULL_MIN trees or more: (T, 2, 3)


_KIND_CODE = {SPHERE: 0, CYLINDER: 1, PLANE: 2}
CULL_MIN = 8  # trees of a group before each block of rays tests only the trees it can reach
CULL_MARGIN = 1e-3  # mm added around every box, and a few ulps of the dtype


def _leaf_boxes(leaves: Leaves) -> torch.Tensor:
    """(T, 2, 3) world bounds of each primitive (float64, no grad): the
    8 corners of its object-space box, transformed."""
    p = leaves.params.detach().to(torch.float64)
    zero = torch.zeros_like(p[:, 0])
    if leaves.kind == SPHERE:
        r = p[:, 0].abs()
        lo, hi = torch.stack([-r, -r, -r], 1), torch.stack([r, r, r], 1)
    elif leaves.kind == CYLINDER:
        r = p[:, 0].abs()
        lo, hi = torch.stack([-r, -r, p[:, 1]], 1), torch.stack([r, r, p[:, 2]], 1)
    else:
        lo = torch.stack([-p[:, 0] / 2, -p[:, 1] / 2, zero], 1)
        hi = torch.stack([p[:, 0] / 2, p[:, 1] / 2, zero], 1)
    corners = torch.stack([torch.stack([(hi if (c >> a) & 1 else lo)[:, a] for a in range(3)], 1)
                           for c in range(8)], 1)  # (T, 8, 3)
    m = leaves.world.detach().to(torch.float64)
    world = torch.einsum("tij,tcj->tci", m[:, :3, :3], corners) + m[:, None, :3, 3]
    return torch.stack([world.amin(1), world.amax(1)], 1)


def _tree_boxes(template, leaves) -> torch.Tensor:
    """Bounds of each tree of a group: an intersection lies in both boxes,
    a difference in its left operand's."""
    if template[0] == "leaf":
        return _leaf_boxes(leaves[template[1]])
    op, left, right = template
    box = _tree_boxes(left, leaves)
    if op == "intersect":
        other = _leaf_boxes(leaves[right[1]])
        box = torch.stack([torch.maximum(box[:, 0], other[:, 0]),
                           torch.minimum(box[:, 1], other[:, 1])], 1)
    return box


def scene_tables(groups: Sequence[Group], dtype) -> Tables:
    obj, kind, params, scale, absorb, glass, ids, offsets = [], [], [], [], [], [], [], []
    row = 0
    for g in groups:
        offs = []
        for leaves in g.leaves:
            t = leaves.world.shape[0]
            offs.append(row)
            row += t
            obj.append(torch.linalg.inv(leaves.world.to(torch.float64)).to(dtype))
            dev = leaves.world.device
            kind += [_KIND_CODE[leaves.kind]] * t
            params.append(leaves.params.to(dtype))
            scale += [leaves.normal_scale] * t
            absorb += [leaves.glass is None] * t
            gl = (leaves.glass if leaves.glass is not None
                  else torch.zeros(7, dtype=torch.float64, device=dev))
            glass.append(gl.to(dtype).reshape(1, 7).expand(t, 7))
            ids += [float(i) for i in leaves.ids]
        offsets.append(offs)
    dev = obj[0].device
    return Tables(
        obj_tx=torch.cat(obj), kind=torch.tensor(kind, device=dev),
        params=torch.cat(params),
        scale=torch.tensor(scale, dtype=dtype, device=dev),
        absorb=torch.tensor(absorb, device=dev), glass=torch.cat(glass),
        ids=torch.tensor(ids, dtype=dtype, device=dev), offsets=offsets,
        boxes=[_tree_boxes(g.template, g.leaves) if g.trees >= CULL_MIN else None
               for g in groups])


# ---------------------------------------------------------------------------
# intersections in object space: o, d are (3, T, n)
# ---------------------------------------------------------------------------


def _sorted(a, b):
    return torch.minimum(a, b), torch.maximum(a, b)


def _slab(oz, dz, lo, hi):
    par = isclose(dz, 0.0)
    inside = (oz >= lo) & (oz <= hi)
    den = dz + par.to(dz.dtype)
    a, b = _sorted((lo - oz) / den, (hi - oz) / den)
    inf = torch.full_like(oz, INF)
    s_lo = torch.where(par, torch.where(inside, -inf, inf), a)
    s_hi = torch.where(par, inf, b)
    return s_lo, s_hi


def sphere_hits(o, d, p):
    r = p[:, 0, None]
    a = (d * d).sum(0)
    b = 2 * (d * o).sum(0)
    c = (o * o).sum(0) - r * r
    disc = b * b - 4 * a * c
    root = _sqrt_pos(disc)
    deg = isclose(a, 0.0)
    den = 2 * a + deg.to(a.dtype)
    ok = (disc >= 0) & ~deg
    h0 = torch.where(ok, (-b + root) / den, INF)
    h1 = torch.where(ok, (-b - root) / den, INF)
    return _sorted(h0, h1)


def cylinder_hits(o, d, p):
    r, z0, z1 = p[:, 0, None], p[:, 1, None], p[:, 2, None]
    a = d[0] * d[0] + d[1] * d[1]
    b = 2 * (d[0] * o[0] + d[1] * o[1])
    c = o[0] * o[0] + o[1] * o[1] - r * r
    disc = b * b - 4 * a * c
    lin = isclose(a, 0.0)
    root = _sqrt_pos(disc)
    den = 2 * a + lin.to(a.dtype)
    q0 = torch.where(disc >= 0, (-b + root) / den, INF)
    q1 = torch.where(disc >= 0, (-b - root) / den, INF)
    live_lin = lin & ~isclose(b, 0.0)
    lin_root = -c / torch.where(live_lin, b, torch.ones_like(b))
    q0 = torch.where(lin, lin_root, q0)
    q1 = torch.where(lin, lin_root, q1)
    const = lin & isclose(b, 0.0)
    inf = torch.full_like(c, INF)
    q0 = torch.where(const, torch.where(c <= 0, -inf, inf), q0)
    q1 = torch.where(const, INF, q1)
    side_lo, side_hi = _sorted(q0, q1)
    s_lo, s_hi = _slab(o[2], d[2], z0, z1)
    lo = torch.maximum(side_lo, s_lo)
    hi = torch.minimum(side_hi, s_hi)
    keep = lo <= hi
    return torch.where(keep, lo, INF), torch.where(keep, hi, INF)


def plane_hits(o, d, p):
    lo_b, hi_b = [], []
    for axis in (0, 1):
        size = p[:, axis, None]
        zero = isclose(d[axis], 0.0)
        den = d[axis] + zero.to(d.dtype)
        inf = torch.full_like(o[axis], INF)
        skew = torch.where(o[axis].abs() <= size / 2, -inf, inf)
        h1 = torch.where(zero, skew, -(o[axis] - size / 2) / den)
        h2 = torch.where(zero, INF, -(o[axis] + size / 2) / den)
        a, b = _sorted(h1, h2)
        lo_b.append(a)
        hi_b.append(b)
    skew_z = isclose(d[2], 0.0)
    t = torch.where(skew_z, INF, -o[2] / (d[2] + skew_z.to(d.dtype)))
    inside = (t >= torch.maximum(*lo_b)) & (t <= torch.minimum(*hi_b))
    t = torch.where(inside, t, INF)
    return t, t


_HITS = {SPHERE: sphere_hits, CYLINDER: cylinder_hits, PLANE: plane_hits}


def _to_object(m, p, d):
    """(T, 4, 4) world-to-object transforms, world rays (3, n) -> (3, T, n)."""
    lo = torch.stack([m[:, i, 0, None] * p[0] + m[:, i, 1, None] * p[1]
                      + m[:, i, 2, None] * p[2] + m[:, i, 3, None] for i in range(3)])
    ld = torch.stack([m[:, i, 0, None] * d[0] + m[:, i, 1, None] * d[1]
                      + m[:, i, 2, None] * d[2] for i in range(3)])
    return lo, ld


def _intervals(template, leaf_iv):
    """CSG of a template over per-position intervals (lo, hi, lo_pos, hi_pos)."""
    if template[0] == "leaf":
        return [leaf_iv[template[1]]]
    op, left, right = template
    b0, b1, j0, j1 = leaf_iv[right[1]]
    out = []
    for a0, a1, i0, i1 in _intervals(left, leaf_iv):
        if op == "intersect":
            lo, hi = torch.maximum(a0, b0), torch.minimum(a1, b1)
            lo_id = torch.where(b0 > a0, j0, i0)
            hi_id = torch.where(b1 < a1, j1, i1)
            empty = lo > hi
            out.append((torch.where(empty, INF, lo), torch.where(empty, INF, hi), lo_id, hi_id))
        else:  # difference: [a0, min(a1, b0)] and [max(a0, b1), a1]
            p_hi = torch.minimum(a1, b0)
            p_hi_id = torch.where(b0 < a1, j0, i1)
            e1 = a0 > p_hi
            out.append((torch.where(e1, INF, a0), torch.where(e1, INF, p_hi), i0, p_hi_id))
            p_lo = torch.maximum(a0, b1)
            p_lo_id = torch.where(b1 > a0, j1, i0)
            e2 = p_lo > a1
            out.append((torch.where(e2, INF, p_lo), torch.where(e2, INF, a1), p_lo_id, i1))
    return out


def reachable(boxes, p, d):
    """Indices (ascending) of the trees whose boxes some ray of the block can
    reach: the block's segments inside the union of the boxes bound every
    point a ray can hit there.  Rays that no longer move reach nothing."""
    p64, d64 = p.detach().to(torch.float64), d.detach().to(torch.float64)
    eps = CULL_MARGIN + 4 * torch.finfo(p.dtype).eps * float(boxes.abs().max())
    lo, hi = boxes[:, 0].amin(0) - eps, boxes[:, 1].amax(0) + eps
    moving = (d64 != 0).any(0)
    t_in = torch.zeros_like(p64[0])
    t_out = torch.full_like(p64[0], INF)
    for a in range(3):
        par = d64[a] == 0
        inside = (p64[a] >= lo[a]) & (p64[a] <= hi[a])
        den = torch.where(par, torch.ones_like(d64[a]), d64[a])
        t0, t1 = (lo[a] - p64[a]) / den, (hi[a] - p64[a]) / den
        t_in = torch.where(par, torch.where(inside, t_in, INF),
                           torch.maximum(t_in, torch.minimum(t0, t1)))
        t_out = torch.where(par, t_out, torch.minimum(t_out, torch.maximum(t0, t1)))
    live = moving & (t_in <= t_out)
    if not bool(live.any()):
        return torch.zeros(0, dtype=torch.long, device=p.device)
    ends = torch.stack([p64 + t_in * d64, p64 + t_out * d64])[:, :, live]  # (2, 3, k)
    seg_lo, seg_hi = ends.amin((0, 2)) - eps, ends.amax((0, 2)) + eps
    near = ((boxes[:, 0] <= seg_hi) & (boxes[:, 1] >= seg_lo)).all(1)
    return torch.nonzero(near).flatten().to(p.device)


def nearest_hit(groups, tables: Tables, p, d):
    """(distance (n,), leaf row (n,) int64, -1 for a miss)."""
    n = p.shape[-1]
    best = torch.full((n,), INF, dtype=p.dtype, device=p.device)
    best_row = torch.full((n,), -1, dtype=torch.long, device=p.device)
    for gi, g in enumerate(groups):
        boxes = tables.boxes[gi]
        trees = (torch.arange(g.trees, device=p.device) if boxes is None
                 else reachable(boxes.to(p.device), p, d))
        t_count = int(trees.numel())
        if t_count == 0:
            continue
        leaf_iv = {}
        for j, leaves in enumerate(g.leaves):
            rows = tables.offsets[gi][j] + trees
            o, dl = _to_object(tables.obj_tx[rows], p, d)
            lo, hi = _HITS[leaves.kind](o, dl, tables.params[rows])
            pos = torch.full(lo.shape, j, dtype=torch.long, device=p.device)
            leaf_iv[j] = (lo, hi, pos, pos)
        dist = torch.full((t_count, n), INF, dtype=p.dtype, device=p.device)
        pos = torch.full((t_count, n), -1, dtype=torch.long, device=p.device)
        for lo, hi, lo_id, hi_id in _intervals(g.template, leaf_iv):
            for cand, ids in ((lo, lo_id), (hi, hi_id)):
                cand = torch.where(cand > 0, cand, INF)
                new = cand < dist
                dist = torch.where(new, cand, dist)
                pos = torch.where(new, ids, pos)
        win = torch.argmin(dist, dim=0)
        dmin = torch.gather(dist, 0, win[None])[0]
        wpos = torch.gather(pos, 0, win[None])[0]
        offs = torch.tensor(tables.offsets[gi], device=p.device)
        row = offs[wpos.clamp(min=0)] + trees[win]
        new = dmin < best
        best = torch.where(new, dmin, best)
        best_row = torch.where(new, row, best_row)
    return best, best_row


def _normals(tables: Tables, row, hit_p):
    """World unit normals of each ray's hit leaf (zero for a miss)."""
    rows = row.clamp(min=0)
    m = tables.obj_tx[rows]  # (n, 4, 4)
    lp = [m[:, i, 0] * hit_p[0] + m[:, i, 1] * hit_p[1] + m[:, i, 2] * hit_p[2] + m[:, i, 3]
          for i in range(3)]
    kind = tables.kind[rows]
    par = tables.params[rows]
    zeros = torch.zeros_like(lp[0])
    lo_cap = isclose(lp[2], par[:, 1]) & (kind == 1)
    hi_cap = isclose(lp[2], par[:, 2]) & (kind == 1)
    cap = lo_cap | hi_cap
    nx = torch.where(kind == 2, zeros, torch.where(cap, zeros, lp[0]))
    ny = torch.where(kind == 2, zeros, torch.where(cap, zeros, lp[1]))
    nz_cyl = torch.where(hi_cap, 1.0, torch.where(lo_cap, -1.0, zeros))
    nz = torch.where(kind == 2, 1.0, torch.where(kind == 1, nz_cyl, lp[2]))
    world = torch.stack([m[:, 0, i] * nx + m[:, 1, i] * ny + m[:, 2, i] * nz for i in range(3)])
    return _unit(world) * tables.scale[rows] * (row >= 0).to(hit_p.dtype)


def _refract(v, nrm, n1, n2, world_index):
    v = _unit(v)
    cos_p = (v * nrm).sum(0)
    exiting = cos_p > 0
    n2 = torch.where(exiting, torch.full_like(n2, world_index), n2)
    nrm = torch.where(exiting, -nrm, nrm)
    r = n1 / n2
    cos1 = torch.where(exiting, cos_p, -cos_p)
    rad = 1 - r * r * (1 - cos1 * cos1)
    cos2 = _sqrt_pos(rad)
    out = torch.where(rad > 0, r * v + (r * cos1 - cos2) * nrm, v + 2 * cos1 * nrm)
    return _unit(out), torch.where(rad > 0, n2, n1)


def sellmeier(coeffs, wavelength):
    """Index from rows ``[A, b1, b2, b3, c1, c2, c3]`` (per ray)."""
    wl2 = wavelength * wavelength
    n2 = coeffs[:, 0]
    for i in range(3):
        den = wl2 - coeffs[:, 4 + i]
        n2 = n2 + coeffs[:, 1 + i] * wl2 / torch.where(den == 0, torch.ones_like(den), den)
    return torch.sqrt(n2)


@dataclasses.dataclass
class Rays:
    """World rays: positions and directions (3, n), metadata (n,)."""

    p: torch.Tensor
    d: torch.Tensor
    generation: torch.Tensor
    intensity: torch.Tensor
    wavelength: torch.Tensor
    index: torch.Tensor
    id: torch.Tensor

    @property
    def n(self):
        return self.p.shape[-1]

    def block(self, sl):
        return Rays(self.p[:, sl], self.d[:, sl], self.generation[sl], self.intensity[sl],
                    self.wavelength[sl], self.index[sl], self.id[sl])


def make_rays(p, d, wavelength, ids, dtype):
    """Fresh rays: generation 0, intensity 100, index 1, unit directions."""
    d = d / torch.sqrt((d * d).sum(0))
    n = p.shape[-1]
    kw = dict(dtype=dtype, device=p.device)
    return Rays(p.to(dtype), d.to(dtype), torch.zeros(n, **kw), torch.full((n,), 100.0, **kw),
                wavelength.to(dtype), torch.ones(n, **kw), ids.to(dtype))


def trace(groups, rays: Rays, generations: int, ray_offset=1e-6, world_index=1.0,
          tables: Optional[Tables] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Records (G, 15, n) and their mask (G, n) for ``generations`` steps."""
    dtype = rays.p.dtype
    tables = tables if tables is not None else scene_tables(groups, dtype)
    p, d = rays.p, rays.d
    gen, inten, wl, idx, ids = rays.generation, rays.intensity, rays.wavelength, rays.index, rays.id
    alive = torch.ones(rays.n, dtype=torch.bool, device=p.device)
    records, masks = [], []
    for _ in range(generations):
        t, row = nearest_hit(groups, tables, p, d)
        miss = row < 0
        p_hit = p + torch.where(miss, 0.0, t) * d
        nrm = _normals(tables, row, p_hit)
        rows = row.clamp(min=0)
        absorb = tables.absorb[rows]
        n2 = sellmeier(tables.glass[rows], wl)
        v_ref, i_ref = _refract(d, nrm, idx, n2, world_index)
        glass = ~miss & ~absorb
        new_d = torch.where(glass, v_ref, 0.0)
        new_i = torch.where(glass, i_ref, idx)
        speed = torch.sqrt((d * d).sum(0))
        dead = isclose(speed, 0.0) | miss
        living = alive & ~dead
        surface = torch.where(miss, 0.0, tables.ids[rows])
        records.append(torch.cat([torch.stack([gen, inten, wl, idx, ids, surface]), p, p_hit,
                                  _unit(d)]))
        masks.append(living)
        p = torch.where(living, p_hit + ray_offset * new_d, p_hit)
        d = new_d
        gen = torch.where(living, gen + 1, gen)
        idx = new_i
        alive = living
    return torch.stack(records), torch.stack(masks)

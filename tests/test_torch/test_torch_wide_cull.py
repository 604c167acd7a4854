"""The tight cull boxes of the wide kernels K2 and K8
(``ops/fused_trace.py:wide_cull_tables``, ``_wide_box_pass``) and the
gradient dispatch past the wide backward's table reduce
(``ops/fused_grad.py:reduce_takes``, ``pick_fused_grad``), float64, CPU.

The kernels skip every tree whose box a ray does not enter, so the boxes
must hold every positive candidate the plain engine finds
(``engine._wide_group_candidates``): on the arrays, the lens wall and the
wide parity scenes, for the source rays and for the rays of later
generations of a plain trace, and on random interval trees of spheres,
cylinders and cubes under random rigid transforms.
"""

import math

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from pyrayt_tpu_torch import interop
from pyrayt_tpu_torch.config import TraceConfig
from pyrayt_tpu_torch.ops import fused_grad as fg
from pyrayt_tpu_torch.ops import fused_trace as ft
from pyrayt_tpu_torch.tracer import engine
from torch_parity_scenes import (
    TORCH_NS,
    WIDE_SCENES,
    far_rays,
    grid_rays,
    hetero_wall,
    meniscus_wall,
    mla,
    sphere_lens_wall,
)

F64 = torch.float64
# name -> (builder, grid (width, height, x), generation limit)
CULL_SCENES = {name: (build, grid, gens) for name, (build, grid, _, gens) in WIDE_SCENES.items()}
CULL_SCENES["mla8"] = (lambda m: mla(m, 8), (8.4, 8.4, -1.0), 4)
CULL_SCENES["mla16"] = (lambda m: mla(m, 16), (16.8, 16.8, -1.0), 4)
CULL_SCENES["hetero_wall"] = (hetero_wall, (20 * 2.6 * 1.05, 3.0, -1.5), 4)


def compiled(build):
    with TORCH_NS.fresh_ids():
        return TORCH_NS.compile(build(TORCH_NS), device="cpu", dtype=F64)


def random_rays(n, center, half, seed):
    """NumPy rays from a seed: origins in a box around the scene, random
    unit directions, a third of them along the coordinate axes (the
    intersectors' near-parallel branches) and a sixth tilted by 1e-5 rad."""
    rng = np.random.default_rng(seed)
    pos = np.ones((4, n))
    pos[:3] = np.asarray(center)[:, None] + rng.uniform(-1, 1, (3, n)) * np.asarray(half)[:, None]
    dirs = np.zeros((4, n))
    dirs[:3] = rng.standard_normal((3, n))
    third = n // 3
    axis = rng.integers(0, 3, third)
    dirs[:3, :third] = 0.0
    dirs[axis, np.arange(third)] = rng.choice([-1.0, 1.0], third)
    sixth = n // 6
    dirs[:3, third:third + sixth] = 0.0
    dirs[0, third:third + sixth] = 1.0
    dirs[1, third:third + sixth] = 1e-5
    dirs[:3] /= np.linalg.norm(dirs[:3], axis=0)
    meta = np.stack((np.zeros(n), np.full(n, 100.0), np.full(n, 0.633), np.ones(n),
                     np.arange(n, dtype=float)))
    return interop.rays_from_numpy(pos, dirs, meta, device="cpu", dtype=F64)


def scene_rays(spec, params, grid, gens, seed):
    """Rays (p, v) (3, k) of every generation of a plain trace of the grid
    and of random rays: the input rays of each generation they ran."""
    width, height, x = grid
    n = 256
    sources = [interop.rays_from_numpy(*grid_rays(width, height, x, n), device="cpu", dtype=F64)]
    origins = params["world"][:, :3, 3]
    leaves_lo, leaves_hi = origins.min(0).values, origins.max(0).values
    center = ((leaves_lo + leaves_hi) / 2).tolist()
    half = ((leaves_hi - leaves_lo) / 2 + 2.0).tolist()
    sources.append(random_rays(n, center, half, seed))
    ps, vs = [], []
    config = TraceConfig(generation_limit=gens)
    for rays in sources:
        inputs = ft.wide_kernel_inputs(spec, params, rays)
        records, masks, _ = ft.fused_trace_wide_plain(spec, config, *inputs)
        ran = fg.generations_ran(records, masks)
        for g in range(gens):
            if g == 0:
                p, v = inputs[0][0:3], inputs[0][4:7]
            else:
                p, v = records[g, 6:9], records[g, 12:15]
            ps.append(p[:, ran[g]])
            vs.append(v[:, ran[g]])
    return torch.cat(ps, dim=1), torch.cat(vs, dim=1)


def plain_tree_boxes(spec, params, slots, gi):
    """Per sorted tree of group ``gi``, its box folded leaf by leaf with
    Python loops: the 8 corners of each leaf's local box through its world
    transform (NumPy), intersected over the loaded and intersected leaves
    of a bounded type, kept over a subtracted one; and the group's slope,
    the leaves' local slopes plus 8 sqrt(eps) through |A|."""
    plan = [info for kind, _, info in ft.wide_fold_plan(spec) if kind == "group"][gi]
    world = params["world"].numpy()
    prim = params["prim"].numpy()
    ops = [op for op, _ in ft._interval_chain(plan["template"])]
    t_count, l_count, off = plan["T"], plan["L"], plan["off"]
    sorted_slots = slots[off:off + t_count * l_count].reshape(t_count, l_count).tolist()
    boxes, slope = [], np.zeros(3)
    rounding = 8.0 * np.sqrt(np.finfo(np.float64).eps)
    for row in sorted_slots:
        lo, hi = np.full(3, -math.inf), np.full(3, math.inf)
        for j, s in enumerate(row):
            t = plan["types_pos"][j]
            if ops[j] == ft.IV_SUB or t not in ft._CULL_SLOPE:
                continue
            llo, lhi = local_box(t, prim[s])
            corners = np.array([[a, b, c] for a in (llo[0], lhi[0]) for b in (llo[1], lhi[1])
                                for c in (llo[2], lhi[2])])
            w = corners @ world[s, :3, :3].T + world[s, :3, 3]
            lo, hi = np.maximum(lo, w.min(0)), np.minimum(hi, w.max(0))
            local = np.array(ft._CULL_SLOPE[t]) + rounding
            slope = np.maximum(slope, np.abs(world[s, :3, :3]) @ local)
        boxes.append(np.concatenate((lo, hi)))
    return np.array(boxes), slope


def local_box(type_code, pr):
    if type_code == 0:  # sphere
        r = abs(pr[0])
        return (-r, -r, -r), (r, r, r)
    if type_code == 3:  # cube
        return (pr[0], pr[2], pr[4]), (pr[1], pr[3], pr[5])
    if type_code == 4:  # cylinder
        r = abs(pr[0])
        return (-r, -r, pr[1]), (r, r, pr[2])
    if type_code == 2:  # plane
        return (-abs(pr[0]) / 2, -abs(pr[1]) / 2, 0.0), (abs(pr[0]) / 2, abs(pr[1]) / 2, 0.0)
    raise AssertionError(type_code)


def assert_sound(spec, params, p, v, skips=True):
    """Every tree with a positive candidate for a ray has a tight box, and
    a chunk box, the ray enters (the kernels' cone test, plain), all in the
    dtype of the rays ``p``, ``v``; with ``skips`` most trees' boxes are
    not entered."""
    dtype = p.dtype
    slots, aabb, cull = ft.wide_cull_tables(spec, params, dtype)
    offsets = ft.cull_offsets(spec)[0]
    groups = engine.wide_plan(spec)[1]
    plan = [info for kind, _, info in ft.wide_fold_plan(spec) if kind == "group"]
    rays = torch.stack((torch.cat((p, torch.ones_like(p[:1]))),
                        torch.cat((v, torch.zeros_like(v[:1])))))
    obj_tx, prim = ft.kernel_inputs(
        params, ft.rays_from_state(torch.zeros((13, 1), dtype=dtype)))[1:3]
    checked = 0
    for gi, ((template, types_pos, _), info) in enumerate(zip(groups, plan)):
        t_count, l_count, off, nc = info["T"], info["L"], info["off"], info["n_chunks"]
        slot_mat = slots[off:off + t_count * l_count].long().reshape(t_count, l_count)
        dist, _ = engine._wide_group_candidates(template, types_pos, slot_mat, prim,
                                                obj_tx.reshape(-1, 4, 4), rays)
        has = torch.isfinite(dist)
        row = offsets[gi]
        slope = cull[row, :3]
        trees = ft.cull_hit_plain(cull[row + 1 + nc:row + 1 + nc + t_count], slope, p, v)
        assert not (has & ~trees).any(), (has & ~trees).nonzero()[:5]
        if nc:
            chunks = ft.cull_hit_plain(cull[row + 1:row + 1 + nc], slope, p, v)
            of_tree = torch.arange(t_count) // ft.WIDE_CHUNK_TREES
            assert not (has & ~chunks[of_tree]).any()
        checked += int(has.sum())
        # the cull does skip: most trees a ray enters no box of
        assert trees.float().mean() < 0.5 or not skips
    return checked


@pytest.mark.parametrize("name", sorted(CULL_SCENES))
def test_tight_boxes_against_plain_and_inside_chunk_boxes(name):
    """(a) Each group's tight tree boxes equal a per-tree fold of the
    leaves' corner boxes, its chunk boxes are the unions of its 16 trees'
    boxes, and every tight box lies inside its JAX-equal chunk box; the
    packed table holds them padded as ``_box_hit`` pads."""
    build, _, _ = CULL_SCENES[name]
    scene = compiled(build)
    spec, params = scene.spec, scene.params
    slots, aabb = ft.wide_runtime_tables(spec, params, F64)
    tight = ft._wide_box_pass(spec, params, F64)[2]
    plan = [info for kind, _, info in ft.wide_fold_plan(spec) if kind == "group"]
    _, aabb2, cull = ft.wide_cull_tables(spec, params, F64)
    assert torch.equal(aabb, aabb2)
    offsets, rows = ft.cull_offsets(spec)
    assert cull.shape == (rows, 6)
    for gi, ((tree_box, chunk_box, slope), info) in enumerate(zip(tight, plan)):
        boxes, plain_slope = plain_tree_boxes(spec, params, slots, gi)
        np.testing.assert_allclose(tree_box.numpy(), boxes, rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(slope.numpy(), plain_slope, rtol=1e-12)
        t_count, nc = info["T"], info["n_chunks"]
        assert tree_box.shape == (t_count, 6) and chunk_box.shape == (nc, 6)
        if nc:
            chunk = torch.arange(t_count) // ft.WIDE_CHUNK_TREES
            loose = aabb[info["chunk_off"] + chunk]
            assert (tree_box[:, :3] >= loose[:, :3]).all()
            assert (tree_box[:, 3:] <= loose[:, 3:]).all()
            for c in range(nc):
                members = tree_box[chunk == c]
                torch.testing.assert_close(chunk_box[c, :3], members[:, :3].min(0).values)
                torch.testing.assert_close(chunk_box[c, 3:], members[:, 3:].max(0).values)
        row = offsets[gi]
        assert torch.equal(cull[row], torch.cat((slope, slope.new_zeros(3))))
        assert torch.equal(cull[row + 1:row + 1 + nc], ft._pad_box(chunk_box))
        assert torch.equal(cull[row + 1 + nc:row + 1 + nc + t_count], ft._pad_box(tree_box))
    # the wide program names each group's first row
    prog = ft.wide_program(spec)
    for gi in range(len(plan)):
        assert prog[prog[6] + ft._GROUP_WIDTH * gi + 6] == offsets[gi]


def test_lenslet_box_is_its_aperture():
    """A lenslet (a sphere of radius 2 intersected with a 0.25 mm thick
    cylinder of radius 0.5) gets its cylinder's box, not the 4 mm box of
    its sphere, and the array's slope is the cylinder's near-axial one
    plus the float64 rounding's 8 sqrt(eps)."""
    scene = compiled(lambda m: mla(m, 6))
    (tree_box, chunk_box, slope), = ft._wide_box_pass(scene.spec, scene.params, F64)[2]
    extent = tree_box[:, 3:] - tree_box[:, :3]
    torch.testing.assert_close(extent, torch.tensor([0.25, 1.0, 1.0], dtype=F64).expand_as(extent))
    rounding = 8.0 * torch.finfo(F64).eps ** 0.5
    torch.testing.assert_close(slope, torch.tensor([2e-8, 2e-4, 2e-4], dtype=F64) + rounding)


@pytest.mark.parametrize("name", sorted(CULL_SCENES))
def test_every_candidate_tree_has_a_box_the_ray_enters(name):
    """(b) Soundness on the arrays, the lens wall and the wide parity
    scenes: grid and random rays and their later generations."""
    build, grid, gens = CULL_SCENES[name]
    scene = compiled(build)
    p, v = scene_rays(scene.spec, scene.params, grid, gens, seed=sum(map(ord, name)))
    assert assert_sound(scene.spec, scene.params, p, v) > 50


FAR_SCENES = {
    "mla16": (lambda m: mla(m, 16), 8.0),
    "meniscus": (meniscus_wall, 6.6),
    "sphere_lenses": (sphere_lens_wall, 6.6),
}


@pytest.mark.parametrize("name", sorted(FAR_SCENES))
@pytest.mark.parametrize("dist", [1e3, 1e4])
def test_far_origins_float32_keep_their_candidates_inside_their_boxes(name, dist):
    """Soundness at float32 for origins 1e3 and 1e4 away, where a
    quadratic's roots lose half their digits: every positive candidate of
    the float32 plain engine lies in a float32 tight box the ray enters,
    which the rounding's slope (8 sqrt(eps) t) grows to hold.  A group of
    bare sphere lenses has no cylinder slope to hide behind.  At 1e4 the
    cones are 28 mm wide at the scene and hold every box."""
    build, half = FAR_SCENES[name]
    scene = compiled(build)
    p, v = far_rays(4000, dist, half, seed=int(dist) + len(name))
    p32, v32 = p.to(torch.float32), v.to(torch.float32)
    assert assert_sound(scene.spec, scene.params, p32, v32, skips=dist < 1e4) > 100


def test_cone_test_at_zero_slope_is_box_hit():
    """The plain cone test reduces to ``_box_hit`` on the padded box when
    the slope is zero, zero-direction conventions included."""
    rng = np.random.default_rng(4)
    corners = rng.uniform(-2, 2, (40, 2, 3))
    boxes = torch.as_tensor(np.concatenate((corners.min(1), corners.max(1)), 1))
    p = torch.as_tensor(rng.uniform(-3, 3, (3, 600)))
    v = torch.as_tensor(rng.standard_normal((3, 600)))
    v[1, :200] = 0.0
    v[2, 100:300] = -0.0
    p[0, :50] = boxes[0, 0]  # origins on a face
    got = ft.cull_hit_plain(ft._pad_box(boxes), torch.zeros(3, dtype=F64), p, v)
    want = torch.stack([ft._box_hit(b, p, v) for b in boxes])
    assert torch.equal(got, want)


def test_slope_catches_a_near_axial_ray_outside_the_cylinder():
    """A ray 9e-5 rad off a cylinder's axis whose origin lies on the axis
    far away: the intersector decides by the origin (``isclose0`` of
    d_x^2 + d_y^2 and of b) and reports a hit where the ray runs 0.9 mm off
    the axis, outside the cylinder's box; the box grown by the slope holds
    it, the bare box does not."""
    from pyrayt_tpu_torch.core import primitives as prim_mod

    box = torch.tensor([[-0.5, -0.5, -0.125, 0.5, 0.5, 0.125]], dtype=F64)
    p = torch.tensor([[0.0], [0.0], [-1e4]], dtype=F64)
    v = torch.tensor([[9e-5], [0.0], [1.0]], dtype=F64)
    params = [torch.tensor([x], dtype=F64) for x in (0.5, -0.125, 0.125)]
    pair = prim_mod.leaf_intersect(prim_mod.CYLINDER, torch.stack((p, v)), params)
    hit_t = float(torch.minimum(pair[0], pair[1]))
    assert math.isfinite(hit_t) and hit_t > 0
    assert hit_t * 9e-5 > 0.5  # the "hit" lies outside the box
    slope = torch.tensor(ft._CULL_SLOPE[prim_mod.CYLINDER], dtype=F64)
    assert not ft.cull_hit_plain(ft._pad_box(box), torch.zeros(3, dtype=F64), p, v).any()
    assert ft.cull_hit_plain(ft._pad_box(box), slope, p, v).all()


SHAPES = st.sampled_from(["sphere", "cylinder", "cube"])


def _solid(m, kind, size, aspect):
    if kind == "sphere":
        return m.Sphere(size)
    if kind == "cylinder":
        return m.Cylinder(radius=size, min_height=-size * aspect, max_height=size * aspect)
    return m.Cuboid((-size, -size * aspect, -size), (size, size * aspect, size))


@settings(max_examples=12, deadline=None)
@given(first=SHAPES, second=SHAPES, op=st.sampled_from(["intersect", "difference"]),
       sizes=st.tuples(st.floats(0.3, 1.5), st.floats(0.3, 1.5)),
       aspect=st.floats(0.2, 2.0), offset=st.floats(-0.8, 0.8), seed=st.integers(0, 2**16))
def test_random_trees_keep_their_candidates_inside_their_boxes(first, second, op, sizes, aspect,
                                                              offset, seed):
    """(c) 17 same-shape trees ``first op second`` (34 leaves: a wide
    group), each under its own random rotation and translation, the second
    leaf offset inside the tree: every positive candidate of random rays
    lies in a tight box the ray enters."""
    from pyrayt_tpu_torch.scene import csg
    from pyrayt_tpu_torch.scene.surfaces import Cuboid, Cylinder, Sphere

    ns = type("NS", (), dict(Sphere=Sphere, Cylinder=Cylinder, Cuboid=Cuboid))
    rng = np.random.default_rng(seed)

    def build(m):
        trees = []
        for k in range(17):
            a = _solid(ns, first, sizes[0], aspect)
            b = _solid(ns, second, sizes[1], aspect).move(offset, 0.5 * offset, -offset)
            tree = csg.intersect(a, b) if op == "intersect" else csg.difference(a, b)
            ax, ay, az = rng.uniform(-180, 180, 3)
            trees.append(tree.rotate_x(ax).rotate_y(ay).rotate_z(az)
                         .move(*(rng.uniform(-6, 6, 3) + np.array([0, 4.0 * (k % 4), 0]))))
        return trees

    scene = compiled(build)
    assert engine.wide_plan(scene.spec)[1], "the trees form one group"
    p_rays = random_rays(3000, (0.0, 6.0, 0.0), (9.0, 12.0, 9.0), seed)
    p, v = p_rays.positions[:3], p_rays.directions[:3]
    assert_sound(scene.spec, scene.params, p, v)


# ---------------------------------------------------------------------------
# F1: the gradient's dispatch past the table reduce's limits
# ---------------------------------------------------------------------------


class _Spec:
    """A stand-in for a wide spec past the reduce's limits: only the leaf
    count and the fold plan, which ``reduce_takes`` reads; building such a
    scene would take minutes."""

    def __init__(self, n_leaves, groups, single_leaves):
        self.n_leaves = n_leaves
        self.plan = tuple(("group", gi, {"T": t, "L": l}) for gi, (t, l) in enumerate(groups)) + (
            ("single", 0, {"slots": tuple(range(single_leaves))}),)


@pytest.fixture()
def fake_plans(monkeypatch):
    real = ft.wide_fold_plan
    monkeypatch.setattr(ft, "wide_fold_plan",
                        lambda spec: spec.plan if isinstance(spec, _Spec) else real(spec))
    real_wide = ft.supports_fused_wide
    monkeypatch.setattr(ft, "supports_fused_wide",
                        lambda spec: True if isinstance(spec, _Spec) else real_wide(spec))


@pytest.mark.parametrize("route", [None, "staged", "fused"])
def test_reduce_takes_past_its_limits(fake_plans, route):
    """Past 51,200 reduce rows, or past 2**31 - 1 entries on K8's route
    (generations x rays), the reduce does not take the scene and the
    gradient's dispatch picks the plain engine, while the trace's keeps
    K2; ``use_fused=True`` raises there."""
    gens = 4
    config = TraceConfig(generation_limit=gens, wide_grad=route)
    big = _Spec(2 * 25_601 + 1, [(25_601, 2)], 1)  # 51,202 group leaves
    small = _Spec(513, [(256, 2)], 1)
    assert fg.MAX_REDUCE_ROWS == 51200 and fg.MAX_REDUCE_ENTRIES == 2**31 - 1
    assert not fg.reduce_takes(big, config, 1024)
    assert fg.reduce_takes(small, config, 1 << 20)
    many_rays = 2**31 // gens + 1  # generations x rays past 2**31 - 1
    assert fg.reduce_takes(small, config, many_rays) == (route != "fused")
    for spec, n, takes in ((big, 1024, False), (small, many_rays, route != "fused"),
                           (small, 1 << 20, True)):
        assert ft.pick_fused(spec, config, "cuda")
        assert fg.pick_fused_grad(spec, config, "cuda", n) == takes
        assert not fg.pick_fused_grad(spec, config, "cpu", n)
    with pytest.raises(ValueError, match="51200"):
        fg.pick_fused_grad(big, TraceConfig(use_fused=True, wide_grad=route), "cuda", 1024)


@pytest.mark.parametrize("route", ["staged", "fused"])
def test_reduce_takes_the_16x16_array(route):
    """The 16x16 microlens array (513 leaves) at 2**20 rays stays on the
    kernels on both routes; a narrow scene has no reduce."""
    scene = compiled(lambda m: mla(m, 16))
    config = TraceConfig(generation_limit=4, wide_grad=route)
    assert fg.reduce_takes(scene.spec, config, 1 << 20)
    assert fg.pick_fused_grad(scene.spec, config, "cuda", 1 << 20)
    narrow = compiled(lambda m: [m.comp.thick_lens(1.0, -1.0, 0.25, aperture=0.5)])
    assert fg.reduce_takes(narrow.spec, config, 1 << 40)


@pytest.mark.parametrize("route", ["staged", "fused"])
def test_build_objective_past_the_limits_runs_the_plain_engine(monkeypatch, route):
    """``build_objective`` sends a scene the reduce does not take to the
    plain engine (the kernels' Functions are never built), and a scene it
    takes to the kernels' route (here on the CPU, where the wrappers run
    their plain versions, by patching ``pick_fused``)."""
    from pyrayt_tpu_torch.analysis import build_objective, metrics

    monkeypatch.setattr(ft, "pick_fused", lambda spec, config, device: True)
    built = []
    for name in ("build_fused_value_and_grad_fn", "build_fused_vjp_trace_fn"):
        real = getattr(fg, name)
        monkeypatch.setattr(fg, name,
                            lambda *a, real=real, name=name: built.append(name) or real(*a))
    rays = interop.rays_from_numpy(*grid_rays(4.2, 4.2, -1.0, 64), device="cpu", dtype=F64)

    def build_fn(r):
        return mla(TORCH_NS, 5, r=r)

    with TORCH_NS.fresh_ids():
        sid = float(TORCH_NS.compile(build_fn(2.0), device="cpu").spec.leaf_ids[-1])
    config = TraceConfig(generation_limit=4, wide_grad=route)
    grads = {}
    for limit in (fg.MAX_REDUCE_ROWS, 10):  # 50 leaves: past a limit of 10 rows
        monkeypatch.setattr(fg, "MAX_REDUCE_ROWS", limit)
        built.clear()
        objective = build_objective(build_fn, rays, metrics.RmsSpotRadius(sid), config)
        r = torch.tensor(2.0, dtype=F64, requires_grad=True)
        (grads[limit],) = torch.autograd.grad(objective(r), r)
        assert built == ([] if limit == 10 else ["build_fused_value_and_grad_fn"])
    torch.testing.assert_close(grads[10], grads[fg.MAX_REDUCE_ROWS], rtol=1e-8, atol=1e-12)

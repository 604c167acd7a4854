"""A microlens grid compiled as one record (scene/lenslets.py) against the
same lenslets built as objects, one CSG object per lenslet, and compiled
leaf by leaf (float32 and float64, CPU).

Held here: the ``SceneSpec`` equal field by field; ``world``, ``prim`` and
``glass`` bit-identical (the signs of zeros too); the vector-Jacobian
product of a fixed weighted sum of ``world`` and ``prim`` with respect to
the radii and the detector's move bit-identical; the handles' list
behaviour, ids, moves and groups; and the counters of the two paths.
"""

import numpy as np
import pytest
import torch

import pyrayt_tpu_torch.components as comp
import pyrayt_tpu_torch.materials as matl
from pyrayt_tpu_torch import pin
from pyrayt_tpu_torch.scene import ObjectGroup, fresh_ids
from pyrayt_tpu_torch.scene.compile import compile_scene
from pyrayt_tpu_torch.scene.lenslets import Lenslet

THICKNESS, PITCH, FOCUS = 0.25, 1.0, 4.0
OPTICS = {"default": {}, "explicit": {"aperture": (0.9, 0.8), "material": matl.glass["SF2"]},
          "elliptical": {"aperture": (-0.9, -0.6)}}
GRIDS = {"16x16": (16, 16), "5x4": (5, 4)}


def objects_array(r, thickness, nx, ny, pitch, aperture=None, material=None):
    """``microlens_array``'s lenslets forced onto the per-object path: each
    handle's objects (``Lenslet.materialise``)."""
    lenslets = comp.microlens_array(r, thickness, nx, ny, pitch, aperture, material)
    return [lens.materialise() for lens in lenslets]


def loop_array(r, thickness, nx, ny, pitch, aperture=None, material=None):
    """The array as one loop of the builders makes it, lenslet by lenslet:
    ``plano_convex_lens``'s solid, its sphere at the offsets computed in
    one op for a traced tensor, rotated and moved to its place."""
    material = matl.glass["ideal"] if material is None else material
    aperture = pitch if aperture is None else aperture
    sphere_z = -(r - thickness / 2) if isinstance(r, torch.Tensor) and r.requires_grad else None
    lenslets = []
    for iy in range(ny):
        for iz in range(nx):
            i = iy * nx + iz
            r_i = r[i] if np.ndim(r) else r
            if sphere_z is None:
                z_i = -(r_i - thickness / 2)
            else:
                z_i = sphere_z[i] if np.ndim(r) else sphere_z
            lens = comp._plano_convex(r_i, thickness, z_i, aperture, material)
            lenslets.append(lens.rotate_y(90).rotate_x(90).move_y((iy - (ny - 1) / 2.0) * pitch)
                            .move_z((iz - (nx - 1) / 2.0) * pitch))
    return lenslets


def radii_of(kind, n, dtype):
    values = 2.0 + 0.2 * np.random.default_rng(n).standard_normal(n)
    if kind == "traced":
        return torch.tensor(values, dtype=dtype, requires_grad=True)
    if kind == "numpy":
        return values.astype(np.float32 if dtype == torch.float32 else np.float64)
    if kind == "shared":
        return torch.tensor(2.1, dtype=dtype, requires_grad=True)
    return 2.1


def scene(array, kind, grid, optics, dtype):
    """The array and a detector moved by a traced ``det_x``: ``(compiled,
    (radii, det_x))``."""
    ny, nx = GRIDS[grid]
    radii = radii_of(kind, nx * ny, dtype)
    det_x = torch.tensor(FOCUS, dtype=dtype, requires_grad=True)
    with fresh_ids():
        parts = array(radii, THICKNESS, nx, ny, PITCH, **OPTICS[optics])
        parts = parts + [comp.baffle((2.0 * ny, 2.0 * nx)).move_x(det_x)]
        return compile_scene(parts, device="cpu", dtype=dtype), (radii, det_x)


def assert_bits(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    assert torch.equal(a, b) and torch.equal(torch.signbit(a), torch.signbit(b))


def assert_same_scene(got, want):
    for field in ("leaf_types", "leaf_ids", "leaf_normal_scale", "leaf_mat_slot", "mat_kinds",
                  "mat_packed", "trees"):
        assert getattr(got.spec, field) == getattr(want.spec, field), field
    assert got.spec == want.spec
    for key in ("world", "prim", "glass"):
        assert_bits(got.params[key].detach(), want.params[key].detach())


def weighted_vjp(compiled, inputs):
    """d/d inputs of a fixed weighted sum of ``world`` and ``prim``."""
    params = compiled.params
    gen = torch.Generator().manual_seed(7)
    weights = [torch.randn(params[k].shape, generator=gen, dtype=params[k].dtype)
               for k in ("world", "prim")]
    total = (params["world"] * weights[0]).sum() + (params["prim"] * weights[1]).sum()
    inputs = [x for x in inputs if isinstance(x, torch.Tensor) and x.requires_grad]
    return torch.autograd.grad(total, inputs)


@pytest.mark.parametrize("optics", list(OPTICS))
@pytest.mark.parametrize("grid", list(GRIDS))
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("kind", ["traced", "numpy", "shared", "float"])
def test_grid_compiles_as_its_objects(kind, dtype, grid, optics):
    """The grid against its handles' objects, and those against the loop
    of builders."""
    scenes = [scene(array, kind, grid, optics, dtype)
              for array in (comp.microlens_array, objects_array, loop_array)]
    grads = [weighted_vjp(*s) for s in scenes]
    assert len(grads[0]) == (2 if kind in ("traced", "shared") else 1)
    for (got, _), (want, _) in zip(scenes, scenes[1:]):
        assert_same_scene(got, want)
    for got, want in zip(grads, grads[1:]):
        for g, w in zip(got, want):
            assert_bits(g, w)
            assert bool((g != 0).all())


@pytest.mark.parametrize("kind", ["float", "traced"])
def test_handles_behave_as_a_list(kind):
    """Indexing, unpacking and concatenation; the whole list, a slice and
    the list reversed compile as the same lenslets' objects do."""
    radii = radii_of(kind, 12, torch.float64)
    with fresh_ids():
        lenslets = comp.microlens_array(radii, THICKNESS, 4, 3, PITCH)
        detector = comp.baffle((8.0, 8.0)).move_x(FOCUS)
    assert type(lenslets) is list and len(lenslets) == 12
    assert all(type(h) is Lenslet for h in lenslets)
    assert lenslets[5].index == 5 and lenslets[-1].index == 11
    first, *rest = lenslets
    assert first is lenslets[0] and len(rest) == 11
    assert [h.index for h in lenslets[2:4]] == [2, 3]
    system = lenslets + [detector]
    assert system[-1] is detector and system[:12] == lenslets
    assert not hasattr(lenslets[0], "__iter__")
    with fresh_ids():
        objects = loop_array(radii, THICKNESS, 4, 3, PITCH)
        detector2 = comp.baffle((8.0, 8.0)).move_x(FOCUS)
    for a, b in (([*lenslets, detector], [*objects, detector2]),
                 (lenslets[3:7], objects[3:7]), (lenslets[::-1], objects[::-1])):
        got = compile_scene(a, device="cpu", dtype=torch.float64)
        want = compile_scene(b, device="cpu", dtype=torch.float64)
        assert_same_scene(got, want)
        if kind == "traced":
            for g, w in zip(weighted_vjp(got, [radii]), weighted_vjp(want, [radii])):
                assert_bits(g, w)
    assert all(h._lens is None for h in lenslets)


def test_ids_are_those_the_objects_take():
    """Under ``fresh_ids`` a handle's id is its CSG object's, its leaves
    carry the objects' ids, and the next object drawn after the array gets
    the same id either way."""
    with fresh_ids():
        lenslets = comp.microlens_array(2.0, THICKNESS, 5, 4, PITCH)
        after = comp.baffle((1.0, 1.0)).get_id()
    with fresh_ids():
        objects = loop_array(2.0, THICKNESS, 5, 4, PITCH)
        after_objects = comp.baffle((1.0, 1.0)).get_id()
    assert [h.get_id() for h in lenslets] == [o.get_id() for o in objects]
    assert after == after_objects == 60
    assert all(h._lens is None for h in lenslets)  # get_id built nothing
    built = lenslets[7].materialise()
    assert built.get_id() == lenslets[7].get_id()
    assert [s for s, _ in built.surface_ids] == [s for s, _ in objects[7].surface_ids]


@pytest.mark.parametrize("kind", ["traced", "float"])
def test_a_lenslet_moved_after_the_build(kind):
    """One lenslet moved after the build compiles on the per-object path,
    the rest with the grid; the scene is the objects' with the same move."""
    def build(array):
        radii = radii_of(kind, 20, torch.float64)
        with fresh_ids():
            parts = array(radii, THICKNESS, 5, 4, PITCH)
            parts[6].move_x(0.3).rotate_z(2.0)
            parts = parts + [comp.baffle((8.0, 10.0)).move_x(FOCUS)]
            return compile_scene(parts, device="cpu", dtype=torch.float64), radii

    grid_before = compile_scene.grid_leaves, compile_scene.object_leaves
    got, got_radii = build(comp.microlens_array)
    counts = (compile_scene.grid_leaves - grid_before[0],
              compile_scene.object_leaves - grid_before[1])
    assert counts == (38, 3)
    want, want_radii = build(loop_array)
    assert_same_scene(got, want)
    if kind == "traced":
        for g, w in zip(weighted_vjp(got, [got_radii]), weighted_vjp(want, [want_radii])):
            assert_bits(g, w)


def test_a_group_of_handles_moved_as_a_whole():
    def build(array):
        with fresh_ids():
            parts = array(2.0, THICKNESS, 5, 4, PITCH)
            group = ObjectGroup(parts[:6]).move_z(0.2).rotate_x(3.0)
            return [group, *parts[6:], comp.baffle((8.0, 10.0)).move_x(FOCUS)]

    before = compile_scene.grid_leaves, compile_scene.object_leaves
    got = compile_scene(build(comp.microlens_array), device="cpu", dtype=torch.float64)
    assert (compile_scene.grid_leaves - before[0], compile_scene.object_leaves - before[1]) == (
        28, 13)
    want = compile_scene(build(loop_array), device="cpu", dtype=torch.float64)
    assert_same_scene(got, want)


def test_an_unmoved_group_and_read_lenslets_stay_on_the_grid():
    """Reading a lenslet (its surfaces, its pose) builds its objects but
    leaves it on the grid; a pinned move, a material or flipped normals
    take it off."""
    with fresh_ids():
        parts = comp.microlens_array(2.0, THICKNESS, 5, 4, PITCH)
        group = ObjectGroup(parts[:3])
    parts[4].surface_ids, parts[5].get_world_transform(), parts[6].bounding_box
    assert all(parts[i]._lens is not None for i in (4, 5, 6))
    before = compile_scene.grid_leaves
    compile_scene([group, *parts[3:]], device="cpu", dtype=torch.float64)
    assert compile_scene.grid_leaves - before == 40
    with pin(parts[8]):
        parts[8].move_y(1.0)
    parts[9].l_child.material = matl.glass["BK7"]
    parts[10].invert_normals()
    assert [parts[i].on_grid() for i in (7, 8, 9, 10)] == [True, False, False, False]


def doublet():
    l1 = comp.thick_lens(30.47, -30.47, 8.0, aperture=25.4, material=matl.glass["BK7"])
    l2 = comp.thick_lens(-30.47, -104.7, 2.0, aperture=25.4, material=matl.glass["SF2"])
    return [l1, l2.move_x(5.05), comp.baffle((25.4, 25.4)).move_x(50.0)]


@pytest.mark.parametrize("name, counts", [("mla16", (512, 1)), ("doublet", (0, 7))])
def test_counters(name, counts):
    with fresh_ids():
        if name == "mla16":
            radii = torch.full((256,), 2.0, dtype=torch.float32, requires_grad=True)
            parts = comp.microlens_array(radii, THICKNESS, 16, 16, PITCH)
            parts = parts + [comp.baffle((32.0, 32.0)).move_x(FOCUS)]
        else:
            parts = doublet()
    for _ in range(2):
        before = compile_scene.grid_leaves, compile_scene.object_leaves
        compile_scene(parts, device="cpu")
        assert (compile_scene.grid_leaves - before[0],
                compile_scene.object_leaves - before[1]) == counts

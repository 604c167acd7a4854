"""Port parity of the scene layer: builders, compile_scene, materials and
sources against the JAX package (float64)."""

import dataclasses

import numpy as np
import pytest
import torch

import pyrayt_tpu.components as j_comp
import pyrayt_tpu.materials as j_matl
import pyrayt_tpu_torch.components as t_comp
import pyrayt_tpu_torch.materials as t_matl
from pyrayt_tpu.scene import fresh_ids as j_fresh
from pyrayt_tpu.scene.compile import compile_scene as j_compile
from pyrayt_tpu_torch.scene import _backend
from pyrayt_tpu_torch.scene import fresh_ids as t_fresh
from pyrayt_tpu_torch.scene.compile import compile_scene as t_compile
from pyrayt_tpu_torch.scene.surfaces import Sphere


def assert_same_compiled(j_scene, t_scene):
    assert dataclasses.astuple(t_scene.spec) == dataclasses.astuple(j_scene.spec)
    for name in ("world", "prim", "glass"):
        np.testing.assert_allclose(
            t_scene.params[name].numpy(), np.asarray(j_scene.params[name]), rtol=0, atol=1e-12
        )
    assert [type(m).__name__ for m in t_scene.materials] == [
        type(m).__name__ for m in j_scene.materials
    ]


@pytest.mark.parametrize(
    "name", ["condenser", "all_primitives", "prism_tir", "mirrors", "union"]
)
def test_compile_scene_matches_jax(twins, name):
    j_scene, t_scene = twins.scene(name)
    assert_same_compiled(j_scene, t_scene)
    assert t_scene.params["world"].dtype == torch.float64


def _zoo(comp, matl):
    return [
        comp.biconvex_lens(2, 2, 0.25, aperture=1),
        comp.plano_convex_lens(1.5, 0.3, aperture=(0.8, 0.6)),
        comp.thick_lens(np.inf, -2.0, 0.2, aperture=(-0.8, -0.4), material=matl.glass["SF5"]),
        comp.elliptical_mirror(2.0, 1.0, 0.1),
        comp.spherical_mirror(-3.0, 0.1, aperture=0.6, off_axis=(0.1, 0.05)),
        comp.aperture((2.0, 2.0), 0.5).move_x(3.0),
        *comp.microlens_array(1.0, 0.2, 2, 2, 0.5, material=matl.glass["SF2"]),
    ]


def test_component_zoo_compiles_identically():
    with j_fresh():
        j_scene = j_compile(_zoo(j_comp, j_matl))
    with t_fresh():
        t_scene = t_compile(_zoo(t_comp, t_matl), device="cpu", dtype=torch.float64)
    assert_same_compiled(j_scene, t_scene)


@pytest.mark.parametrize(
    "make",
    [
        lambda c: c.LineOfRays(0.7, wavelength=0.5).move_x(-1).rotate_z(10),
        lambda c: c.GridOfRays(1.0, 0.5).move_y(0.3),
        lambda c: c.CircleOfRays(0.8).rotate_y(20),
        lambda c: c.ConeOfRays(12.0).move_x(-0.5),
        lambda c: c.WedgeOfRays(30.0).move_z(0.2),
    ],
)
def test_sources_match_jax(make):
    j = make(j_comp).generate_rays(23)
    t = make(t_comp).generate_rays(23, device="cpu", dtype=torch.float64)
    np.testing.assert_allclose(t.to_numpy(), j.to_numpy(), rtol=1e-12, atol=1e-12)


def test_lamp_is_seeded_and_lambertian():
    a, b = (t_comp.Lamp(1.0, 2.0, max_angle=60, seed=3).generate_rays(
        20000, device="cpu", dtype=torch.float64) for _ in range(2))
    np.testing.assert_array_equal(a.to_numpy(), b.to_numpy())
    cos_t = a.directions[0].numpy()
    assert cos_t.min() >= np.cos(np.pi / 3) - 1e-12
    # cos(theta) is uniform on [cos(max), 1]: mean (1 + 0.5) / 2
    assert abs(cos_t.mean() - 0.75) < 0.01
    np.testing.assert_allclose(a.intensity.numpy(), 100 * cos_t)
    assert abs(a.positions[1].numpy().std() - 1.0 / np.sqrt(12)) < 0.01
    lamp = t_comp.StaticLamp(1.0, 1.0, seed=1)
    assert lamp.generate_rays(8, "cpu") is lamp.generate_rays(8, "cpu")


def test_materials_match_jax():
    for name in ("ideal", "BK7", "SF5", "SF2"):
        tg, jg = t_matl.glass[name], j_matl.glass[name]
        np.testing.assert_allclose(tg.glass_coeffs(), np.asarray(jg.glass_coeffs()), atol=0)
        wl = np.array([0.45, 0.55, 0.633])
        np.testing.assert_allclose(
            tg.index_at(torch.as_tensor(wl)).numpy(), np.asarray(jg.index_at(wl)), rtol=1e-12
        )
        assert tg.abbe() == pytest.approx(jg.abbe(), rel=1e-12)
    coeffs = (1, 2, 3, 4, 5, 6)
    assert t_matl.SellmeierRefractor(*coeffs) == t_matl.SellmeierRefractor(*coeffs)
    assert t_matl.BasicRefractor(1.5) != t_matl.BasicRefractor(1.6)


def test_traced_values_are_refused():
    """Traced values (tensors that require grad) are no longer refused: a
    rebuild carries their gradient into the scene params, and a traced
    radius without a stated sign is still refused, with the JAX text."""
    r = torch.tensor(1.0, dtype=torch.float64, requires_grad=True)
    assert _backend.is_traced(r) and _backend.is_traced((0.0, r))
    assert not _backend.is_traced(torch.tensor(1.0), 1.0)
    assert _backend.xp_for(1.0, r) is torch and _backend.xp_for(1.0, torch.tensor(1.0)) is np
    sphere = Sphere(r).move_x(2 * r)
    compiled = t_compile([sphere], device="cpu", dtype=torch.float64)
    (compiled.params["prim"][0, 0] + compiled.params["world"][0, 0, 3]).backward()
    assert float(r.grad) == 3.0
    with pytest.raises(ValueError, match="r1_sign"):
        t_comp.thick_lens(r, -r, 0.1)


def test_traced_rebuild_matches_plain_build():
    """The same scene built from traced and from plain values: equal
    SceneSpec and params, and the traced params reach theta."""

    def build(r, t):
        lens = t_comp.thick_lens(
            r, -r, t, aperture=0.8, material=t_matl.glass["BK7"], r1_sign=1, r2_sign=-1
        )
        mirror = t_comp.spherical_mirror(2 * r, t, aperture=0.5, radius_sign=1).move_x(3.0)
        box = t_comp.Cuboid.from_sides(t, 2 * t, 0.5).rotate_z(10 * r).move_y(t)
        return [lens, mirror, box, t_comp.baffle((3.0, 3.0)).move_x(2.0 + r)]

    theta = torch.tensor([1.7, 0.2], dtype=torch.float64, requires_grad=True)
    with t_fresh():
        traced = t_compile(build(theta[0], theta[1]), device="cpu", dtype=torch.float64)
    with t_fresh():
        plain = t_compile(build(1.7, 0.2), device="cpu", dtype=torch.float64)
    assert traced.spec == plain.spec
    for name in ("world", "prim", "glass"):
        torch.testing.assert_close(
            traced.params[name].detach(), plain.params[name], rtol=1e-14, atol=1e-14
        )
    assert traced.params["world"].grad_fn is not None
    grads = torch.autograd.grad(
        traced.params["world"].sum() + traced.params["prim"].sum(), theta
    )[0]
    assert torch.isfinite(grads).all() and (grads != 0).all()


def test_eager_intersect_and_normals_match_jax():
    def build(comp, matl):
        return comp.thick_lens(1.0, -1.0, 0.25, aperture=0.5, material=matl.glass["BK7"])

    with j_fresh():
        jl = build(j_comp, j_matl)
    with t_fresh():
        tl = build(t_comp, t_matl)
    rays = np.zeros((2, 4, 5))
    rays[0, 0] = -1.0
    rays[0, 1] = np.linspace(-0.2, 0.2, 5)
    rays[0, 3] = 1.0
    rays[1, 0] = 1.0
    th, ti = tl.intersect(torch.as_tensor(rays))
    jh, ji = jl.intersect(rays)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=1e-12, atol=1e-12)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    leaf = tl.l_child.r_child  # the first sphere
    pts = np.array([[-0.125, 0.0, 0.0, 1.0]]).T
    np.testing.assert_allclose(
        leaf.get_world_normals(torch.as_tensor(pts)).numpy(),
        np.asarray(jl.l_child.r_child.get_world_normals(pts)),
        atol=1e-12,
    )

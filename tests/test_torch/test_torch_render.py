"""The port's viewport renderers (``pyrayt_tpu_torch.render``) against the
JAX package's on the same scenes, float64, CPU.

The camera's pixel rays, the edge image and the Gooch-shaded image must
agree with ``pyrayt_tpu.render``'s: the edge image exactly (surface ids
from the same nearest-hit search), the shaded image to 1e-9 (normals
through the two packages' transforms in another order).  The Gooch
material's limiting colors are the cases of tests/test_render/test_render.py.
"""

import matplotlib

matplotlib.use("Agg")

import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import pyrayt_tpu as j_pyrayt  # noqa: E402
import pyrayt_tpu.render as j_render  # noqa: E402
import pyrayt_tpu_torch as t_pyrayt  # noqa: E402
import pyrayt_tpu_torch.render as t_render  # noqa: E402
from pyrayt_tpu.scene import fresh_ids as j_fresh_ids  # noqa: E402
from pyrayt_tpu.scene.surfaces import Sphere as j_Sphere  # noqa: E402
from pyrayt_tpu_torch.scene import fresh_ids as t_fresh_ids  # noqa: E402
from pyrayt_tpu_torch.scene.surfaces import Sphere as t_Sphere  # noqa: E402

CPU = dict(device="cpu", dtype=torch.float64)
SHADE_TOL = 1e-9


def spheres(Sphere, render):
    """Two overlapping Gooch-shaded unit spheres in front of the camera."""
    matl = render.GoochMaterial(base_color=render.color.RED, warm_color=render.color.ORANGE,
                                cool_color=render.color.BLUE)
    return (Sphere(1, material=matl).move_x(3).move_y(0.5),
            Sphere(1, material=matl).move_x(3).move_y(-0.5))


def twin_spheres():
    with j_fresh_ids():
        j_shapes = spheres(j_Sphere, j_render)
    with t_fresh_ids():
        t_shapes = spheres(t_Sphere, t_render)
    return j_shapes, t_shapes


def lens_and_detector(pkg):
    lens = pkg.components.thick_lens(r1=1, r2=-1, thickness=0.25, aperture=0.5,
                                     material=pkg.materials.glass["ideal"])
    return [lens, pkg.components.baffle((1, 1)).move_x(1)]


@pytest.mark.parametrize("turn", [None, "y", "zy"])
def test_camera_rays_match_jax(turn):
    cameras = [pkg.OrthographicCamera(10, 1, 0.5) for pkg in (j_render, t_render)]
    for camera in cameras:
        if turn == "y":
            camera.rotate_y(90)
        elif turn == "zy":
            camera.rotate_y(90).rotate_z(90).move(0.2, -0.3, 1.5)
    j_rays = np.asarray(cameras[0].generate_rays())
    t_rays = cameras[1].generate_rays(**CPU)
    assert t_rays.shape == (2, 4, 50) and t_rays.dtype == torch.float64
    np.testing.assert_allclose(t_rays.numpy(), j_rays, rtol=1e-12, atol=1e-12)
    assert cameras[1].get_resolution() == (10, 5) and cameras[1].get_span() == (1.0, 0.5)


def test_edge_render_matches_jax():
    j_shapes, t_shapes = twin_spheres()
    j_image = j_render.EdgeRender(j_render.OrthographicCamera(40, 10, 1), j_shapes).render()
    t_image = t_render.EdgeRender(t_render.OrthographicCamera(40, 10, 1), t_shapes,
                                  **CPU).render()
    assert t_image.shape == (40, 40, 4)
    np.testing.assert_array_equal(t_image, j_image)
    assert 0 < t_image[..., 3].sum() < t_image[..., 3].size  # some edges, not all


def test_shaded_render_matches_jax():
    j_shapes, t_shapes = twin_spheres()
    light = (0, 10, 10, 1)
    j_image = j_render.ShadedRenderer(j_render.OrthographicCamera(40, 10, 1), j_shapes,
                                      light_position=light).render()
    t_image = t_render.ShadedRenderer(t_render.OrthographicCamera(40, 10, 1), t_shapes,
                                      light_position=light, **CPU).render()
    assert t_image.shape == (40, 40, 4)
    np.testing.assert_allclose(t_image, j_image, rtol=SHADE_TOL, atol=SHADE_TOL)
    assert np.abs(t_image).sum() > 0


def test_surface_and_material_shade_match_jax():
    """TracerSurface.shade (Gooch material) and TracableMaterial.shade (its
    render material, black without one) at the pixels a camera hits."""
    with j_fresh_ids():
        j_lens = lens_and_detector(j_pyrayt)[0]
    with t_fresh_ids():
        t_lens = lens_and_detector(t_pyrayt)[0]
    rays = np.asarray(j_render.OrthographicCamera(20, 0.6, 1).move_x(-2).generate_rays())
    distances = np.full(rays.shape[-1], 1.5)
    light = np.array((0.0, 3.0, 3.0, 1.0))
    for j_leaf, t_leaf in zip([s for _, s in j_lens.surface_ids],
                              [s for _, s in t_lens.surface_ids]):
        np.testing.assert_allclose(t_leaf.shade(rays, distances, light_positions=light),
                                   np.asarray(j_leaf.shade(rays, distances, light_positions=light)),
                                   rtol=SHADE_TOL, atol=SHADE_TOL)
    normals = np.zeros((4, rays.shape[-1]))
    normals[2] = 1.0
    for base in (None, t_render.gooch.RED):
        t_glass = t_pyrayt.materials.glass["BK7"]
        t_glass._base_material = base
        j_glass = j_pyrayt.materials.glass["BK7"]
        j_glass._base_material = None if base is None else j_render.gooch.RED
        try:
            np.testing.assert_allclose(t_glass.shade(rays, normals, light),
                                       j_glass.shade(rays, normals, light), rtol=1e-12)
        finally:
            t_glass._base_material = j_glass._base_material = None


@pytest.mark.parametrize("view, shaded", [("xy", True), ("xz", False)])
def test_draw_matches_jax(view, shaded):
    images = []
    for pkg, fresh_ids, kw in ((j_pyrayt, j_fresh_ids, {}), (t_pyrayt, t_fresh_ids, CPU)):
        with fresh_ids():
            parts = lens_and_detector(pkg)
        fig, axis = plt.subplots()
        render = j_render if pkg is j_pyrayt else t_render
        render.draw(parts, view=view, axis=axis, shaded=shaded, resolution=48, **kw)
        images.append((np.asarray(axis.images[0].get_array()), axis.images[0].get_extent()))
        plt.close(fig)
    (j_image, j_extent), (t_image, t_extent) = images
    np.testing.assert_allclose(t_image, j_image, rtol=SHADE_TOL, atol=SHADE_TOL)
    np.testing.assert_allclose(t_extent, j_extent, rtol=1e-12)
    with pytest.raises(ValueError, match="view"):
        t_render.draw(lens_and_detector(t_pyrayt), view="yz", **CPU)


def test_show_draws_the_parts_and_the_rays():
    with t_fresh_ids():
        parts = lens_and_detector(t_pyrayt)
    tracer = t_pyrayt.RayTracer(t_pyrayt.components.LineOfRays(0.4).move_x(-0.5), parts,
                                rays_per_source=5, generation_limit=4, **CPU)
    tracer.trace()
    fig, axis = plt.subplots()
    tracer.show(axis=axis, resolution=64, color_function="wavelength", shaded=True)
    assert len(axis.images) == 1 and len(axis.collections) == 1
    assert len(axis.collections[0].get_offsets()) == len(tracer.get_results())
    plt.close(fig)


class TestGoochMaterial:
    """tests/test_render/test_render.py's limiting colors on the port's
    material."""

    @pytest.fixture()
    def material(self):
        return t_render.GoochMaterial(base_color=t_render.color.WHITE,
                                      warm_color=t_render.color.YELLOW,
                                      cool_color=t_render.color.BLUE, alpha=0, beta=0)

    def test_single_light_source(self, material):
        light = np.array((0.0, 0.0, 10.0, 1.0))
        normals = np.zeros((4, 10))
        normals[2] = 1
        normals[2, :5] = -1
        rays = np.zeros((2, 4, 10))
        rays[0, 3] = 1
        pixel_values = material.shade(rays, normals, light)
        assert np.allclose(pixel_values[:, :5], np.atleast_2d(t_render.color.BLUE).T)
        assert np.allclose(pixel_values[:, 5:], np.atleast_2d(t_render.color.YELLOW).T)

    def test_single_ray_case(self, material):
        light = np.array((0.0, 0.0, 10.0, 1.0))
        ray = np.zeros((2, 4, 1))
        ray[0, 3] = 1
        ray[1, 0] = 1
        for normal, expected in (((0.0, 0.0, 1.0, 0.0), t_render.color.YELLOW),
                                 ((0.0, 0.0, -1.0, 0.0), t_render.color.BLUE),
                                 ((0.0, 1.0, 0.0, 0.0), t_render.color.RGBAColor(0.5, 0.5, 0.5))):
            pixel_values = material.shade(ray, np.array(normal), light)
            assert pixel_values.shape == (4, 1)
            assert np.allclose(pixel_values, np.atleast_2d(expected).T)


def test_renderers_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with t_fresh_ids():
        _, shapes = twin_spheres()
    with pytest.raises(RuntimeError, match="CUDA"):
        t_render.EdgeRender(t_render.OrthographicCamera(10, 10, 1), shapes)
    with pytest.raises(RuntimeError, match="CUDA"):
        t_render.OrthographicCamera(10, 10, 1).generate_rays()

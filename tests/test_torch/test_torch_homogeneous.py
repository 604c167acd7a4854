"""The port's homogeneous-coordinate helpers (``pyrayt_tpu_torch.core.homogeneous``)
against the JAX package's (both NumPy, exact), and a hand-built bundle
traced through the port."""

import numpy as np
import pytest
import torch

import pyrayt_tpu as j_pyrayt
import pyrayt_tpu_torch as t_pyrayt
from pyrayt_tpu_torch import interop
from pyrayt_tpu_torch.core import homogeneous as t_h

NAMES = ("HomogeneousCoordinate", "Point", "Vector", "Ray", "bundle_of_rays", "bundle_rays")


def test_names_are_exported_like_jax():
    assert set(NAMES) <= set(t_pyrayt.__all__) and set(NAMES) <= set(j_pyrayt.__all__)
    assert tuple(t_h.__all__) == NAMES
    for name in NAMES:
        assert getattr(t_pyrayt, name) is getattr(t_h, name)


@pytest.mark.parametrize("name", ["HomogeneousCoordinate", "Point", "Vector"])
def test_coordinates_match_jax(name):
    args = (0.3, -1.5, 2.0, 0.7)
    t_c, j_c = getattr(t_pyrayt, name)(*args), getattr(j_pyrayt, name)(*args)
    np.testing.assert_array_equal(t_c, j_c)
    assert isinstance(t_c, t_h.HomogeneousCoordinate) and t_c.shape == (4,)
    assert (t_c.x, t_c.y, t_c.z, t_c.w) == (j_c.x, j_c.y, j_c.z, j_c.w)
    t_c.y = 4.0
    j_c.y = 4.0
    np.testing.assert_array_equal(t_c.normalize(), j_c.normalize())
    assert np.linalg.norm(t_c[:3]) == pytest.approx(1.0)


def test_rays_and_bundles_match_jax():
    origin, direction = t_pyrayt.Point(1, 2, 3), t_pyrayt.Vector(0, 1, 0)
    t_ray = t_pyrayt.Ray(origin, direction)
    j_ray = j_pyrayt.Ray(j_pyrayt.Point(1, 2, 3), j_pyrayt.Vector(0, 1, 0))
    np.testing.assert_array_equal(t_ray, j_ray)
    np.testing.assert_array_equal(t_pyrayt.Ray(), j_pyrayt.Ray())
    assert t_ray.origin.w == 1.0 and t_ray.direction.y == 1.0
    t_ray.origin = t_pyrayt.Point(-1, 0, 0)
    assert t_ray[0, 0] == -1.0
    np.testing.assert_array_equal(t_pyrayt.bundle_of_rays(5), j_pyrayt.bundle_of_rays(5))
    rays = [t_pyrayt.Ray(t_pyrayt.Point(0, k, 0)) for k in range(3)]
    bundle = t_pyrayt.bundle_rays(rays)
    np.testing.assert_array_equal(bundle, j_pyrayt.bundle_rays(rays))
    assert bundle.shape == (2, 4, 3)


def test_a_hand_built_bundle_traces():
    """A bundle of rays from Ray objects, handed to the engine through
    interop, reaches a baffle at x = 1."""
    bundle = t_pyrayt.bundle_rays([t_pyrayt.Ray(t_pyrayt.Point(-1.0, 0.1 * k, 0.0))
                                   for k in range(4)])
    n = bundle.shape[-1]
    meta = np.stack((np.zeros(n), np.ones(n), np.full(n, 0.633), np.ones(n), np.arange(n)))
    rays = interop.rays_from_numpy(bundle[0], bundle[1], meta, device="cpu", dtype=torch.float64)
    from pyrayt_tpu_torch.config import TraceConfig
    from pyrayt_tpu_torch.scene import fresh_ids
    from pyrayt_tpu_torch.scene.compile import compile_scene
    from pyrayt_tpu_torch.tracer import engine

    with fresh_ids():
        scene = compile_scene([t_pyrayt.components.baffle((2.0, 2.0)).move_x(1.0)],
                              device="cpu", dtype=torch.float64)
    result = engine.trace_rays(scene, rays, TraceConfig(generation_limit=2))
    hits = result.records[0, :, result.record_mask[0]]
    torch.testing.assert_close(hits[9], torch.ones(n, dtype=torch.float64))  # x1

"""The port's meshes and RaySet shardings (``parallel/mesh.py``) in one
process, and the padded-ray contract: ``pad_rayset``'s rays (zero
direction, ``w = 1``, zero metadata) leave no record, no NaN and no
cotangent through every route's plain versions (tests/test_parallel/
test_sharding.py:39-65; the card test holds the kernels to the same)."""

import numpy as np
import pytest
import torch

from pyrayt_tpu.components import ConeOfRays as JConeOfRays
from pyrayt_tpu.parallel import pad_rayset as j_pad_rayset
from pyrayt_tpu_torch.config import TraceConfig
from pyrayt_tpu_torch.parallel import (
    RAY_AXES,
    default_mesh,
    pad_rayset,
    rayset_sharding,
    shard_rayset,
    sharded_trace,
)
from pyrayt_tpu_torch.parallel.mesh import Mesh
from pyrayt_tpu_torch.tracer import engine
from torch_parallel_worlds import (lens_system, padded_ray_contract, port_rays, port_scene,
                                   ray_arrays)

FIELDS = ("positions", "directions", "generation", "intensity", "wavelength", "index", "id")


def cone_rays(n):
    """The same cone of rays in both packages (made by the JAX source)."""
    j_rays = JConeOfRays(cone_angle=10.0).move_x(-0.5).generate_rays(n)
    return j_rays, port_rays(ray_arrays(j_rays), "cpu")


def test_a_process_without_a_group_has_a_mesh_of_one():
    mesh = default_mesh(device="cpu")
    assert mesh.shape == {"hosts": 1, "rays": 1} and mesh.axis_names == RAY_AXES
    assert (mesh.size, mesh.rank, mesh.device) == (1, 0, torch.device("cpu"))
    assert mesh.index("hosts") == mesh.index("rays") == 0
    t = torch.arange(5.0)
    assert mesh.gather(t) is t
    assert mesh.all_reduce(t, torch.distributed.ReduceOp.MAX) is t


@pytest.mark.parametrize("kwargs,message", [
    ({"n_hosts": 2}, "not divisible by 2 hosts"),
    ({"n_devices": 8, "n_hosts": 3}, "not divisible by 3 hosts"),
    ({"n_devices": 8}, "one process per device"),
])
def test_a_bad_mesh_raises(kwargs, message):
    with pytest.raises(ValueError, match=message):
        default_mesh(device="cpu", **kwargs)


def test_the_mesh_means_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        default_mesh()
    with pytest.raises(ValueError, match="one process per device"):
        Mesh({"surfaces": 2}, "cpu")


def test_rayset_sharding_splits_the_ray_axis():
    from torch.distributed.tensor import Shard

    placements = rayset_sharding(default_mesh(device="cpu"))
    assert all(getattr(placements, f) == Shard(-1) for f in FIELDS)


@pytest.mark.parametrize("n,multiple", [(10, 8), (13, 8), (13, 4), (16, 8)])
def test_pad_rayset_equals_jax(n, multiple):
    j_rays, t_rays = cone_rays(n)
    padded, n_valid = pad_rayset(t_rays, multiple)
    j_padded, j_n_valid = j_pad_rayset(j_rays, multiple)
    assert n_valid == j_n_valid == n
    assert padded.n_rays == j_padded.n_rays == -(-n // multiple) * multiple
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(padded, f).numpy(), np.asarray(getattr(j_padded, f)),
                                      err_msg=f)
    if padded.n_rays == n:
        assert padded is t_rays


def test_padded_rays_are_born_dead():
    scene = port_scene(lens_system, "cpu")
    _, rays = cone_rays(10)
    padded, n_valid = pad_rayset(rays, 8)
    assert padded.n_rays == 16
    assert torch.all(padded.positions[3] == 1.0) and torch.all(padded.directions[:, 10:] == 0)
    config = TraceConfig(generation_limit=4, fixed_loop=True)
    result = engine.trace_rays(scene, padded, config)
    assert not result.record_mask[:, n_valid:].any()
    assert result.record_mask[:, :n_valid].any()


def test_shard_rayset_and_sharded_trace_in_a_plain_script():
    """A process with no group: the mesh of one rank holds every ray, and
    ``sharded_trace(scene, rays, config)`` equals the one-process trace."""
    scene = port_scene(lens_system, "cpu")
    _, rays = cone_rays(13)
    local = shard_rayset(rays, default_mesh(device="cpu"))
    assert all(torch.equal(getattr(local, f), getattr(rays, f)) for f in FIELDS)
    config = TraceConfig(generation_limit=3, fixed_loop=True)
    got = sharded_trace(scene, rays, config)
    ref = engine.trace_rays(scene, rays, config)
    assert torch.equal(got.records, ref.records) and torch.equal(got.record_mask, ref.record_mask)
    assert int(got.generations_run) == int(ref.generations_run)


@pytest.mark.parametrize("route", ["narrow", "staged", "fused"])
def test_padded_rays_leave_no_record_nan_or_cotangent(route):
    out = padded_ray_contract(route, "cpu")
    assert out["n_padded"] > 0 and out["valid_masks"] > 0
    assert not out["pad_masks"].any()
    assert torch.all(out["pad_records"] == 0)
    assert torch.all(out["pad_d_positions"] == 0) and torch.all(out["pad_d_directions"] == 0)
    for key, grad in out["grads"].items():
        assert torch.isfinite(grad).all(), key
        torch.testing.assert_close(grad, out["unpadded_grads"][key], rtol=1e-12, atol=1e-15)

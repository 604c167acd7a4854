"""The port's ray-axis sharded trace in a 4-rank gloo world (a 2 x 2
``('hosts', 'rays')`` mesh, float64, the plain engine on the CPU) against
the JAX package's ``parallel.sharded_trace`` on its 8 virtual devices
(tests/test_parallel/test_sharding.py, test_wide_fused_sharding.py).

One world (``torch_parallel_worlds.task_trace``) runs every case; the
ranks import no JAX.  Rays are made by the JAX package's sources and
handed to both as NumPy arrays; scenes are built under ``fresh_ids`` by
both packages' builders.
"""

import types

import numpy as np
import pytest
import torch

import pyrayt_tpu.components as j_comp
import pyrayt_tpu.materials as j_matl
from pyrayt_tpu.config import TraceConfig as JConfig
from pyrayt_tpu.parallel import default_mesh as j_default_mesh
from pyrayt_tpu.parallel import sharded_trace as j_sharded_trace
from pyrayt_tpu.scene import fresh_ids as j_fresh_ids
from pyrayt_tpu.scene.compile import compile_scene as j_compile
from torch_parallel_worlds import World, lens_system, mla_system, ray_arrays

JAX_NS = types.SimpleNamespace(comp=j_comp, matl=j_matl, fresh_ids=j_fresh_ids, compile=j_compile)
WORLD = 4
N_HOSTS = 2


def j_scene(build):
    with JAX_NS.fresh_ids():
        return JAX_NS.compile(build(JAX_NS))


def mla_rays(n):
    rays = j_comp.GridOfRays(5 * 0.9, 5 * 0.9).move_x(-1.0).generate_rays(n)
    return rays.replace(id=np.arange(n, dtype=np.float64))


CASES = {  # key -> (scene builder, rays, generation limit)
    "cond64": (lens_system, lambda: j_comp.ConeOfRays(cone_angle=10.0).move_x(-0.5)
               .generate_rays(64), 4),
    "cond13": (lens_system, lambda: j_comp.ConeOfRays(cone_angle=10.0).move_x(-0.5)
               .generate_rays(13), 3),
    "mla256": (lambda m: mla_system(m, 5), lambda: mla_rays(256), 4),
}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    workdir = tmp_path_factory.mktemp("trace_world")
    rays = {key: case[1]() for key, case in CASES.items()}
    inputs = {key: ray_arrays(r) for key, r in rays.items()}
    inputs["n_hosts"] = N_HOSTS
    torch.save(inputs, workdir / "inputs.pt")
    ranks = World("trace", WORLD, workdir)
    jmesh = j_default_mesh(n_devices=8, n_hosts=2)
    refs = {}
    for key, (build, _, gens) in CASES.items():
        config = JConfig(generation_limit=gens, fixed_loop=True)
        refs[key] = j_sharded_trace(j_scene(build), rays[key], config, jmesh)
    return types.SimpleNamespace(ranks=ranks.wait(), refs=refs, rays=rays)


def test_the_mesh_is_two_hosts_by_two_rays(world):
    for r, out in enumerate(world.ranks):
        assert out["shape"] == {"hosts": 2, "rays": 2}
        assert out["size"] == WORLD and out["rank"] == r
        assert (out["hosts_index"], out["rays_index"]) == divmod(r, 2)


@pytest.mark.parametrize("key", ["cond64", "cond13"])
def test_shards_are_rank_ordered_blocks(world, key):
    ids = torch.cat([out[key + "_local_ids"] for out in world.ranks]).numpy()
    n = world.rays[key].n_rays
    np.testing.assert_array_equal(ids[:n], np.arange(n))
    np.testing.assert_array_equal(ids[n:], 0.0)  # padding rays: zero metadata


@pytest.mark.parametrize("key", sorted(CASES))
def test_gathered_trace_equals_jax_sharded_trace(world, key):
    ref = world.refs[key]
    for out in world.ranks:
        got = out[key]
        assert got["records"].shape == tuple(ref.records.shape)
        np.testing.assert_array_equal(got["mask"].numpy(), np.asarray(ref.record_mask))
        np.testing.assert_allclose(got["records"].numpy(), np.asarray(ref.records), rtol=1e-12,
                                   atol=1e-300)
        np.testing.assert_allclose(got["final_positions"].numpy(),
                                   np.asarray(ref.final_rays.positions), rtol=1e-12, atol=1e-300)
        assert got["generations_run"] == int(ref.generations_run)
    first = world.ranks[0][key]
    for out in world.ranks[1:]:  # every rank holds the same global result
        assert torch.equal(out[key]["records"], first["records"])


def test_padded_rays_leave_no_record(world):
    got = world.ranks[0]["cond13"]
    assert got["records"].shape[-1] == 16
    assert not got["mask"][:, 13:].any()
    assert got["mask"][:, :13].any()

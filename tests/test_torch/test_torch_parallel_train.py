"""The port's distributed train step (``parallel.build_train_step``) in
2-rank and 4-rank gloo worlds and in one process, float64 on the CPU,
against the JAX package's ``build_train_step`` on its 8 virtual devices
(tests/test_parallel/test_sharding.py:88-130 and
test_wide_fused_sharding.py:59-81).

The loss sees the gathered global result on every rank; a gather whose
backward summed the ranks' cotangents would make the gradient world-size
times too large, which the 1-, 2- and 4-rank equality rules out.
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pyrayt_tpu.components as j_comp
import pyrayt_tpu.materials as j_matl
from pyrayt_tpu.analysis.metrics import rms_spot_radius as j_rms_spot_radius
from pyrayt_tpu.config import TraceConfig as JConfig
from pyrayt_tpu.parallel import build_train_step as j_build_train_step
from pyrayt_tpu.parallel import default_mesh as j_default_mesh
from pyrayt_tpu.parallel import pad_rayset as j_pad_rayset
from pyrayt_tpu.parallel import shard_rayset as j_shard_rayset
from pyrayt_tpu.scene import fresh_ids as j_fresh_ids
from pyrayt_tpu.scene.compile import compile_scene as j_compile
from pyrayt_tpu_torch.parallel import default_mesh
from torch_parallel_worlds import World, lens_system, mla_system, ray_arrays, task_train

JAX_NS = types.SimpleNamespace(comp=j_comp, matl=j_matl, fresh_ids=j_fresh_ids, compile=j_compile)
LOSS_RTOL = 1e-10
PARAM_RTOL, PARAM_ATOL = 1e-8, 1e-12
# the same step over other ray partitions: only the order of the
# per-ray gradient sums differs
WORLD_RTOL, WORLD_ATOL = 1e-12, 1e-15


def j_scene(build):
    with JAX_NS.fresh_ids():
        return JAX_NS.compile(build(JAX_NS))


def j_rms_spot(result):
    y = result.final_rays.positions[1]
    z = result.final_rays.positions[2]
    w = jnp.any(result.record_mask, axis=0).astype(y.dtype)
    return jnp.sum(w * (y**2 + z**2)) / jnp.maximum(jnp.sum(w), 1.0)


def jax_steps(rays):
    """The JAX package's steps on its 8-device mesh: the same cases as
    ``task_train``."""
    jmesh = j_default_mesh(n_devices=8, n_hosts=2)
    config = JConfig(generation_limit=4, fixed_loop=True)

    def placed(r):
        return j_shard_rayset(j_pad_rayset(r, jmesh.size)[0], jmesh)

    out = {}
    narrow = j_scene(lens_system)
    step = j_build_train_step(narrow, config, jmesh, j_rms_spot, learning_rate=1e-2)
    p1, l1 = step(narrow.params, placed(rays["cond64"]))
    p2, l2 = step(p1, placed(rays["cond64"]))
    out["rms_spot"] = {"params1": p1, "loss1": float(l1), "params2": p2, "loss2": float(l2)}
    step = j_build_train_step(narrow, config, jmesh, j_rms_spot_radius, learning_rate=1e-2)
    p, loss = step(narrow.params, placed(rays["cond64"]))
    out["rms_spot_radius"] = {"params": p, "loss": float(loss)}
    wide = j_scene(lambda m: mla_system(m, 5))
    det_id = float(wide.spec.leaf_ids[-1])
    step = j_build_train_step(wide, config, jmesh, lambda r: j_rms_spot_radius(r, det_id),
                              learning_rate=1e-2)
    p, loss = step(wide.params, placed(rays["mla256"]))
    out["mla_rms_spot_radius"] = {"params": p, "loss": float(loss)}
    return out


@pytest.fixture(scope="module")
def steps(tmp_path_factory):
    rays = {"cond64": j_comp.ConeOfRays(cone_angle=10.0).move_x(-0.5).generate_rays(64)}
    mla = j_comp.GridOfRays(5 * 0.9, 5 * 0.9).move_x(-1.0).generate_rays(256)
    rays["mla256"] = mla.replace(id=np.arange(256, dtype=np.float64))
    inputs = {key: ray_arrays(r) for key, r in rays.items()}
    worlds = {}
    for world in (2, 4):  # both worlds run while this process computes the rest
        workdir = tmp_path_factory.mktemp(f"train_world{world}")
        torch.save(inputs, workdir / "inputs.pt")
        worlds[world] = World("train", world, workdir)
    by_world = {1: task_train(default_mesh(device="cpu"), inputs)}
    jax_ref = jax_steps(rays)
    by_world.update({world: w.wait() for world, w in worlds.items()})
    return types.SimpleNamespace(by_world=by_world, jax=jax_ref)


CASES = [("rms_spot", "params1", "loss1"), ("rms_spot", "params2", "loss2"),
         ("rms_spot_radius", "params", "loss"), ("mla_rms_spot_radius", "params", "loss")]


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("case,params_key,loss_key", CASES)
def test_step_equals_jax_train_step(steps, world, case, params_key, loss_key):
    ref = steps.jax[case]
    for out in steps.by_world[world]:
        got = out[case]
        np.testing.assert_allclose(got[loss_key], ref[loss_key], rtol=LOSS_RTOL)
        for key, value in got[params_key].items():
            np.testing.assert_allclose(value.numpy(), np.asarray(ref[params_key][key]),
                                       rtol=PARAM_RTOL, atol=PARAM_ATOL, err_msg=key)


@pytest.mark.parametrize("case,params_key,loss_key", CASES)
def test_step_is_world_size_invariant(steps, case, params_key, loss_key):
    one = steps.by_world[1][case]
    for world in (2, 4):
        for out in steps.by_world[world]:
            got = out[case]
            assert got[loss_key] == one[loss_key], (world, case)  # the same global result
            for key, value in got[params_key].items():
                np.testing.assert_allclose(value.numpy(), one[params_key][key].numpy(),
                                           rtol=WORLD_RTOL, atol=WORLD_ATOL,
                                           err_msg=f"{world} ranks, {key}")


@pytest.mark.parametrize("world", [2, 4])
def test_every_rank_gets_the_same_bits(steps, world):
    first = steps.by_world[world][0]
    for out in steps.by_world[world][1:]:
        for case, params_key, loss_key in CASES:
            assert out[case][loss_key] == first[case][loss_key]
            for key, value in out[case][params_key].items():
                assert torch.equal(value, first[case][params_key][key]), (case, key)


def test_loss_decreases_over_two_steps(steps):
    for world in (1, 2, 4):
        outs = steps.by_world[world]
        for out in outs if isinstance(outs, list) else [outs]:
            assert np.isfinite(out["rms_spot"]["loss1"]) and np.isfinite(out["rms_spot"]["loss2"])
            assert out["rms_spot"]["loss2"] <= out["rms_spot"]["loss1"]

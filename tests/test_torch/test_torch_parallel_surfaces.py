"""The port's surface-axis sharding in a 2-rank gloo world (float64, the
plain engine on the CPU) against the JAX package's ``parallel.surfaces``
(tests/test_parallel/test_surface_sharding.py and
test_wide_sharded_trace.py; the JAX side on its 8 virtual devices).

One world (``torch_parallel_worlds.task_surfaces``) runs every case:
the sphere-grid nearest-hit fold (plain, padded, coincident spheres on
both ranks), the wide sharded trace of the 4x4 microlens array and its
gradient through the MIN combine's autograd Function, and both
ValueError cases.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

import pyrayt_tpu.components as j_comp
import pyrayt_tpu.materials as j_matl
from pyrayt_tpu.config import TraceConfig as JConfig
from pyrayt_tpu.core import primitives as j_prim
from pyrayt_tpu.parallel import build_wide_sharded_trace_fn as j_build_wide_sharded_trace_fn
from pyrayt_tpu.parallel.surfaces import pad_leaf_tables as j_pad_leaf_tables
from pyrayt_tpu.parallel.surfaces import replicated_nearest_hit as j_replicated_nearest_hit
from pyrayt_tpu.scene import fresh_ids as j_fresh_ids
from pyrayt_tpu.scene.compile import compile_scene as j_compile
from pyrayt_tpu_torch.config import TraceConfig
from pyrayt_tpu_torch.ops import fused_grad as fg
from pyrayt_tpu_torch.parallel import pad_leaf_tables
from pyrayt_tpu_torch.tracer import engine
from torch_parallel_worlds import World, mla_system, port_rays, port_scene, ray_arrays, y_hits_loss

JAX_NS = types.SimpleNamespace(comp=j_comp, matl=j_matl, fresh_ids=j_fresh_ids, compile=j_compile)
WORLD = 2
RTOL = 1e-12
GRAD_RTOL = 1e-8


def sphere_grid(n_side, spacing=3.0, radius=1.0):
    """test_surface_sharding.py:_sphere_grid: n_side^2 unit spheres in the
    yz plane at x = 5."""
    ys, zs = np.meshgrid((np.arange(n_side) - (n_side - 1) / 2) * spacing,
                         (np.arange(n_side) - (n_side - 1) / 2) * spacing)
    centers = np.stack([np.full(ys.size, 5.0), ys.ravel(), zs.ravel()], axis=1)
    world = np.tile(np.eye(4), (len(centers), 1, 1))
    world[:, :3, 3] = centers
    params = np.zeros((len(centers), 8))
    params[:, 0] = radius
    return world, params


def ray_fan(n):
    """test_surface_sharding.py:_ray_fan: n rays from the origin into the
    grid."""
    rng = np.random.default_rng(0)
    directions = rng.normal(size=(3, n))
    directions[0] = np.abs(directions[0]) + 1.0
    directions /= np.linalg.norm(directions, axis=0)
    rays = np.zeros((2, 4, n))
    rays[0, 3] = 1.0
    rays[1, :3] = directions
    return rays


def coincident_spheres():
    """test_surface_sharding.py:86-97: eight identical spheres, four on
    each rank, and four +X rays from the origin."""
    world = np.tile(np.eye(4), (8, 1, 1))
    world[:, 0, 3] = 5.0
    params = np.zeros((8, 8))
    params[:, 0] = 1.0
    rays = np.zeros((2, 4, 4))
    rays[0, 3] = 1.0
    rays[1, 0] = 1.0
    return world, params, rays


def grid_rays(n, span):
    rays = j_comp.GridOfRays(span, span).move_x(-1.0).generate_rays(n)
    rays = rays.replace(id=jnp.arange(n, dtype=rays.positions.dtype))
    return rays, ray_arrays(rays)


def random_rays(n, span, seed=3):
    """n +X rays from x = -1 at uniform random points of a span x span
    square: no ray meets two lenslets at the same distance."""
    rng = np.random.default_rng(seed)
    pos = np.zeros((4, n))
    pos[0], pos[3] = -1.0, 1.0
    pos[1:3] = (rng.random((2, n)) - 0.5) * span
    dirs = np.zeros((4, n))
    dirs[0] = 1.0
    meta = np.stack((np.zeros(n), np.full(n, 100.0), np.full(n, 0.633), np.ones(n),
                     np.arange(n, dtype=float)))
    return {"pos": pos, "dirs": dirs, "meta": meta}


def j_mla(n):
    with j_fresh_ids():
        return j_compile(mla_system(JAX_NS, n))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    workdir = tmp_path_factory.mktemp("surfaces_world")
    j512, a512 = grid_rays(512, 4.2)
    j128, a128 = grid_rays(128, 3.0)
    inputs = {"mla512": a512, "mla128": a128, "mla_random128": random_rays(128, 3.0)}
    for key, (w, p), n in (("grid16", sphere_grid(4), 512), ("grid9", sphere_grid(3), 256)):
        inputs[key] = {"world": w, "params": p, "rays": ray_fan(n)}
    w, p, r = coincident_spheres()
    inputs["ties"] = {"world": w, "params": p, "rays": r}
    torch.save(inputs, workdir / "inputs.pt")
    ranks = World("surfaces", WORLD, workdir)

    jmesh = JMesh(np.asarray(jax.devices()[:8]), ("surfaces",))
    scene = j_mla(4)
    refs = {"mla512": j_build_wide_sharded_trace_fn(
        scene, JConfig(generation_limit=4, fixed_loop=True), jmesh)(scene.params, j512)}
    fn = j_build_wide_sharded_trace_fn(scene, JConfig(generation_limit=3, fixed_loop=True), jmesh)

    def loss(params):
        result = fn(params, j128)
        y = result.records[:, 10, :]
        return jnp.sum(jnp.where(result.record_mask, y, 0.0) ** 2)

    value, grads = jax.value_and_grad(loss)(scene.params)
    refs["mla128_grad"] = {"loss": float(value), **{k: np.asarray(v) for k, v in grads.items()}}
    for key in ("grid16", "grid9", "ties"):
        d = inputs[key]
        refs[key] = j_replicated_nearest_hit(j_prim.SPHERE, d["world"], d["params"],
                                             jnp.asarray(d["rays"]))
    return types.SimpleNamespace(ranks=ranks.wait(), refs=refs, inputs=inputs)


@pytest.mark.parametrize("multiple", [2, 8, 9])
def test_pad_leaf_tables_equals_jax(multiple):
    w, p = sphere_grid(3)
    world, params, s = pad_leaf_tables(torch.as_tensor(w), torch.as_tensor(p), multiple)
    j_world, j_params, j_s = j_pad_leaf_tables(w, p, multiple)
    assert s == j_s == 9
    np.testing.assert_array_equal(world.numpy(), np.asarray(j_world))
    np.testing.assert_array_equal(params.numpy(), np.asarray(j_params))


@pytest.mark.parametrize("key", ["grid16", "grid9"])
def test_sharded_fold_equals_jax_replicated_fold(world, key):
    j_dist, j_leaf = world.refs[key]
    for out in world.ranks:
        np.testing.assert_allclose(out[key]["dist"].numpy(), np.asarray(j_dist), rtol=RTOL)
        np.testing.assert_array_equal(out[key]["leaf"].numpy(), np.asarray(j_leaf))
    leaf = world.ranks[0][key]["leaf"].numpy()
    assert len(set(leaf.tolist()) - {-1}) > 4 and (leaf == -1).any()
    # leaves 0-7 fold on rank 0, the rest on rank 1: both ranks win rays
    assert (leaf >= 0).any() and (leaf[leaf >= 0] < 8).any() and (leaf >= 8).any()


def test_padding_leaves_never_win(world):
    leaf = world.ranks[1]["grid9"]["leaf"]
    assert int(leaf.max()) == 8  # rank 1 holds the last real leaf and 7 padding leaves


def test_ties_break_to_the_smallest_leaf_index(world):
    for out in world.ranks:
        np.testing.assert_allclose(out["ties"]["dist"].numpy(), 4.0)
        np.testing.assert_array_equal(out["ties"]["leaf"].numpy(), 0)


def test_wide_sharded_trace_equals_jax(world):
    ref = world.refs["mla512"]
    for out in world.ranks:
        got = out["mla512"]
        np.testing.assert_array_equal(got["mask"].numpy(), np.asarray(ref.record_mask))
        np.testing.assert_allclose(got["records"].numpy(), np.asarray(ref.records), rtol=RTOL,
                                   atol=1e-300)
        np.testing.assert_allclose(got["final_positions"].numpy(),
                                   np.asarray(ref.final_rays.positions), rtol=RTOL, atol=1e-300)
        assert got["generations_run"] == int(ref.generations_run)
    assert int(world.ranks[0]["mla512"]["mask"].sum()) > 100


def test_wide_sharded_trace_equals_the_one_process_engine(world):
    scene = port_scene(lambda m: mla_system(m, 4), "cpu")
    config = TraceConfig(generation_limit=4, fixed_loop=True)
    ref = engine.build_trace_fn(scene.spec, scene.materials, config)(
        scene.params, port_rays(world.inputs["mla512"], "cpu"))
    for out in world.ranks:  # the fold is exact comparisons: bit for bit
        assert torch.equal(out["mla512"]["mask"], ref.record_mask)
        assert torch.equal(out["mla512"]["records"], ref.records)
        assert torch.equal(out["mla512"]["final_positions"], ref.final_rays.positions)


def test_wide_sharded_gradient_equals_jax(world):
    ref = world.refs["mla128_grad"]
    first = world.ranks[0]["mla128_grad"]
    np.testing.assert_allclose(first["loss"], ref["loss"], rtol=RTOL)
    for key in ("world", "prim", "glass"):
        np.testing.assert_allclose(first[key].numpy(), ref[key], rtol=GRAD_RTOL, atol=1e-12,
                                   err_msg=key)
        assert torch.any(first[key] != 0) or not np.any(ref[key] != 0)
        for out in world.ranks[1:]:  # every rank holds the whole gradient
            assert torch.equal(out["mla128_grad"][key], first[key])


def test_wide_sharded_gradient_equals_the_one_process_engine(world):
    """On rays that never meet two trees at one distance (where they do,
    the grid rays above on lenslet edges, both split the cotangent between
    the tied trees, as the JAX package's min does: the F3 tests below)."""
    scene = port_scene(lambda m: mla_system(m, 4), "cpu")
    config = TraceConfig(generation_limit=3, fixed_loop=True)
    params = {k: v.detach().requires_grad_(True) for k, v in scene.params.items()}
    loss = y_hits_loss(engine.build_trace_fn(scene.spec, scene.materials, config)(
        params, port_rays(world.inputs["mla_random128"], "cpu")))
    loss.backward()
    for out in world.ranks:
        got = out["mla_random128_grad"]
        assert got["loss"] == loss.item()
        for key in ("world", "prim", "glass"):  # the ranks' parts summed in another order
            np.testing.assert_allclose(got[key].numpy(), params[key].grad.numpy(), rtol=1e-12,
                                       atol=1e-15, err_msg=key)
            assert torch.any(got[key] != 0) or key == "glass"


@pytest.mark.parametrize("case,message", [("indivisible", "not divisible"),
                                          ("narrow", "batchable")])
def test_wide_sharded_trace_rejects(world, case, message):
    for out in world.ranks:
        assert message in out["errors"][case]


def _first_tree_reduce(dist, leaf):
    """``engine._reduce_tree_axis`` under the first-tree rule: the distance
    gathered at ``argmin``, so a tie's whole cotangent goes to the first
    tree (the rule of the wide kernels and their plain versions)."""
    win = torch.argmin(dist, dim=0)
    dmin = torch.gather(dist, 0, win[None])[0]
    lmin = torch.gather(leaf, 0, win[None])[0]
    return dmin, torch.where(torch.isinf(dmin), -1, lmin).to(torch.int32)


def _spy_ties(monkeypatch, reduce):
    """Run ``reduce`` as the engine's tree-axis reduce and record, per
    call, the rays whose nearest distance two or more trees share."""
    tied = []

    def spy(dist, leaf):
        d = dist.detach()
        dmin = d.amin(dim=0)
        tied.append(((d == dmin).sum(dim=0) > 1) & torch.isfinite(dmin))
        return reduce(dist, leaf)

    monkeypatch.setattr(engine, "_reduce_tree_axis", spy)
    return tied


def _plain_engine_grads(scene, rays, config):
    params = {k: v.detach().requires_grad_(True) for k, v in scene.params.items()}
    loss = y_hits_loss(engine.build_trace_fn(scene.spec, scene.materials, config)(params, rays))
    loss.backward()
    return loss.item(), {k: v.grad for k, v in params.items()}


# the grid rays of the 4x4 array (128 rays, span 3.0) that meet two lenslets
# of the group at one distance in some generation
TIED_RAYS_4X4 = 2


def test_f3_the_one_process_engine_splits_a_tie_as_jax_does(world, monkeypatch):
    """ROADMAP F3, closed: the grid's rays at y = 0 meet two lenslets of one
    group at the same distance.  The JAX package's engine splits the
    distance cotangent between the tied trees (``jnp.min``), so does the
    sharded combine here, the two trees lying on different ranks, and so
    does the port's one-process engine (``engine._reduce_tree_axis``,
    ``amin``)."""
    scene = port_scene(lambda m: mla_system(m, 4), "cpu")
    config = TraceConfig(generation_limit=3, fixed_loop=True)
    tied = _spy_ties(monkeypatch, engine._reduce_tree_axis)
    value, grads = _plain_engine_grads(scene, port_rays(world.inputs["mla128"], "cpu"), config)
    assert int(torch.stack(tied).any(dim=0).sum()) == TIED_RAYS_4X4
    ref = world.refs["mla128_grad"]
    assert value == pytest.approx(ref["loss"], rel=RTOL)
    for key in ("world", "prim", "glass"):
        np.testing.assert_allclose(grads[key].numpy(), ref[key], rtol=GRAD_RTOL, atol=1e-12,
                                   err_msg=key)


@pytest.mark.parametrize("wide_grad", ["staged", "fused"])
def test_f3_the_kernel_route_gives_a_tie_to_the_first_tree(world, monkeypatch, wide_grad):
    """The wide kernels follow K2's win codes, so on the same tie rays they
    give the whole cotangent to the first tree, as the JAX package's wide
    kernels do (``pyrayt_tpu/ops/fused_grad.py:316-319``).  On the CPU the
    kernel route's wrappers run the plain versions (K2's, then K5-K7's or
    K8's): they equal autograd of the plain engine under the first-tree
    rule on every ray, the tied ones included, and miss the split."""
    scene = port_scene(lambda m: mla_system(m, 4), "cpu")
    rays = port_rays(world.inputs["mla128"], "cpu")
    config = TraceConfig(generation_limit=3, fixed_loop=True, wide_grad=wide_grad)
    params = {k: v.detach().requires_grad_(True) for k, v in scene.params.items()}
    loss = y_hits_loss(fg.build_fused_vjp_trace_fn(scene.spec, scene.materials, config)(
        params, rays))
    loss.backward()
    tied = _spy_ties(monkeypatch, _first_tree_reduce)
    value, first_tree = _plain_engine_grads(scene, rays, config)
    assert int(torch.stack(tied).any(dim=0).sum()) == TIED_RAYS_4X4
    assert loss.item() == pytest.approx(value, rel=RTOL)
    for key in ("world", "prim", "glass"):
        np.testing.assert_allclose(params[key].grad.numpy(), first_tree[key].numpy(),
                                   rtol=GRAD_RTOL, atol=1e-12, err_msg=key)
    gap = float(np.abs(params["world"].grad.numpy() - world.refs["mla128_grad"]["world"]).max())
    assert gap > 0.1, gap

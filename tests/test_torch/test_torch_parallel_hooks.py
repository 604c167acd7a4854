"""The plain engine's two hooks for the surface-sharded trace:
``scene_nearest_hit(group_slots_fn=...)`` and ``_build_trace_fn(
nearest_fn=...)`` (the JAX package's ``tracer/engine.py:297,582``).  Left
at their defaults, or given what the defaults compute, they leave the
search and the trace bit-identical; a subset of a group's trees folds
exactly those trees."""

import functools

import numpy as np
import pytest
import torch

from pyrayt_tpu_torch.config import TraceConfig
from pyrayt_tpu_torch.tracer import engine
from torch_parallel_worlds import lens_system, mla_system, port_rays, port_scene
from torch_parity_scenes import grid_rays, numpy_rays

SCENES = {
    "narrow": (lens_system, lambda: numpy_rays((-0.5, 0.0, 0.0), 10.0, 64)),
    "mla4": (lambda m: mla_system(m, 4), lambda: grid_rays(4.2, 4.2, -1.0, 256)),
}


def inputs(name):
    build, rays = SCENES[name]
    scene = port_scene(build, "cpu")
    return scene, port_rays(dict(zip(("pos", "dirs", "meta"), rays())), "cpu")


@pytest.mark.parametrize("name", sorted(SCENES))
def test_default_hooks_leave_the_search_bit_identical(name):
    scene, rays = inputs(name)
    tables = engine.scene_tables(scene.params)
    stacked = rays.rays
    ref = engine.scene_nearest_hit(scene.spec, tables, stacked)
    full = engine.scene_nearest_hit(
        scene.spec, tables, stacked,
        group_slots_fn=lambda gi, slot_matrix: torch.as_tensor(slot_matrix, dtype=torch.long))
    for a, b in zip(ref, full):
        assert torch.equal(a, b)


@pytest.mark.parametrize("name", sorted(SCENES))
@pytest.mark.parametrize("remat", [False, True])
def test_a_default_nearest_fn_reproduces_the_trace(name, remat):
    scene, rays = inputs(name)
    config = TraceConfig(generation_limit=4, fixed_loop=True, remat=remat)
    cached = engine.build_trace_fn(scene.spec, scene.materials, config)
    nearest = functools.partial(engine.scene_nearest_hit, scene.spec)
    hooked = engine._build_trace_fn(scene.spec, scene.materials, config, nearest_fn=nearest)
    results = []
    for fn in (cached, hooked):
        params = {k: v.detach().requires_grad_(True) for k, v in scene.params.items()}
        result = fn(params, rays)
        m = result.record_mask
        (result.records * m[:, None]).pow(2).sum().backward()
        results.append((result, {k: v.grad for k, v in params.items()}))
    (a, ga), (b, gb) = results
    assert torch.equal(a.records, b.records) and torch.equal(a.record_mask, b.record_mask)
    assert torch.equal(a.final_rays.positions, b.final_rays.positions)
    assert all(torch.equal(ga[k], gb[k]) for k in ga)


def test_a_tree_subset_folds_only_those_trees():
    scene, rays = inputs("mla4")
    tables = engine.scene_tables(scene.params)
    _, groups = engine.wide_plan(scene.spec)
    (_, _, slot_matrix), = groups
    keep = torch.as_tensor(slot_matrix[:8], dtype=torch.long)
    dist, leaf = engine.scene_nearest_hit(scene.spec, tables, rays.rays,
                                          group_slots_fn=lambda gi, sm: keep)
    hit = leaf[leaf >= 0].numpy()
    allowed = set(np.asarray(slot_matrix[:8]).ravel().tolist()) | {scene.spec.n_leaves - 1}
    assert set(hit.tolist()) <= allowed and len(set(hit.tolist())) > 2
    full_dist, _ = engine.scene_nearest_hit(scene.spec, tables, rays.rays)
    assert torch.all(dist >= full_dist)

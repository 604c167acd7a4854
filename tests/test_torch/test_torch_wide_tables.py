"""The wide scenes' host tables and dispatch against the JAX package.

The wide plan, the flat slot tables, the spatially sorted slot vector and
chunk boxes, and the per-slot meta table decide which tree a win code
names, so they must equal the JAX package's exactly: the port's K2 is
compared with the JAX kernel by its win codes.
"""

import numpy as np
import pytest
import torch

from pyrayt_tpu.ops import fused_trace as j_ft
from pyrayt_tpu.tracer import engine as j_engine
from pyrayt_tpu_torch.config import TraceConfig
from pyrayt_tpu_torch.ops import fused_grad as fg
from pyrayt_tpu_torch.ops import fused_trace as ft
from pyrayt_tpu_torch.tracer import engine

TABLE_SCENES = ["mla5", "mla6", "csg_singles", "hetero"]


@pytest.mark.parametrize("name", TABLE_SCENES)
def test_wide_plan_and_tables_equal_jax(twins, name):
    j_scene, t_scene, _, _, _ = twins.wide_inputs(name)
    j_spec, t_spec = j_scene.spec, t_scene.spec
    assert engine.wide_plan(t_spec) == j_engine._wide_plan(j_spec)
    j_tables = j_ft._wide_tables(j_spec)
    t_tables = ft.wide_tables(t_spec)
    for i in (0, 1, 2, 4, 5):
        assert t_tables[i] == j_tables[i]
    np.testing.assert_array_equal(t_tables[3], j_tables[3])
    np.testing.assert_array_equal(ft.leaf_meta_table(t_spec), j_ft._leaf_meta_table(j_spec))
    assert ft.supports_fused_wide(t_spec) == j_ft.supports_fused_wide(j_spec) is True
    j_plan = j_ft._wide_fold_plan(j_spec)
    t_plan = ft.wide_fold_plan(t_spec)
    assert [(k, i) for k, i, _ in t_plan] == [(k, i) for k, i, _ in j_plan]
    for (_, _, t_info), (_, _, j_info) in zip(t_plan, j_plan):
        for key, value in t_info.items():
            assert j_info[key] == value, key


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("name", TABLE_SCENES)
def test_runtime_tables_equal_jax(twins, name, dtype):
    import jax.numpy as jnp

    j_scene, t_scene, _, _, _ = twins.wide_inputs(name)
    j_dtype = jnp.float64 if dtype == torch.float64 else jnp.float32
    j_slots, j_aabb = j_ft._wide_runtime_tables(j_scene.spec, j_scene.params, j_dtype)
    params = {k: v.to(dtype) for k, v in t_scene.params.items()}
    t_slots, t_aabb = ft.wide_runtime_tables(t_scene.spec, params, dtype)
    assert t_slots.dtype == torch.int32 and t_aabb.dtype == dtype
    np.testing.assert_array_equal(t_slots.numpy(), np.asarray(j_slots))
    np.testing.assert_array_equal(t_aabb.numpy(), np.asarray(j_aabb))


def test_square_grid_sorts_stably(twins):
    """On a square grid the spreads along y and z are equal, so every row
    shares one key: a stable sort keeps each row in index order (as
    ``jnp.argsort`` does), and the 6x6 array's slot vector starts with
    lenslets 0 and 1 (slots 0..3) in order."""
    _, t_scene, _, _, _ = twins.wide_inputs("mla6")
    slots, aabb = ft.wide_runtime_tables(t_scene.spec, t_scene.params, torch.float64)
    assert aabb.shape == (3, 6)  # 36 trees: 3 chunks of 16
    np.testing.assert_array_equal(slots[:14].numpy(), np.arange(14))


def test_chunk_boxes_contain_their_trees(twins):
    """Each chunk box holds every leaf box of its 16 sorted trees (the skip
    is conservative)."""
    _, t_scene, _, _, _ = twins.wide_inputs("mla6")
    spec, params = t_scene.spec, t_scene.params
    slots, aabb = ft.wide_runtime_tables(spec, params, torch.float64)
    (_, types_pos, slot_matrix), = engine.wide_plan(spec)[1]
    rows = slots[: len(slot_matrix) * 2].long().reshape(-1, 2)
    for j, t in enumerate(types_pos):
        lo, hi = ft._leaf_world_aabb(t, params["prim"][rows[:, j]], params["world"][rows[:, j]])
        chunk = torch.arange(len(slot_matrix)) // ft.WIDE_CHUNK_TREES
        assert (lo >= aabb[chunk, :3]).all() and (hi <= aabb[chunk, 3:]).all()


def test_wide_program_layout(twins):
    _, t_scene, _, _, _ = twins.wide_inputs("csg_singles")
    spec = t_scene.spec
    prog = ft.wide_program(spec)
    n_leaves, n_mats, n_instr, pairs_off, n_single_leaves, n_groups = prog[:6]
    assert n_leaves == spec.n_leaves == 56 and n_mats == len(spec.mat_kinds)
    assert n_groups == 1 and n_single_leaves == 6  # thick lens 3, union 2, detector 1
    groups_off, singles_off, leaf_off, n_single_trees, trees_off = prog[6:11]
    group = prog[groups_off:groups_off + ft._GROUP_WIDTH]
    assert list(group[:6]) == [25, 2, 0, 0, 0, 0]  # T, L, slot/chunk offsets, code base
    assert n_single_trees == 3  # thick lens, union, detector
    codes = prog[trees_off:trees_off + 3 * n_single_trees:3]
    assert list(codes) == [25, 26, 27]
    leaf = prog[leaf_off:].reshape(spec.n_leaves, 5)
    np.testing.assert_array_equal(leaf[:, 4], spec.leaf_ids)
    singles = prog[singles_off:singles_off + 2 * n_single_leaves].reshape(-1, 2)
    np.testing.assert_array_equal(singles[:, 0], np.arange(50, 56))
    ops = [prog[11 + n_mats + 6 * k] for k in range(n_instr)]
    assert ops.count(ft.GROUP) == 1 and ops[0] == ft.GROUP
    assert leaf_off > pairs_off  # the union's comparator pairs


def test_wide_dispatch_rules(twins):
    """Wide scenes take K2 on CUDA tensors and the plain engine on the CPU;
    ``use_fused=True`` raises off the card; a wide scene without a
    batchable group runs the plain engine and ``use_fused=True`` raises."""
    _, t_scene, _, _, _ = twins.wide_inputs("mla5")
    spec = t_scene.spec
    assert not ft.supports_fused(spec) and ft.supports_fused_wide(spec)
    assert ft.pick_fused(spec, TraceConfig(), "cuda")
    assert not ft.pick_fused(spec, TraceConfig(), "cpu")
    assert not ft.pick_fused(spec, TraceConfig(use_fused=False), "cuda")
    with pytest.raises(ValueError, match="CUDA"):
        ft.pick_fused(spec, TraceConfig(use_fused=True), "cpu")
    from torch_parity_scenes import TORCH_NS

    # 7 thick lenses, 7 baffles, 3 prisms: 38 leaves and no shape with the
    # 8 trees a group needs
    with TORCH_NS.fresh_ids():
        mixed = [TORCH_NS.comp.thick_lens(1.0, -1.0, 0.2, aperture=0.5).move_x(i)
                 for i in range(7)]
        mixed += [TORCH_NS.comp.baffle((1.0, 1.0)).move_x(9.0 + 0.5 * i) for i in range(7)]
        mixed += [TORCH_NS.comp.equilateral_prism(0.5, 0.5).move_x(20.0 + i) for i in range(3)]
        no_group = TORCH_NS.compile(mixed, device="cpu", dtype=torch.float64)
    assert no_group.spec.n_leaves > engine.MAX_NARROW_LEAVES
    assert not engine.wide_plan(no_group.spec)[1]
    assert not ft.supports_fused_wide(no_group.spec)
    assert not ft.pick_fused(no_group.spec, TraceConfig(), "cuda")
    with pytest.raises(ValueError, match="batchable"):
        ft.pick_fused(no_group.spec, TraceConfig(use_fused=True), "cuda")


def test_wide_grad_modes(twins):
    _, t_scene, _, _, _ = twins.wide_inputs("mla5")
    spec = t_scene.spec
    assert fg.wide_grad_mode(spec, TraceConfig()) == "staged"
    assert fg.wide_grad_mode(spec, TraceConfig(wide_grad="staged")) == "staged"
    assert fg.wide_grad_mode(spec, TraceConfig(wide_grad="fused")) == "fused"
    assert callable(fg.build_fused_vjp_trace_fn(spec, t_scene.materials,
                                                TraceConfig(wide_grad="fused")))
    with pytest.raises(ValueError, match="unknown"):
        fg.wide_grad_mode(spec, TraceConfig(wide_grad="monolithic"))

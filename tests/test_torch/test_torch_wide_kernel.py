"""The plain version of the wide kernel K2 (``fused_trace_wide_plain``)
against the JAX package's wide Pallas kernel in interpret mode and against
the JAX engine (float64, CPU).

``win`` names the winning tree in the spatially sorted fold order, so it
is compared with the JAX *kernel*'s, exactly; records and ``fold5`` agree
within 1e-12.  Both are compared on the ray-generations a ray ran: the
JAX kernel keeps stepping dead rays, the port stops them (the per-ray exit
of ops/fused_trace.py).
"""

import numpy as np
import pytest
import torch

from pyrayt_tpu.config import TraceConfig as JConfig
from pyrayt_tpu.ops import fused_trace as j_ft
from pyrayt_tpu.tracer import engine as j_engine
from pyrayt_tpu_torch.config import TraceConfig
from pyrayt_tpu_torch.ops import fused_grad as fg
from pyrayt_tpu_torch.ops import fused_trace as ft


def _k2_plain(t_scene, t_rays, gens):
    inputs = ft.wide_kernel_inputs(t_scene.spec, t_scene.params, t_rays)
    return inputs, ft.fused_trace_wide_plain(
        t_scene.spec, TraceConfig(generation_limit=gens), *inputs, save_fold=True)


def test_plain_k2_matches_jax_kernel_interpret(twins):
    j_scene, t_scene, j_rays, t_rays, gens = twins.wide_inputs("mla6")
    j_res, j_fold5, j_win = j_ft.build_fused_trace_fn(
        j_scene.spec, j_scene.materials, JConfig(generation_limit=gens), interpret=True,
        save_fold=True)(j_scene.params, j_rays)
    _, (records, masks, fstate, fold5, win) = _k2_plain(t_scene, t_rays, gens)
    np.testing.assert_array_equal(masks.numpy(), np.asarray(j_res.record_mask))
    ran = fg.generations_ran(records, masks).numpy()
    assert ran.sum() > 400  # several generations of real physics
    np.testing.assert_array_equal(win.numpy()[ran], np.asarray(j_win)[ran])
    np.testing.assert_array_equal(win.numpy()[~ran], -1)
    assert (win.numpy()[ran] >= 0).sum() > 200  # rays that hit a tree
    fold_diff = np.abs(fold5.numpy() - np.asarray(j_fold5))
    fold_diff = np.where(np.isinf(fold5.numpy()) & np.isinf(np.asarray(j_fold5)), 0.0, fold_diff)
    assert np.where(ran[:, None, :], fold_diff, 0.0).max() < 1e-12
    sel = np.asarray(j_res.record_mask)[:, None, :]
    rec_diff = np.where(sel, np.abs(records.numpy() - np.asarray(j_res.records)), 0.0)
    assert rec_diff.max() < 1e-12
    # the per-ray exit: generations a ray did not run are zero
    assert not records.numpy()[~ran[:, None, :].repeat(15, 1)].any()
    assert not fold5.numpy()[~ran[:, None, :].repeat(5, 1)].any()


@pytest.mark.parametrize("name", ["mla5", "csg_singles", "hetero"])
def test_plain_k2_matches_jax_engine(twins, name):
    j_scene, t_scene, j_rays, t_rays, gens = twins.wide_inputs(name)
    j_config = JConfig(generation_limit=gens)
    j_res = j_engine.build_trace_fn(j_scene.spec, j_scene.materials, j_config)(j_scene.params,
                                                                               j_rays)
    _, (records, masks, fstate, fold5, win) = _k2_plain(t_scene, t_rays, gens)
    np.testing.assert_array_equal(masks.numpy(), np.asarray(j_res.record_mask))
    sel = np.asarray(j_res.record_mask)[:, None, :]
    diff = np.where(sel, np.abs(records.numpy() - np.asarray(j_res.records)), 0.0)
    assert diff.max() < 1e-12
    # final rays: the engine steps dead rays on, so compare the living
    alive = masks[-1].numpy()
    for rows, field in ((slice(0, 4), "positions"), (slice(4, 8), "directions")):
        np.testing.assert_allclose(
            fstate[rows].numpy()[:, alive], np.asarray(getattr(j_res.final_rays, field))[:, alive],
            atol=1e-12, err_msg=field)
    # the fold's payload is the hit's: its distance advances the ray to the
    # recorded hit point
    ran = fg.generations_ran(records, masks)
    hit = ran & torch.isfinite(fold5[:, 0])
    p0, p1 = records[:, 6:9], records[:, 9:12]
    step = (p1 - p0).norm(dim=1)
    speed = records[:, 12:15].norm(dim=1)
    torch.testing.assert_close(step[hit], (fold5[:, 0] * speed)[hit], rtol=1e-12, atol=1e-12)


def test_wide_wrapper_runs_plain_on_cpu_and_checks_inputs(twins):
    _, t_scene, _, t_rays, gens = twins.wide_inputs("mla5")
    spec = t_scene.spec
    config = TraceConfig(generation_limit=gens)
    inputs = ft.wide_kernel_inputs(spec, t_scene.params, t_rays)
    before = ft.fused_trace_wide.launches
    out = ft.fused_trace_wide(spec, config, *inputs)
    plain = ft.fused_trace_wide_plain(spec, config, *inputs)
    assert ft.fused_trace_wide.launches == before  # the plain version counts nothing
    assert len(out) == 3 and all(torch.equal(a, b) for a, b in zip(out, plain))
    state, obj_tx, prim, glass, slots, aabb = inputs[:6]
    with pytest.raises(ValueError, match="int32"):
        ft.fused_trace_wide_plain(spec, config, state, obj_tx, prim, glass, slots.long(), aabb)
    with pytest.raises(ValueError, match="aabb"):
        ft.fused_trace_wide_plain(spec, config, state, obj_tx, prim, glass, slots, aabb[:, :3])
    with pytest.raises(ValueError, match="CUDA"):
        ft.fused_trace_wide(spec, config, *(t.to("meta") for t in inputs))

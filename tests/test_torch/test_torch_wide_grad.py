"""Gradients of the staged wide backward's plain versions (K5, K6, K7)
against ``jax.grad`` of the JAX engine (float64, CPU; the tolerances of
tests/test_ops/test_fused_staged_grad.py).

On CPU tensors the autograd Functions run K2's plain version forward and
the plain versions of the staged tail (K5), group (K6) and singles (K7)
backward, so these tests pin the arithmetic the kernels are held to on
the card.
"""

import jax
import numpy as np
import pytest
import torch

from pyrayt_tpu.analysis.metrics import RmsSpotRadius as JRms
from pyrayt_tpu.analysis.metrics import rms_spot_radius as j_rms_fn
from pyrayt_tpu.config import TraceConfig as JConfig
from pyrayt_tpu.tracer import engine as j_engine
from pyrayt_tpu_torch.analysis import metrics
from pyrayt_tpu_torch.config import TraceConfig
from pyrayt_tpu_torch.ops import fused_grad as fg

RTOL = 1e-8
ATOL = 1e-12
NAMES = ("world", "prim", "glass")


def _jax_grads(j_scene, j_rays, gens, loss):
    fn = j_engine.build_trace_fn(j_scene.spec, j_scene.materials,
                                 JConfig(generation_limit=gens, fixed_loop=True))
    value, (dp, dr) = jax.value_and_grad(lambda p, r: loss(fn(p, r)), argnums=(0, 1))(
        j_scene.params, j_rays)
    return float(value), {k: np.asarray(dp[k]) for k in NAMES}, dr


def _port_grads(t_scene, t_rays, gens, loss, descriptor):
    config = TraceConfig(generation_limit=gens, fixed_loop=True)
    params = {k: v.detach().clone().requires_grad_(True) for k, v in t_scene.params.items()}
    pos = t_rays.positions.detach().clone().requires_grad_(True)
    rays = t_rays.replace(positions=pos)
    if descriptor:
        value = fg.build_fused_value_and_grad_fn(t_scene.spec, t_scene.materials, config, loss)(
            params, rays)
    else:
        value = loss(fg.build_fused_vjp_trace_fn(t_scene.spec, t_scene.materials, config)(
            params, rays))
    grads = torch.autograd.grad(value, [params[k] for k in NAMES] + [pos])
    return float(value.detach()), dict(zip(NAMES, grads[:3])), grads[3]


def _assert_close(t_grads, j_grads):
    for k in NAMES:
        np.testing.assert_allclose(t_grads[k].numpy(), j_grads[k], rtol=RTOL, atol=ATOL,
                                   err_msg=k)


@pytest.mark.parametrize("mode", ["loss_plan", "generic"])
def test_staged_grads_match_jax_on_the_5x5_array(twins, mode):
    j_scene, t_scene, j_rays, t_rays, gens = twins.wide_inputs("mla5")
    det_id = float(t_scene.spec.leaf_ids[-1])
    before = (fg.staged_tail.launches, fg.staged_group.launches)
    if mode == "loss_plan":
        j_loss, t_loss, descriptor = JRms(surface_id=det_id), metrics.RmsSpotRadius(det_id), True
    else:
        j_loss = lambda res: j_rms_fn(res, det_id)  # noqa: E731
        t_loss, descriptor = (lambda res: metrics.rms_spot_radius(res, det_id)), False
    j_value, j_grads, j_dr = _jax_grads(j_scene, j_rays, gens, j_loss)
    t_value, t_grads, t_dpos = _port_grads(t_scene, t_rays, gens, t_loss, descriptor)
    assert t_value == pytest.approx(j_value, rel=1e-12)
    _assert_close(t_grads, j_grads)
    np.testing.assert_allclose(t_dpos[:3].numpy(), np.asarray(j_dr.positions[:3]),
                               rtol=RTOL, atol=ATOL)
    # every lenslet's transform receives its own cotangent
    assert (t_grads["world"][:50].abs().sum(dim=(1, 2)) > 0).sum() > 30
    assert (fg.staged_tail.launches, fg.staged_group.launches) == before  # plain on the CPU


def test_staged_grads_match_jax_on_the_hetero_wall(twins):
    j_scene, t_scene, j_rays, t_rays, gens = twins.wide_inputs("hetero")
    det_id = float(t_scene.spec.leaf_ids[-1])
    j_value, j_grads, _ = _jax_grads(j_scene, j_rays, gens, JRms(surface_id=det_id))
    t_value, t_grads, _ = _port_grads(t_scene, t_rays, gens, metrics.RmsSpotRadius(det_id), True)
    assert t_value == pytest.approx(j_value, rel=1e-12)
    _assert_close(t_grads, j_grads)
    assert t_grads["glass"].shape[0] == 4
    assert (t_grads["glass"].abs().sum(dim=1) > 0).sum() >= 3  # three glasses


@pytest.mark.parametrize("name", ["mla5", "csg_singles"])
def test_staged_tail_passes_rays_that_did_not_run_through(twins, name):
    """K5's contract for the rays that did not run generation g (K2's rule,
    ``generations_ran``): ``dcarry`` is ``carry_bar`` bit for bit and
    ``buf`` holds the record's position and direction rows with zero hit
    cotangents, on the plain forward's records and on random rows in place
    of a dead ray's; and the plain forward leaves a dead ray's records and
    mask of g zero (the dead-row contract), so those ``buf`` rows are zero."""
    from pyrayt_tpu_torch.ops import fused_trace as ft

    _, t_scene, _, t_rays, gens = twins.wide_inputs(name)
    spec = t_scene.spec
    config = TraceConfig(generation_limit=gens, fixed_loop=True)
    inputs = ft.wide_kernel_inputs(spec, t_scene.params, t_rays)
    state0, glass = inputs[0], inputs[3]
    records, masks, _, fold5, _ = ft.fused_trace_wide_plain(spec, config, *inputs,
                                                            save_fold=True)
    ran = fg.generations_ran(records, masks)
    rng = np.random.default_rng(3)
    n = masks.shape[1]
    dead_total = 0
    for g in range(1, gens):
        dead = ~ran[g]
        assert not records[g][:, dead].any() and not masks[g][dead].any()
        stopped = ~masks[g - 1]  # random rows there: the ray still did not run g
        rec_random = records[g].clone()
        rec_random[:, stopped] = torch.as_tensor(rng.standard_normal((15, int(stopped.sum()))))
        for rec in (records[g], rec_random):
            carry = torch.as_tensor(rng.standard_normal((11, n)))
            d_rec = torch.as_tensor(rng.standard_normal((15, n))) * masks[g]
            buf, dcarry, _ = fg.staged_tail(spec, config, state0, rec, masks[g], masks[g - 1],
                                            fold5[g], glass, carry, d_rec=d_rec)
            assert torch.equal(dcarry[:, dead], carry[:, dead])
            assert torch.equal(buf[0:3, dead], rec[6:9, dead])
            assert torch.equal(buf[3:6, dead], rec[12:15, dead])
            assert not buf[6:10, dead].any()
        dead_total += int(dead.sum())
    assert dead_total > 0

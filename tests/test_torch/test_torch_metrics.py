"""The port's trace metrics against the JAX package's, float64: values and
gradients with respect to the records, on one synthetic trace result made
with NumPy from a seed (3 generations x 40 rays, two surfaces, a few
near-axial tilts, some hits past the detector edge).  Tolerance rtol 1e-12,
atol 1e-14: the same formulas, summed in the same order."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyrayt_tpu.analysis import metrics as jm
from pyrayt_tpu_torch.analysis import metrics as tm
from pyrayt_tpu_torch.ops import fused_grad as fg

TOL = dict(rtol=1e-12, atol=1e-14)
G, N = 3, 40


def _trace(seed=11):
    """(records (G, 15, n), masks (G, n)) of a made-up trace."""
    rng = np.random.default_rng(seed)
    records = rng.normal(0.0, 0.4, (G, 15, N))
    records[:, tm.COL["surface"]] = rng.choice([1.0, 3.0], (G, N), p=[0.3, 0.7])
    records[:, tm.COL["y_tilt"], :4] = rng.uniform(-2e-6, 2e-6, (G, 4))  # near-axial
    records[:, tm.COL["y1"], 4:8] = rng.uniform(0.52, 0.6, (G, 4))  # past the edge
    masks = rng.uniform(size=(G, N)) < 0.8
    masks[2, ::3] = False
    return records, masks


def _results(records, masks, requires_grad=False):
    """The same trace result for both packages (metrics read only
    ``records`` and ``record_mask``)."""
    t_rec = torch.tensor(records, requires_grad=requires_grad)
    t_res = types.SimpleNamespace(records=t_rec, record_mask=torch.tensor(masks))
    j_res = types.SimpleNamespace(records=jnp.asarray(records), record_mask=jnp.asarray(masks))
    return t_res, j_res


# name -> (port function, JAX function) of a trace result, both scalar
SCALAR_METRICS = {
    "rms_spot_radius_last": (tm.rms_spot_radius, jm.rms_spot_radius),
    "rms_spot_radius_surface": (lambda r: tm.rms_spot_radius(r, 3.0),
                                lambda r: jm.rms_spot_radius(r, 3.0)),
    "focus_error": (lambda r: tm.focus_error(r, 0.3, surface_id=3.0),
                    lambda r: jm.focus_error(r, 0.3, surface_id=3.0)),
    "focus_error_last": (lambda r: tm.focus_error(r, 0.3), lambda r: jm.focus_error(r, 0.3)),
    "soft_focus_error": (lambda r: tm.soft_focus_error(r, 0.3, 3.0, (0.55, 0.5), 0.05),
                         lambda r: jm.soft_focus_error(r, 0.3, 3.0, (0.55, 0.5), 0.05)),
    "soft_rms_spot_radius": (lambda r: tm.soft_rms_spot_radius(r, 3.0, (0.55, 0.5)),
                             lambda r: jm.soft_rms_spot_radius(r, 3.0, (0.55, 0.5))),
    "RmsSpotRadius": (tm.RmsSpotRadius(1.0), jm.RmsSpotRadius(1.0)),
    "FocusError": (tm.FocusError(0.2, 3.0, 1e-6), jm.FocusError(0.2, 3.0, 1e-6)),
    "SoftFocusError": (tm.SoftFocusError(0.3, 3.0, (0.55, 0.5), 0.05),
                       jm.SoftFocusError(0.3, 3.0, (0.55, 0.5), 0.05)),
}


@pytest.mark.parametrize("name", sorted(SCALAR_METRICS))
def test_metric_values_and_grads_match_jax(name):
    t_fn, j_fn = SCALAR_METRICS[name]
    records, masks = _trace()
    t_res, _ = _results(records, masks, requires_grad=True)
    value = t_fn(t_res)
    (grad,) = torch.autograd.grad(value, t_res.records)

    def j_value(rec):
        return j_fn(types.SimpleNamespace(records=rec, record_mask=jnp.asarray(masks)))

    j_val, j_grad = jax.value_and_grad(j_value)(jnp.asarray(records))
    assert float(value.detach()) == pytest.approx(float(j_val), rel=1e-12)
    np.testing.assert_allclose(grad.numpy(), np.asarray(j_grad), **TOL)
    assert np.abs(grad.numpy()).max() > 0


def test_masks_and_intercepts_match_jax():
    records, masks = _trace()
    t_res, j_res = _results(records, masks)
    np.testing.assert_array_equal(tm.surface_mask(t_res, 3.0).numpy(),
                                  np.asarray(jm.surface_mask(j_res, 3.0)))
    np.testing.assert_array_equal(tm.last_generation_mask(t_res).numpy(),
                                  np.asarray(jm.last_generation_mask(j_res)))
    for surface in (None, 1.0):
        t_val, t_mask = tm.axis_intercepts(t_res, surface_id=surface)
        j_val, j_mask = jm.axis_intercepts(j_res, surface_id=surface)
        np.testing.assert_allclose(t_val.numpy(), np.asarray(j_val), **TOL)
        np.testing.assert_array_equal(t_mask.numpy(), np.asarray(j_mask))
    for t_arr, j_arr in zip(tm.spot_diagram_points(t_res, 1.0), jm.spot_diagram_points(j_res, 1.0)):
        np.testing.assert_array_equal(t_arr.numpy(), np.asarray(j_arr))
    w_t = tm.detector_weights(t_res, 3.0, (0.55, 0.5), 0.05)
    np.testing.assert_allclose(w_t.numpy(), np.asarray(jm.detector_weights(j_res, 3.0, (0.55, 0.5),
                                                                           0.05)), **TOL)
    assert tm.COL == jm.COL


def test_elementwise_helpers_match_jax():
    rng = np.random.default_rng(2)
    values = rng.normal(0.0, 1.0, (3, 50))
    mask = rng.uniform(size=(3, 50)) < 0.6
    weights = rng.uniform(size=(3, 50))
    t_vals = torch.tensor(values)
    pairs = [
        (tm.smoothstep(t_vals), jm.smoothstep(jnp.asarray(values))),
        (tm.window_weights(t_vals, 0.8, 0.1), jm.window_weights(jnp.asarray(values), 0.8, 0.1)),
        (tm.masked_mean(t_vals, torch.tensor(mask)), jm.masked_mean(jnp.asarray(values), mask)),
        (tm.masked_mean(t_vals, torch.tensor(mask), axis=1),
         jm.masked_mean(jnp.asarray(values), mask, axis=1)),
        (tm.weighted_mean(t_vals, torch.tensor(weights)),
         jm.weighted_mean(jnp.asarray(values), jnp.asarray(weights))),
        (tm.masked_mean(t_vals, torch.zeros(3, 50, dtype=torch.bool)),
         jm.masked_mean(jnp.asarray(values), np.zeros((3, 50), bool))),
    ]
    for t_out, j_out in pairs:
        np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out), **TOL)


def test_descriptors_are_hashable_and_call_their_metric():
    records, masks = _trace()
    t_res, _ = _results(records, masks)
    soft = tm.SoftFocusError(0.3, 3.0, (0.55, 0.5), 0.05)
    assert soft == tm.SoftFocusError(0.3, 3.0, (0.55, 0.5), 0.05)
    assert len({soft, tm.RmsSpotRadius(3.0), tm.FocusError(0.3, 3.0), tm.RmsSpotRadius(3.0)}) == 3
    assert float(soft(t_res)) == float(tm.soft_focus_error(t_res, 0.3, 3.0, (0.55, 0.5), 0.05))
    assert float(tm.RmsSpotRadius(3.0)(t_res)) == float(tm.rms_spot_radius(t_res, 3.0))


def test_loss_plans_reproduce_their_metric_and_its_gradient():
    """Each plan's scalars give the metric's value, and its per-generation
    record cotangent equals autograd of the metric (masked rows)."""
    records, masks = _trace()
    losses = [tm.RmsSpotRadius(3.0), tm.FocusError(0.3, 3.0),
              tm.SoftFocusError(0.3, 3.0, (0.55, 0.5), 0.05)]
    for loss in losses:
        t_res, _ = _results(records, masks, requires_grad=True)
        value = loss(t_res)
        (grad,) = torch.autograd.grad(value, t_res.records)
        plan = fg.loss_plan(loss)
        rec, m = torch.tensor(records), torch.tensor(masks)
        scal = plan.scalars(rec, m)
        assert float(plan.value(scal)) == pytest.approx(float(value.detach()), rel=1e-12)
        row = plan.row(scal, torch.tensor(1.0, dtype=torch.float64))
        drec = torch.stack([plan.drec(rec[g], m[g], row) for g in range(G)])
        torch.testing.assert_close(drec, grad, rtol=1e-9, atol=1e-12)


def test_zero_spot_radius_gives_a_zero_gradient():
    """All detector hits at one point: the metric is 0, autograd of its
    sqrt is NaN, the loss plan's guard gives zero (as the JAX plan does)."""
    records, masks = _trace()
    records[:, tm.COL["y1"]] = 0.25
    records[:, tm.COL["z1"]] = -0.1
    rec, m = torch.tensor(records), torch.tensor(masks)
    plan = fg.loss_plan(tm.RmsSpotRadius(3.0))
    scal = plan.scalars(rec, m)
    assert float(plan.value(scal)) == 0.0
    row = plan.row(scal, torch.tensor(1.0, dtype=torch.float64))
    drec = torch.stack([plan.drec(rec[g], m[g], row) for g in range(G)])
    assert torch.equal(drec, torch.zeros_like(drec))

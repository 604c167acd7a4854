"""The loss-fused backward's plain version (``fused_bwd_loss_plain``, the
oracle of the CUDA kernel K3) against the JAX package's loss-fused Pallas
kernel in interpret mode, float64, rtol 1e-8, atol 1e-10: the gradients of
each recognized loss with respect to the scene params and to the initial
rays, whose homogeneous w rows are zero in both kernels.  This file holds
the spot-radius plan and its zero-radius case; the focus plans are in
test_torch_grad_plans_focus.py and test_torch_grad_plans_soft.py (each
interpret-mode gradient takes ~20 s)."""

import jax
import numpy as np
import pytest
import torch

from pyrayt_tpu.analysis import metrics as j_metrics
from pyrayt_tpu.config import TraceConfig as JConfig
from pyrayt_tpu.ops import fused_grad as j_fused_grad
from pyrayt_tpu_torch.analysis import metrics
from pyrayt_tpu_torch.config import TraceConfig
from pyrayt_tpu_torch.ops import fused_grad as fg

TOL = dict(rtol=1e-8, atol=1e-10)
RAY_FIELDS = ("positions", "directions", "wavelength")


def _descriptors(name, sid):
    """The same recognized loss in both packages."""
    if name == "rms":
        return metrics.RmsSpotRadius(sid), j_metrics.RmsSpotRadius(sid)
    if name == "focus":
        return metrics.FocusError(1.2, sid), j_metrics.FocusError(1.2, sid)
    args = (1.2, sid, (0.5, 0.5), 0.05)
    return metrics.SoftFocusError(*args), j_metrics.SoftFocusError(*args)


def assert_plan_matches_jax(twins, name, n_rays=None):
    """Value and gradients of one loss plan on the condenser, port against
    JAX; returns the port's gradients."""
    j_scene, t_scene, j_rays, t_rays, gens = twins.grad_inputs("condenser")
    if n_rays is not None:
        j_rays = jax.tree_util.tree_map(lambda x: x[..., :n_rays], j_rays)
        t_rays = t_rays.replace(**{f: getattr(t_rays, f)[..., :n_rays].clone()
                                   for f in ("positions", "directions") + t_rays.fields})
    t_loss, j_loss = _descriptors(name, float(t_scene.spec.leaf_ids[-1]))
    j_fn = j_fused_grad.build_fused_value_and_grad_fn(
        j_scene.spec, j_scene.materials, JConfig(generation_limit=gens), j_loss, interpret=True)
    j_value, (j_params, j_d_rays) = jax.value_and_grad(j_fn, argnums=(0, 1))(j_scene.params,
                                                                             j_rays)
    fn = fg.build_fused_value_and_grad_fn(
        t_scene.spec, t_scene.materials, TraceConfig(generation_limit=gens), t_loss)
    params = {k: v.clone().requires_grad_(True) for k, v in t_scene.params.items()}
    ray_leaves = {f: getattr(t_rays, f).clone().requires_grad_(True) for f in RAY_FIELDS}
    value = fn(params, t_rays.replace(**ray_leaves))
    grads = torch.autograd.grad(value, list(params.values()) + list(ray_leaves.values()))
    grads = dict(zip(list(params) + list(ray_leaves), grads))
    assert float(value.detach()) == pytest.approx(float(j_value), rel=1e-12, abs=1e-15)
    for key in params:
        np.testing.assert_allclose(grads[key].numpy(), np.asarray(j_params[key]), err_msg=key,
                                   **TOL)
    for key in RAY_FIELDS:
        np.testing.assert_allclose(grads[key].numpy(), np.asarray(getattr(j_d_rays, key)),
                                   err_msg=key, **TOL)
    # the w rows: zero in both kernels (the XLA engine would give a value)
    for key in ("positions", "directions"):
        np.testing.assert_array_equal(grads[key][3].numpy(), 0.0)
    return grads


def test_rms_plan_matches_jax_kernel(twins):
    grads = assert_plan_matches_jax(twins, "rms")
    assert np.abs(grads["world"].numpy()).max() > 1e-6


def test_zero_spot_radius_plan_gives_zero_not_nan(twins):
    """One ray on the detector: the spot radius is 0 and both kernels give
    a zero gradient (autograd of the metric's sqrt would give NaN)."""
    grads = assert_plan_matches_jax(twins, "rms", n_rays=1)
    for key, grad in grads.items():
        assert torch.equal(grad, torch.zeros_like(grad)), key

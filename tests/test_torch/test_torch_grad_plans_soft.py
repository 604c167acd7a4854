"""The SoftFocusError plan of the loss-fused backward against the JAX kernel
in interpret mode (see test_torch_grad_plans.py)."""

import numpy as np

from test_torch_grad_plans import assert_plan_matches_jax


def test_soft_focus_plan_matches_jax_kernel(twins):
    grads = assert_plan_matches_jax(twins, "soft")
    assert np.abs(grads["world"].numpy()).max() > 1e-6
    assert np.abs(grads["wavelength"].numpy()).max() > 0  # dispersion reaches the rays

"""``examples_torch/microlens_array.py`` against the JAX package's
``examples/microlens_array.py`` at float64 on the CPU: ``main`` at 4x4
lenslets and 1024 rays (value and d value / d r within 1e-9 relative),
``main_per_lenslet`` at 4x4, 1024 rays and 3 steps (loss history and
radii within 1e-9 relative); every printed line equal."""

import numpy as np
import torch

from torch_examples import line_faults, load, run

RTOL = 1e-9


def test_main_value_gradient_and_lines_match_jax():
    (j_value, j_grad), expected = run(load("jax", "microlens_array").main, n=4, n_rays=1024)
    (value, grad), lines = run(load("torch", "microlens_array").main, n=4, n_rays=1024,
                               device="cpu", dtype=torch.float64)
    assert not line_faults(lines, expected)
    assert lines[0].startswith("4x4 lenslets")
    np.testing.assert_allclose(value, j_value, rtol=RTOL, atol=0)
    np.testing.assert_allclose(grad, j_grad, rtol=RTOL, atol=0)
    assert value > 0 and abs(grad) > 0


def test_per_lenslet_history_radii_and_lines_match_jax():
    (j_history, j_theta), expected = run(load("jax", "microlens_array").main_per_lenslet,
                                         n=4, n_rays=1024, steps=3)
    (history, theta), lines = run(load("torch", "microlens_array").main_per_lenslet,
                                  n=4, n_rays=1024, steps=3, device="cpu",
                                  dtype=torch.float64)
    assert not line_faults(lines, expected)
    np.testing.assert_allclose(history, j_history, rtol=RTOL, atol=0)
    assert theta["radii"].dtype == torch.float64 and theta["radii"].shape == (16,)
    np.testing.assert_allclose(theta["radii"].numpy(), np.asarray(j_theta["radii"]),
                               rtol=RTOL, atol=0)
    np.testing.assert_allclose(float(theta["det_x"]), float(j_theta["det_x"]), rtol=RTOL,
                               atol=0)
    assert min(history) < history[0]

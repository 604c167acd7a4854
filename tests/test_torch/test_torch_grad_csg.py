"""Gradient parity on the network-CSG union blob and the nine-leaf imager
(see test_torch_grad.py): autograd of the port's plain engine and its
``fused_bwd_plain`` sweep against ``jax.grad`` of the JAX engine, float64,
rtol 1e-8, atol 1e-10."""

import pytest

from test_torch_grad import assert_param_grads_match


@pytest.mark.parametrize("path", ["engine", "fused_bwd_plain"])
@pytest.mark.parametrize("name", ["union_blob", "imager"])
def test_param_grads_match_jax(twins, name, path):
    assert_param_grads_match(twins, name, path)

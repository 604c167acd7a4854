"""The port's debug switches (``pyrayt_tpu_torch.debug``) beside the JAX
package's (tests/test_tracer/test_debug.py): a NaN raises at the operation
that made it, infinities (a miss is +inf) do not, a NaN in the backward
pass is caught by autograd's anomaly mode, the previous state comes back
on exit, and a whole trace runs clean under the sanitizer with the same
frame as the JAX package's sanitized trace (float64, CPU)."""

import numpy as np
import pytest
import torch

import pyrayt_tpu as j_pyrayt
import pyrayt_tpu_torch as t_pyrayt
from pyrayt_tpu import debug as j_debug
from pyrayt_tpu.scene import fresh_ids as j_fresh_ids
from pyrayt_tpu_torch import debug
from pyrayt_tpu_torch.scene import fresh_ids as t_fresh_ids


def test_debug_nans_raises_at_the_source():
    with pytest.raises(FloatingPointError, match="log"):
        with debug.debug_nans():
            torch.log(torch.tensor(-1.0)) + 1.0
    # state restored: NaN flows silently again, anomaly mode is off
    assert torch.isnan(torch.log(torch.tensor(-1.0)))
    assert not torch.is_anomaly_enabled()
    with debug.debug_nans(False):
        assert torch.isnan(torch.log(torch.tensor(-1.0)))


def test_infinities_are_legal():
    with debug.debug_nans():
        hit = torch.where(torch.tensor([1.0, -1.0]) > 0, torch.tensor(2.0), torch.inf)
        assert torch.isinf(hit[1]) and float(hit.min()) == 2.0


def test_debug_nans_catches_the_backward_pass():
    x = torch.tensor(0.0, requires_grad=True)
    with debug.debug_nans():
        y = torch.sqrt(x) * 0.0  # forward 0; backward 0 * inf = NaN
        with pytest.raises(RuntimeError, match="nan"):
            y.backward()


def test_eager_mode_runs_code_unchanged():
    with debug.eager_mode():
        assert float(torch.tensor(2.0) * 3) == 6.0


def _prism_trace(pkg, fresh_ids, **kw):
    with fresh_ids():
        prism = pkg.components.equilateral_prism(1.0, 1.0, material=pkg.materials.glass["BK7"])
        det = pkg.components.baffle((20.0, 20.0)).move_x(5.0)
        return pkg.RayTracer(pkg.components.LineOfRays(0.3).move_x(-2.0),
                             [prism.rotate_y(-30), det], rays_per_source=8, generation_limit=6,
                             **kw).trace()


def test_sanitized_trace_is_nan_free_and_matches_jax():
    with debug.sanitize():
        t_frame = _prism_trace(t_pyrayt, t_fresh_ids, device="cpu", dtype=torch.float64)
    with j_debug.debug_nans():
        j_frame = _prism_trace(j_pyrayt, j_fresh_ids)
    assert len(t_frame) > 0 and list(t_frame.columns) == list(j_frame.columns)
    np.testing.assert_allclose(t_frame.to_numpy(), j_frame.to_numpy(), rtol=1e-9, atol=1e-12)

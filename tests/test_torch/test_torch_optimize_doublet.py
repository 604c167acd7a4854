"""``build_objective`` gradients on a 60-ray version of the achromatic
doublet of examples/lens_design.py (SoftFocusError, 8 generations),
against the JAX package's (see test_torch_optimize.py)."""

import numpy as np
import torch

from test_torch_optimize import (
    DIAMETER,
    FOCUS,
    R0,
    TORCH_NS,
    _assert_routes_match_jax,
    _detector_id,
    doublet,
    doublet_rays,
)


def test_doublet_objective_grads_match_jax(monkeypatch):
    log_r0 = np.log(np.abs(R0))
    sid = _detector_id(TORCH_NS, lambda m: doublet(m, torch.tensor(log_r0)))

    def soft(m):
        return m.metrics.SoftFocusError(FOCUS, sid, half_widths=(DIAMETER / 2, DIAMETER / 2),
                                        ramp=DIAMETER / 20)

    _assert_routes_match_jax(
        monkeypatch, lambda m, th: doublet(m, th["log_r"]), doublet_rays, soft,
        dict(generation_limit=8, fixed_loop=True), {"log_r": log_r0},
        [("engine", soft(TORCH_NS)), ("kernel", soft(TORCH_NS))])

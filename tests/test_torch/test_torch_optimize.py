"""``build_objective`` gradients with respect to theta, through the
differentiable scene rebuild, against the JAX package's ``build_objective``
(float64, rtol 1e-8, atol 1e-10): the singlet of
tests/test_analysis/test_optimize.py here, and a 60-ray version of the
achromatic doublet of examples/lens_design.py in
test_torch_optimize_doublet.py.

Each port objective is taken three ways: its CPU route (autograd of the
plain engine), and the two kernel routes forced on CPU tensors, where the
loss-fused (K3) and generic (K4) Functions run their plain versions.  The
JAX objective differentiates its XLA engine.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pyrayt_tpu.components as j_comp
import pyrayt_tpu.materials as j_matl
from pyrayt_tpu.analysis import metrics as j_metrics
from pyrayt_tpu.analysis.optimize import build_objective as j_build_objective
from pyrayt_tpu.config import TraceConfig as JConfig
from pyrayt_tpu.scene.objects import fresh_ids as j_fresh_ids
from pyrayt_tpu.tracer.rayset import concatenate as j_concatenate
import pyrayt_tpu_torch.components as t_comp
import pyrayt_tpu_torch.materials as t_matl
from pyrayt_tpu_torch.analysis import build_objective, metrics
from pyrayt_tpu_torch.config import TraceConfig
from pyrayt_tpu_torch.ops import fused_grad as fg
from pyrayt_tpu_torch.ops import fused_trace as ft
from pyrayt_tpu_torch.scene.objects import fresh_ids as t_fresh_ids
from pyrayt_tpu_torch.tracer.rayset import concatenate as t_concatenate

TOL = dict(rtol=1e-8, atol=1e-10)
JAX_NS = types.SimpleNamespace(comp=j_comp, matl=j_matl, metrics=j_metrics, xp=jnp,
                               fresh_ids=j_fresh_ids, concatenate=j_concatenate)
TORCH_NS = types.SimpleNamespace(comp=t_comp, matl=t_matl, metrics=metrics, xp=torch,
                                 fresh_ids=t_fresh_ids, concatenate=t_concatenate)


def singlet(m, theta):
    lens = m.comp.thick_lens(r1=theta["r1"], r2=-theta["r1"], thickness=0.1, aperture=0.8,
                             material=m.matl.glass["ideal"], r1_sign=1, r2_sign=-1)
    return [lens, m.comp.baffle((3.0, 3.0)).move_x(2.0)]


def singlet_rays(m):
    source = m.comp.LineOfRays(0.4).move_x(-1.0)
    return source.generate_rays(16) if m is JAX_NS else source.generate_rays(
        16, device="cpu", dtype=torch.float64)


DIAMETER, FOCUS = 25.4, 50.0
R0 = np.array([32.0, -24.0, -24.0, -120.0])  # the doublet's (+, -, -, -) start radii


def doublet(m, log_mags):
    radii = m.xp.asarray(np.sign(R0)) * m.xp.exp(log_mags)
    l1 = m.comp.thick_lens(radii[0], radii[1], 8.0, aperture=DIAMETER,
                           material=m.matl.glass["BK7"], r1_sign=1, r2_sign=-1)
    l2 = m.comp.thick_lens(radii[2], radii[3], 2.0, aperture=DIAMETER,
                           material=m.matl.glass["SF2"], r1_sign=-1, r2_sign=-1).move_x(5.05)
    return [l1, l2, m.comp.baffle((DIAMETER, DIAMETER)).move_x(FOCUS)]


def doublet_rays(m, n_radii=10, wavelengths=(0.45, 0.5, 0.55, 0.6, 0.65, 0.7)):
    """examples/lens_design.py:design_rays: 6 x 10 = 60 rays."""
    kw = {} if m is JAX_NS else dict(device="cpu", dtype=torch.float64)
    sets = [m.comp.LineOfRays(0.45 * DIAMETER / 2, wavelength=wl).move_x(-10.0)
            .move_y(DIAMETER / 8).generate_rays(n_radii, **kw) for wl in wavelengths]
    rays = m.concatenate(sets)
    ids = m.xp.arange(rays.n_rays, dtype=rays.positions.dtype)
    return rays.replace(id=ids)


def _port_grads(build, rays, loss, config, theta0, route, monkeypatch):
    """(value, grad) of the port objective along ``route``: "engine" (the
    CPU dispatch) or "kernel" (the K3/K4 Functions, forced on CPU)."""
    if route == "kernel":
        monkeypatch.setattr(ft, "pick_fused", lambda *args, **kwargs: True)
    counts = (fg.fused_bwd_loss.launches, fg.fused_bwd.launches)
    objective = build_objective(build, rays, loss, config)
    theta = {k: torch.tensor(v, dtype=torch.float64, requires_grad=True)
             for k, v in theta0.items()}
    value = objective(theta)
    grads = torch.autograd.grad(value, list(theta.values()))
    # on CPU tensors the wrappers run their plain versions and count nothing
    assert (fg.fused_bwd_loss.launches, fg.fused_bwd.launches) == counts
    monkeypatch.undo()
    return float(value.detach()), {k: g.numpy() for k, g in zip(theta, grads)}


def _jax_grads(build, rays, loss, config, theta0):
    objective = j_build_objective(build, rays, loss, config)
    theta = {k: jnp.asarray(v) for k, v in theta0.items()}
    value, grads = jax.value_and_grad(objective)(theta)
    return float(value), {k: np.asarray(g) for k, g in grads.items()}


def _detector_id(m, build):
    with m.fresh_ids():
        return float(build(m)[-1].get_id())


def _assert_routes_match_jax(monkeypatch, build, rays_of, losses, config, theta0, routes):
    j_value, j_grads = _jax_grads(lambda th: build(JAX_NS, th), rays_of(JAX_NS),
                                  losses(JAX_NS), JConfig(**config), theta0)
    for route, loss in routes:
        value, grads = _port_grads(lambda th: build(TORCH_NS, th), rays_of(TORCH_NS), loss,
                                   TraceConfig(**config), theta0, route, monkeypatch)
        assert value == pytest.approx(j_value, rel=1e-12), route
        for k in theta0:
            np.testing.assert_allclose(grads[k], j_grads[k], err_msg=f"{route} {k}", **TOL)
            assert np.abs(grads[k]).max() > 0


def test_singlet_objective_grads_match_jax(monkeypatch):
    sid = _detector_id(TORCH_NS, lambda m: singlet(m, {"r1": 3.0}))
    t_loss = metrics.RmsSpotRadius(sid)

    def generic(result):  # not a descriptor: the K4 route
        return metrics.rms_spot_radius(result, sid)

    _assert_routes_match_jax(
        monkeypatch, singlet, singlet_rays, lambda m: m.metrics.RmsSpotRadius(sid),
        dict(generation_limit=4, fixed_loop=True), {"r1": 3.0},
        [("engine", t_loss), ("kernel", t_loss), ("kernel", generic)])

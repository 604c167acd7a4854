"""The port's ``optimize`` loop, checkpoints and gradient check, float64:
five Adam steps on the singlet objective against the JAX package's
``optimize`` with ``optax.adam`` (same iterates within 1e-8), the cosine
schedule against ``optax.cosine_decay_schedule``, a resumed run against
an uninterrupted one, and ``check_gradients`` on a thick-lens objective."""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pyrayt_tpu.analysis.optimize import build_objective as j_build_objective
from pyrayt_tpu.analysis.optimize import optimize as j_optimize
from pyrayt_tpu.config import TraceConfig as JConfig
from pyrayt_tpu_torch import components as comp
from pyrayt_tpu_torch import materials as matl
from pyrayt_tpu_torch.analysis import (
    build_objective,
    check_gradients,
    finite_difference_grad,
    latest_step,
    metrics,
    optimize,
    restore_checkpoint,
    save_checkpoint,
)
from pyrayt_tpu_torch.config import TraceConfig
from test_torch_optimize import JAX_NS, TORCH_NS, singlet, singlet_rays


def quadratic(theta):
    return (theta["a"] - 3.0) ** 2 + (theta["b"] + 1.0) ** 4 + theta["a"] * theta["b"]


def _theta(a=0.0, b=0.0):
    return {"a": torch.tensor(a, dtype=torch.float64), "b": torch.tensor(b, dtype=torch.float64)}


def test_five_adam_steps_match_optax_on_the_singlet():
    config = dict(generation_limit=4, fixed_loop=True)
    j_objective = j_build_objective(lambda th: singlet(JAX_NS, th), singlet_rays(JAX_NS),
                                    JAX_NS.metrics.rms_spot_radius, JConfig(**config))
    j_theta, j_history = j_optimize(j_objective, {"r1": jnp.asarray(3.0)}, steps=5,
                                    learning_rate=5e-2)
    objective = build_objective(lambda th: singlet(TORCH_NS, th), singlet_rays(TORCH_NS),
                                metrics.rms_spot_radius, TraceConfig(**config))
    theta, history = optimize(objective, {"r1": torch.tensor(3.0, dtype=torch.float64)},
                              steps=5, learning_rate=5e-2)
    np.testing.assert_allclose(history, j_history, rtol=1e-10, atol=0)
    assert float(theta["r1"]) == pytest.approx(float(j_theta["r1"]), abs=1e-8)
    assert history[-1] < history[0]
    # one more step from the returned iterate reproduces the last loss
    _, again = optimize(objective, theta, steps=1)
    assert again[0] == pytest.approx(min(history), rel=1e-12)


def test_cosine_schedule_matches_optax():
    steps = 12
    j_theta, j_history = j_optimize(
        quadratic, {"a": jnp.asarray(0.0), "b": jnp.asarray(0.0)}, steps=steps,
        optimizer=optax.adam(optax.cosine_decay_schedule(0.3, steps)))
    theta, history = optimize(
        quadratic, _theta(), steps=steps, learning_rate=0.3,
        scheduler=lambda opt: torch.optim.lr_scheduler.CosineAnnealingLR(opt, T_max=steps))
    np.testing.assert_allclose(history, j_history, rtol=1e-10, atol=1e-14)
    for k in theta:
        assert float(theta[k]) == pytest.approx(float(j_theta[k]), abs=1e-10)


def test_optimizer_factory_and_best_iterate():
    theta, history = optimize(lambda th: (th - 3.0) ** 2, torch.tensor(0.0, dtype=torch.float64),
                              steps=200, optimizer=lambda p: torch.optim.SGD(p, lr=0.1))
    assert float(theta) == pytest.approx(3.0, abs=1e-3)
    assert history[-1] < 1e-6 and min(history) == history[-1]


def test_resumed_run_matches_uninterrupted(tmp_path):
    def scheduler(opt):
        return torch.optim.lr_scheduler.CosineAnnealingLR(opt, T_max=30)

    full_theta, full_history = optimize(quadratic, _theta(), steps=30, learning_rate=5e-2,
                                        scheduler=scheduler)
    path = str(tmp_path / "opt.ckpt")
    optimize(quadratic, _theta(), steps=20, learning_rate=5e-2, scheduler=scheduler,
             checkpoint_path=path, checkpoint_every=10)
    assert latest_step(path) == 20
    theta, history = optimize(quadratic, _theta(), steps=30, learning_rate=5e-2,
                              scheduler=scheduler, checkpoint_path=path, checkpoint_every=10)
    assert history == full_history
    for k in theta:
        assert torch.equal(theta[k], full_theta[k])
    assert latest_step(path) == 30


def test_checkpoint_roundtrip(tmp_path):
    path = str(tmp_path / "sub" / "state.ckpt")
    state = {"theta": [torch.arange(3.0)], "step": 7, "history": [1.0, 0.5],
             "optimizer": {"state": {0: {"exp_avg": torch.ones(2)}}}}
    save_checkpoint(path, state)
    restored = restore_checkpoint(path)
    assert restored["step"] == 7 and restored["history"] == [1.0, 0.5]
    assert torch.equal(restored["theta"][0], torch.arange(3.0))
    assert torch.equal(restored["optimizer"]["state"][0]["exp_avg"], torch.ones(2))
    assert latest_step(path) == 7
    assert restore_checkpoint(str(tmp_path / "none.ckpt")) is None
    assert latest_step(str(tmp_path / "none.ckpt")) == -1


class _WrongSquare(torch.autograd.Function):
    """x ** 2 with a wrong derivative (3x)."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return x**2

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return 3 * x * g


def test_check_gradients_on_a_thick_lens_objective():
    def build(theta):
        lens = comp.thick_lens(r1=theta["r1"], r2=theta["r2"], thickness=theta["t"],
                               aperture=0.5, material=matl.glass["BK7"], r1_sign=1, r2_sign=-1)
        return [lens, comp.baffle((1.0, 1.0)).move_x(theta["det_x"])]

    rays = comp.ConeOfRays(cone_angle=10.0).move_x(-0.5).generate_rays(
        32, device="cpu", dtype=torch.float64)
    objective = build_objective(build, rays, metrics.rms_spot_radius,
                                TraceConfig(generation_limit=4, fixed_loop=True))
    theta = {k: torch.tensor(v, dtype=torch.float64)
             for k, v in (("r1", 1.0), ("r2", -1.0), ("t", 0.25), ("det_x", 1.0))}
    _, max_rel = check_gradients(objective, theta, eps=1e-6, rtol=1e-4)
    assert max_rel < 1e-4
    fd = finite_difference_grad(lambda th: (th**2).sum(), torch.tensor([1.0, -2.0]))
    torch.testing.assert_close(fd, torch.tensor([2.0, -4.0], dtype=torch.float64))
    with pytest.raises(AssertionError, match="outside tolerance"):
        check_gradients(lambda x: _WrongSquare.apply(x).sum(), torch.tensor([1.0, 2.0]))

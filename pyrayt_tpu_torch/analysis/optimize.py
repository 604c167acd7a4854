"""Gradient-based lens design.

Counterpart of ``pyrayt_tpu.analysis.optimize``: the objective (rebuild the
scene from parameters, trace, metric) is one differentiable program, so
each optimizer step costs one forward and one backward trace.  On the card
that is K1 then K3 (a recognized loss descriptor) or K4 (any other loss);
for a wide scene K2 then the staged backward K5-K7, or K8 with
``TraceConfig(wide_grad="fused")``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, List, Optional, Tuple

import torch

from pyrayt_tpu_torch import tracing
from pyrayt_tpu_torch.analysis.checkpoint import restore_checkpoint, save_checkpoint
from pyrayt_tpu_torch.analysis.gradcheck import _flatten
from pyrayt_tpu_torch.config import TraceConfig
from pyrayt_tpu_torch.scene.compile import compile_scene
from pyrayt_tpu_torch.scene.objects import fresh_ids
from pyrayt_tpu_torch.tracer import engine
from pyrayt_tpu_torch.tracer.rayset import RaySet

__all__ = ["build_objective", "optimize"]


def build_objective(
    build_fn: Callable,
    rays: RaySet,
    loss_fn: Callable,
    config: Optional[TraceConfig] = None,
) -> Callable:
    """Differentiable objective ``theta -> scalar tensor``.

    ``build_fn(theta)`` builds the component list from parameters (tensors
    that require grad: curvatures, thicknesses, moves); ``loss_fn(result)``
    maps the TraceResult to a scalar (pyrayt_tpu_torch.analysis.metrics).
    The rebuild runs under ``fresh_ids`` so the SceneSpec is the same every
    call, and the scene's params take the rays' dtype and device: the rays
    decide where the objective runs, nothing is moved.

    Dispatch (``ops.fused_grad.pick_fused_grad``: the rule of ``trace()``,
    ``ops.fused_trace.pick_fused``, plus the limits of the wide backward's
    table reduce, past which a scene runs the plain engine): CUDA
    rays with a supported scene run the kernels, the loss-fused K3 for a
    recognized descriptor (``RmsSpotRadius``, ``FocusError``,
    ``SoftFocusError``) and the generic K4 otherwise (a wide scene: K2,
    then K5 in its loss or generic mode, K6 and K7, or with
    ``wide_grad="fused"`` K8 in either mode); ``use_fused=False``,
    custom Python materials and CPU rays differentiate the plain engine
    with autograd.  ``config`` is forced to ``fixed_loop=True``.
    """
    from pyrayt_tpu_torch.ops import fused_grad

    config = config or TraceConfig(fixed_loop=True)
    if not config.fixed_loop:
        config = dataclasses.replace(config, fixed_loop=True)
    fused_loss = fused_grad.loss_plan(loss_fn) is not None

    def objective(theta):
        with fresh_ids():
            with tracing.span("objective.build"):
                components = build_fn(theta)
            scene = compile_scene(components, device=rays.device, dtype=rays.dtype)
        spec, materials = scene.spec, scene.materials
        with tracing.span("objective.loss"):
            if fused_grad.pick_fused_grad(spec, config, rays.device, rays.n_rays):
                if fused_loss:
                    value = fused_grad.build_fused_value_and_grad_fn(spec, materials, config,
                                                                     loss_fn)
                    return value(scene.params, rays)
                trace = fused_grad.build_fused_vjp_trace_fn(spec, materials, config)
            else:
                trace = engine.build_trace_fn(spec, materials, config)
            return loss_fn(trace(scene.params, rays))

    return objective


def optimize(
    objective: Callable,
    theta0,
    steps: int = 100,
    optimizer: Optional[Callable] = None,
    learning_rate: float = 1e-2,
    checkpoint_path: Optional[str] = None,
    checkpoint_every: int = 10,
    scheduler: Optional[Callable] = None,
) -> Tuple[object, List[float]]:
    """Minimize a differentiable objective over ``theta0`` (a tensor or a
    dict / list / tuple of tensors, on any device; nothing is moved).

    ``optimizer`` is a factory ``params -> torch.optim.Optimizer``; the
    default is ``torch.optim.Adam(params, lr=learning_rate)`` (the defaults
    of ``optax.adam``: betas 0.9 / 0.999, eps 1e-8 outside the square
    root).  ``scheduler`` is an optional factory ``optimizer -> LR
    scheduler``, stepped after every optimizer step;
    ``lambda o: CosineAnnealingLR(o, T_max=steps)`` is
    ``optax.cosine_decay_schedule(learning_rate, steps)``.

    With ``checkpoint_path`` set, the loop saves the parameters, optimizer
    and scheduler state, step, loss history and best iterate every
    ``checkpoint_every`` steps and at the end (analysis/checkpoint.py), and
    resumes from an existing file: a killed and restarted run ends where an
    uninterrupted one does (the update rule is deterministic).

    Returns ``(theta_best, loss_history)``: the BEST-seen iterate (detached
    tensors in ``theta0``'s structure), not the last one, since trace
    losses can spike when a marginal ray crosses a TIR or vignetting edge.
    """
    leaves, rebuild = _flatten(theta0)
    params = [torch.as_tensor(t).detach().clone().requires_grad_(True) for t in leaves]
    opt = optimizer(params) if optimizer is not None else torch.optim.Adam(params, lr=learning_rate)
    sched = scheduler(opt) if scheduler is not None else None

    def snapshot():
        return rebuild([p.detach().clone() for p in params])

    best_theta = snapshot()
    best_loss = math.inf
    start = 0
    history: List[float] = []
    if checkpoint_path is not None:
        saved = restore_checkpoint(checkpoint_path)
        if saved is not None:
            with torch.no_grad():
                for p, value in zip(params, saved["theta"]):
                    p.copy_(value.to(p.device))
            best_leaves = [v.to(p.device) for p, v in zip(params, saved["best_theta"])]
            best_theta = rebuild(best_leaves)
            best_loss = float(saved["best_loss"])
            opt.load_state_dict(saved["optimizer"])
            if sched is not None:
                sched.load_state_dict(saved["scheduler"])
            start = int(saved["step"])
            history = list(saved["history"])[:start]

    def save(step):
        best_leaves, _ = _flatten(best_theta)
        save_checkpoint(
            checkpoint_path,
            {
                "theta": [p.detach() for p in params],
                "best_theta": list(best_leaves),
                "best_loss": best_loss,
                "optimizer": opt.state_dict(),
                "scheduler": sched.state_dict() if sched is not None else None,
                "step": step,
                "history": list(history),
            },
        )

    for i in range(start, steps):
        with tracing.span("optimize.step"):
            theta_in = snapshot()
            with tracing.span("optimize.zero_grad"):
                opt.zero_grad()
            with tracing.span("optimize.objective"):
                loss = objective(rebuild(params))
            with tracing.span("optimize.backward"):
                loss.backward()
            with tracing.span("optimize.update"):
                opt.step()
                if sched is not None:
                    sched.step()
            with tracing.span("optimize.readback"):  # the host waits for the card
                loss = float(loss.detach())
            history.append(loss)
            if loss < best_loss:  # the loss is evaluated at theta_in, before the update
                best_theta, best_loss = theta_in, loss
            if checkpoint_path is not None and (i + 1) % checkpoint_every == 0:
                with tracing.span("optimize.checkpoint"):
                    save(i + 1)
    if checkpoint_path is not None and start < steps:
        with tracing.span("optimize.checkpoint"):
            save(steps)
    return (best_theta if best_loss < math.inf else snapshot()), history

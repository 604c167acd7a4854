"""The design objective with the ray batch sharded over the ranks (the
sharded counterpart of ``analysis.build_objective``).

Each rank rebuilds the scene from the same parameters and traces its own
block of rays.  For a recognized loss descriptor (``RmsSpotRadius``,
``FocusError``, ``SoftFocusError``) the ranks combine the loss's float64
partial sums (``ops.fused_grad.LossPlan.partials``), a few values, in
place of the records: every rank finishes the same global scalars, K1's
records stay on their rank, and K3 builds each rank's record cotangents
from the global scalar row.  The parameter gradient is then summed over
the ranks in rank order, once a step, in float64, by an identity on
``theta`` whose backward does the sum: every rank gets the same gradient
bits, so ``analysis.optimize`` (Adam, a schedule, checkpoints) runs
unchanged on each rank and every rank takes the same steps.  Any other
loss, or a trace on the plain engine, takes the gather route of
``build_train_step``: every rank holds the global records.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import torch

from pyrayt_tpu_torch import tracing
from pyrayt_tpu_torch.analysis.gradcheck import _flatten
from pyrayt_tpu_torch.config import TraceConfig
from pyrayt_tpu_torch.parallel.mesh import Mesh, default_mesh
from pyrayt_tpu_torch.parallel.trace import gather_result
from pyrayt_tpu_torch.scene.compile import compile_scene
from pyrayt_tpu_torch.scene.objects import fresh_ids
from pyrayt_tpu_torch.tracer import engine
from pyrayt_tpu_torch.tracer.rayset import RaySet, concatenate

__all__ = ["build_sharded_objective", "shard_sources"]


def shard_sources(sources: Sequence, rays_per_source: int, mesh: Mesh,
                  dtype: torch.dtype = torch.float32) -> RaySet:
    """This rank's contiguous block of the rays that ``sources`` generate,
    ``rays_per_source`` each, in source order, on the mesh's device.

    Ray ``i`` of the whole set has id ``i``.  The set is padded with dead
    rays (:func:`~pyrayt_tpu_torch.parallel.pad_rayset`) to a multiple of
    the mesh size, so every rank holds the same count.  The sources run
    one at a time and each keeps only the rays of this rank's block, so no
    rank holds the whole set."""
    total = len(sources) * rays_per_source
    k = -(-total // mesh.size)
    lo, hi = mesh.rank * k, min((mesh.rank + 1) * k, total)
    parts = []
    for s, src in enumerate(sources):
        a, b = max(lo, s * rays_per_source), min(hi, (s + 1) * rays_per_source)
        if a >= b:
            continue
        rays = src.generate_rays(rays_per_source, device=mesh.device, dtype=dtype)
        cut = slice(a - s * rays_per_source, b - s * rays_per_source)
        parts.append(RaySet(**{name: getattr(rays, name)[..., cut].clone()
                               for name in ("positions", "directions") + RaySet.fields}))
        del rays
    block = concatenate(parts) if parts else RaySet.create(0, device=mesh.device, dtype=dtype)
    block = block.replace(id=torch.arange(lo, lo + block.n_rays, dtype=dtype,
                                          device=mesh.device))
    if block.n_rays < k:  # pad_rayset's dead rays after the last of the set
        dead = RaySet.create(k - block.n_rays, device=mesh.device, dtype=dtype)
        zero = torch.zeros_like(dead.id)
        block = concatenate([block, dead.replace(**{name: zero for name in RaySet.fields})])
    return block


class _SumOverRanks(torch.autograd.Function):
    """The identity on the parameters; its backward sums their gradient
    over the ranks in rank order, in float64 (``Mesh.ordered_sum``)."""

    @staticmethod
    def forward(ctx, mesh, *leaves):
        ctx.mesh = mesh
        return tuple(t.clone() for t in leaves)

    @staticmethod
    def backward(ctx, *grads):
        with tracing.span("parallel.grad_sum"):
            wide = [g.to(torch.float64) for g in grads]
            summed = ctx.mesh.ordered_sum(wide)
            return (None,) + tuple(s.to(g.dtype) for s, g in zip(summed, grads))


def _global_scalars(plan, mesh: Mesh) -> Callable:
    """``plan.scalars`` over every rank's rays: each round of partial sums
    summed over the ranks in rank order, then ``plan.finish``."""

    def scalars(records, masks):
        sums = torch.zeros(0, dtype=torch.float64, device=records.device)
        for partials in plan.partials:
            local = partials(records, masks, sums)
            with tracing.span("parallel.partials"):
                (total,) = mesh.ordered_sum([local])
            sums = torch.cat((sums, total))
        return plan.finish(sums).to(records.dtype)

    return scalars


def build_sharded_objective(
    build_fn: Callable,
    rays: RaySet,
    loss_fn: Callable,
    config: Optional[TraceConfig] = None,
    mesh: Optional[Mesh] = None,
) -> Callable:
    """Differentiable objective ``theta -> scalar tensor`` of the rays of
    every rank: ``analysis.build_objective`` with the ray batch sharded.

    Every rank calls it with the same ``build_fn``, ``loss_fn`` and
    ``config``, its own block of ``rays`` (:func:`shard_sources`, or
    ``shard_rayset`` of a padded set: each rank the same count) and the
    same ``theta``; the loss and the gradient (``loss.backward()``) are
    those of the loss over all the ranks' rays, the same bits on every
    rank.  ``mesh`` defaults to ``default_mesh`` on the rays' device.

    Routes, as ``build_objective`` picks them per rank (the same on every
    rank): a recognized loss on the kernels (K1, then K3 with the global
    scalar row; a wide scene K2, then the staged backward or K8) combines
    each round of the plan's partial sums, a few float64 values; any other
    loss, and the plain engine, gathers the global records on every rank
    (``parallel.trace.gather_result``) and evaluates the loss on them.
    Either way the gradient is summed over the ranks once per backward,
    O(#params) values.  Spans: ``parallel.objective`` around a call,
    ``parallel.partials`` around each round's sum over the ranks,
    ``parallel.grad_sum`` around the gradient's.
    """
    from pyrayt_tpu_torch.ops import fused_grad

    config = dataclasses.replace(config or TraceConfig(), fixed_loop=True)
    mesh = mesh if mesh is not None else default_mesh(device=rays.device)
    plan = fused_grad.loss_plan(loss_fn)
    if plan is not None:
        plan = dataclasses.replace(plan, scalars=_global_scalars(plan, mesh))

    def objective(theta):
        with tracing.span("parallel.objective"):
            leaves, rebuild = _flatten(theta)
            theta = rebuild(list(_SumOverRanks.apply(mesh, *leaves)))
            with fresh_ids():
                with tracing.span("objective.build"):
                    components = build_fn(theta)
                scene = compile_scene(components, device=rays.device, dtype=rays.dtype)
            spec, materials = scene.spec, scene.materials
            with tracing.span("objective.loss"):
                if fused_grad.pick_fused_grad(spec, config, rays.device, rays.n_rays):
                    if plan is not None:
                        return fused_grad.fused_plan_value(spec, config, plan, scene.params,
                                                           rays)
                    trace = fused_grad.build_fused_vjp_trace_fn(spec, materials, config)
                else:
                    trace = engine.build_trace_fn(spec, materials, config)
                return loss_fn(gather_result(trace(scene.params, rays), mesh))

    return objective

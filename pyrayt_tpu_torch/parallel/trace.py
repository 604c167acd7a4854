"""Sharded trace execution and the distributed training step (counterpart
of ``pyrayt_tpu.parallel.trace``).

* :func:`sharded_trace` / :func:`build_sharded_trace_fn`: each rank traces
  its block of the rays through the port's own dispatch (K1 on a narrow
  scene, K2 on a wide one, on CUDA tensors; the plain engine otherwise).
  Rays never interact, so a block's records equal a one-process trace's
  records of the same rays; only ``generations_run`` is max-reduced.
  :func:`gather_result` assembles the global result on every rank (torch
  has no global sharded array).

* :func:`build_train_step`: one SGD update of the scene parameters against
  a loss of the **global** result, as in the JAX package.  Each rank
  traces its block (K1 + K4 narrow, K2 + K5-K7 or K2 + K8 wide, else the
  plain engine under autograd), every rank evaluates the loss on the same
  gathered result, the gather's backward hands each rank the cotangent of
  its own block once, and the per-rank parameter gradients are summed in
  rank order: the domain's only real communication (O(#params) values).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch
import torch.distributed as dist

from pyrayt_tpu_torch.config import TraceConfig
from pyrayt_tpu_torch.parallel.mesh import Mesh, default_mesh, pad_rayset, shard_rayset
from pyrayt_tpu_torch.scene.compile import CompiledScene
from pyrayt_tpu_torch.tracer import engine
from pyrayt_tpu_torch.tracer.rayset import RaySet

__all__ = ["build_sharded_trace_fn", "sharded_trace", "build_train_step", "gather_result"]


def _max_generations(result: engine.TraceResult, mesh: Mesh) -> engine.TraceResult:
    gens = mesh.all_reduce(result.generations_run, dist.ReduceOp.MAX)
    return dataclasses.replace(result, generations_run=gens)


def build_sharded_trace_fn(
    scene: CompiledScene,
    config: TraceConfig,
    mesh: Mesh,
    use_fused: Optional[bool] = None,
    itemsize: int = 4,
):
    """``fn(params, local_rays) -> TraceResult`` of this rank's block of
    rays, ``generations_run`` max-reduced over the mesh.

    ``use_fused`` overrides ``config.use_fused`` (``ops.fused_trace.
    pick_fused`` on the mesh's device: K1 or K2 on CUDA, else the plain
    engine).  ``itemsize`` is kept for the JAX package's signature: its
    pick checks a VMEM budget, the port's has none.
    """
    from pyrayt_tpu_torch.ops import fused_trace as ft

    del itemsize
    if use_fused is not None:
        config = dataclasses.replace(config, use_fused=use_fused)
    if ft.pick_fused(scene.spec, config, mesh.device):
        base = ft.build_fused_trace_fn(scene.spec, scene.materials, config)
    else:
        base = engine.build_trace_fn(scene.spec, scene.materials, config)

    def fn(params, rays: RaySet) -> engine.TraceResult:
        return _max_generations(base(params, rays), mesh)

    return fn


def sharded_trace(
    scene: CompiledScene,
    rays: RaySet,
    config: TraceConfig,
    mesh: Optional[Mesh] = None,
) -> engine.TraceResult:
    """Trace ``rays`` (the full set, the same on every rank) with the ray
    axis sharded over ``mesh`` (None: :func:`default_mesh` on the scene's
    device).  Pads the ray count to the mesh size; padding rays are born
    dead.  Returns this rank's block (:func:`gather_result` assembles the
    global result)."""
    if mesh is None:
        mesh = default_mesh(device=scene.params["world"].device)
    rays, _ = pad_rayset(rays, mesh.size)
    fn = build_sharded_trace_fn(scene, config, mesh)
    return fn(scene.params, shard_rayset(rays, mesh))


class _Gather(torch.autograd.Function):
    """Every rank's block along the last axis, in rank order.  The loss of
    a sharded step is replicated (every rank evaluates it on the same
    gathered result), so the backward keeps this rank's block of the
    cotangent: each block's cotangent is counted once, on its own rank."""

    @staticmethod
    def forward(ctx, local, mesh):
        ctx.mesh, ctx.k = mesh, local.shape[-1]
        return mesh.gather(local)

    @staticmethod
    def backward(ctx, grad):
        lo = ctx.mesh.rank * ctx.k
        return grad[..., lo:lo + ctx.k], None


def gather_result(result: engine.TraceResult, mesh: Mesh) -> engine.TraceResult:
    """The global TraceResult from every rank's block (records, masks and
    final rays concatenated in rank order, bit for bit), on every rank.
    Differentiable for a loss that every rank evaluates alike: the
    backward hands each rank its own block's cotangent."""

    def gather(t):
        if t.requires_grad:
            return _Gather.apply(t, mesh)
        return mesh.gather(t)

    return engine.TraceResult(
        records=gather(result.records),
        record_mask=gather(result.record_mask),
        final_rays=RaySet(
            **{name: gather(getattr(result.final_rays, name))
               for name in ("positions", "directions") + RaySet.fields}
        ),
        generations_run=result.generations_run,
    )


def build_train_step(
    scene: CompiledScene,
    config: TraceConfig,
    mesh: Mesh,
    loss_fn: Callable[[engine.TraceResult], torch.Tensor],
    learning_rate: float = 1e-2,
    param_filter: Optional[Callable[[dict], dict]] = None,
    use_fused: Optional[bool] = None,
    itemsize: int = 4,
):
    """The distributed optimization step: ``step(params, local_rays) ->
    (new_params, loss)``, both identical on every rank and equal to the
    unsharded step's.

    ``loss_fn(result) -> scalar`` sees the global TraceResult
    (:func:`gather_result`).  The trace runs ``fixed_loop``; its route is
    ``ops.fused_grad.pick_fused_grad`` on the mesh's device and the local
    ray count (narrow: K1 then K4; wide: K2 then K5-K7, or K8 with
    ``wide_grad="fused"``), else the plain engine under autograd.
    ``use_fused`` overrides ``config.use_fused``.  The gradient is summed
    over the ranks in rank order, then ``param_filter(grads)`` masks it,
    then one SGD update.  ``itemsize`` is kept for the JAX package's
    signature.
    """
    from pyrayt_tpu_torch.ops import fused_grad as fg

    del itemsize
    cfg = dataclasses.replace(config, fixed_loop=True)
    if use_fused is not None:
        cfg = dataclasses.replace(cfg, use_fused=use_fused)
    spec, materials = scene.spec, scene.materials

    def trace(params, rays):
        if fg.pick_fused_grad(spec, cfg, mesh.device, rays.n_rays):
            fn = fg.build_fused_vjp_trace_fn(spec, materials, cfg)
        else:
            fn = engine.build_trace_fn(spec, materials, cfg)
        return _max_generations(fn(params, rays), mesh)

    def step(params, rays: RaySet):
        names = list(params)
        leaves = {k: params[k].detach().requires_grad_(True) for k in names}
        loss = loss_fn(gather_result(trace(leaves, rays), mesh))
        grads = torch.autograd.grad(loss, [leaves[k] for k in names], allow_unused=True)
        grads = [torch.zeros_like(leaves[k]) if g is None else g for k, g in zip(names, grads)]
        grads = dict(zip(names, mesh.ordered_sum(grads)))
        if param_filter is not None:
            grads = param_filter(grads)
        new_params = {k: (leaves[k] - learning_rate * grads[k]).detach() for k in names}
        return new_params, loss.detach()

    return step

"""What the cells compare, worked out by the plain reference.

Each function takes a configuration's reference module (``refm``), its
numbers (``cfg``) and the inputs the harness drew from the seed, and
traces in blocks of rays so that a cell's full size fits beside nothing
else on the card.  ``dtype`` is float64 for the truth and bfloat16 for the
control.
"""

from __future__ import annotations

import statistics

import torch

from benchmark.reference import engine


def _blocks(n, block):
    for start in range(0, n, block):
        yield slice(start, min(start + block, n))


def value_and_grad(refm, cfg, theta, rays, block):
    """The loss at ``theta`` (dict of leaf tensors that require grad) and its
    gradient.  The loss is a ratio A / B of sums over rays; over several
    blocks a first pass without grad finds A / B, and each block then adds
    the gradient of (A_b - (A / B) B_b) / B."""
    leaves = list(theta.values())
    dtype = rays.p.dtype

    def parts(sl, tables):
        rec, mask = engine.trace(groups, rays.block(sl), cfg["generation_limit"],
                                 cfg["ray_offset"], cfg["world_index"], tables)
        return refm.loss_parts(cfg, rec, mask)

    groups = refm.groups(cfg, theta, dtype, rays.p.device)
    if block >= rays.n:
        value = refm.loss_value(*parts(slice(0, rays.n), engine.scene_tables(groups, dtype)))
        grads = torch.autograd.grad(value, leaves, allow_unused=True)
        return value.detach(), {k: g if g is not None else torch.zeros_like(t)
                                for (k, t), g in zip(theta.items(), grads)}
    with torch.no_grad():
        tables = engine.scene_tables(groups, dtype)
        a_sum = b_sum = 0.0
        for sl in _blocks(rays.n, block):
            a, b = parts(sl, tables)
            a_sum, b_sum = a_sum + a, b_sum + b
        value = refm.loss_value(a_sum, b_sum)
        scale = refm.loss_value(torch.ones_like(b_sum), b_sum)  # 1 / max(B, floor)
    tables = engine.scene_tables(groups, dtype)
    grads = [torch.zeros_like(t) for t in leaves]
    for sl in _blocks(rays.n, block):
        a, b = parts(sl, tables)
        piece = (a - value * b) * scale
        if piece.requires_grad:
            for acc, g in zip(grads, torch.autograd.grad(piece, leaves, retain_graph=True,
                                                         allow_unused=True)):
                if g is not None:
                    acc += g
    return value, dict(zip(theta, grads))


def adam_steps(refm, cfg, theta0, rays, learning_rate, schedule_steps, steps, block):
    """``steps`` Adam steps from ``theta0`` as ``optimize`` takes them (the
    loss at each iterate, then the update; cosine decay over
    ``schedule_steps`` when it is set).  Returns (losses, first gradient,
    parameters after the last step)."""
    params = {k: v.detach().clone().requires_grad_(True) for k, v in theta0.items()}
    opt = torch.optim.Adam(list(params.values()), lr=learning_rate)
    sched = (torch.optim.lr_scheduler.CosineAnnealingLR(opt, T_max=schedule_steps)
             if schedule_steps else None)
    losses, first = [], None
    for _ in range(steps):
        value, grads = value_and_grad(refm, cfg, params, rays, block)
        losses.append(float(value))
        if first is None:
            first = {k: g.detach().clone() for k, g in grads.items()}
        for k, p in params.items():
            p.grad = grads[k].detach().to(p.dtype)
        opt.step()
        if sched is not None:
            sched.step()
    return losses, first, {k: p.detach().clone() for k, p in params.items()}


def norm_gaps(program, reference, counted=None):
    """Per leaf: | ||program|| - ||reference|| | over the larger of the
    reference leaf's norm and the median leaf's; the worst leaf counted."""
    norms = {k: float(torch.linalg.vector_norm(v.double())) for k, v in reference.items()}
    median = statistics.median(norms.values())
    worst = 0.0
    for k in counted if counted is not None else reference:
        p = float(torch.linalg.vector_norm(program[k].double()))
        worst = max(worst, abs(p - norms[k]) / max(norms[k], median))
    return worst


def moved_leaves(grads, share=1e-3):
    """Leaves whose reference gradient is not nought to rounding: norm at
    least ``share`` of the median leaf's."""
    norms = {k: float(torch.linalg.vector_norm(v.double())) for k, v in grads.items()}
    median = statistics.median(norms.values())
    return [k for k, v in norms.items() if v >= share * median]


def trace_records(refm, cfg, theta, rays, dtype, block):
    """(records, masks) of the whole bundle, traced block by block."""
    with torch.no_grad():
        groups = refm.groups(cfg, theta, dtype, rays.p.device)
        tables = engine.scene_tables(groups, dtype)
        recs, masks = [], []
        for sl in _blocks(rays.n, block):
            r, m = engine.trace(groups, rays.block(sl), cfg["generation_limit"],
                                cfg["ray_offset"], cfg["world_index"], tables)
            recs.append(r)
            masks.append(m)
    return torch.cat(recs, dim=2), torch.cat(masks, dim=1)


def spot(refm, cfg, theta, rays, block):
    """(imager hits, RMS spot radius about the centroid), in float64 sums."""
    with torch.no_grad():
        dtype = rays.p.dtype
        groups = refm.groups(cfg, theta, dtype, rays.p.device)
        tables = engine.scene_tables(groups, dtype)
        n = sy = sz = sq = 0.0
        for sl in _blocks(rays.n, block):
            r, m = engine.trace(groups, rays.block(sl), cfg["generation_limit"],
                                cfg["ray_offset"], cfg["world_index"], tables)
            parts = refm.spot_parts(cfg, r, m)
            n, sy, sz, sq = (acc + float(v) for acc, v in zip((n, sy, sz, sq), parts))
    cy, cz = sy / max(n, 1.0), sz / max(n, 1.0)
    return int(n), max(sq / max(n, 1.0) - cy * cy - cz * cz, 0.0) ** 0.5

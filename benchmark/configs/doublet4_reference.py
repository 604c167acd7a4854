"""Plain reference of the ``doublet4`` configuration (``doublet4.json``).

The ``doublet`` configuration's scene, rays and soft focus loss
(``doublet_reference.py``), with the rays split over the ranks as the
deployment splits them: each rank traces its own contiguous block, made
for that block alone, in blocks of rays.  The loss over every rank's rays
and its gradient follow ``solve.value_and_grad``'s algebra with the sums
combined over the ranks between its passes: the numerator A and the
denominator B first, then the gradient pieces ``(A_b - L B_b) / B``.
``combine(t)`` is the caller's sum of ``t`` over the ranks.  Imports
nothing of the program.
"""

from __future__ import annotations

import torch

from benchmark.configs.doublet_reference import (  # noqa: F401
    design_radii,
    groups,
    loss_parts,
    loss_value,
    scene_counts,
    spot_parts,
    surface_id,
    theta,
)
from benchmark.reference import engine


def block_bounds(cfg, n_per_source, ranks, rank):
    """(first, end) of rank ``rank``'s rays: ``ceil(n / ranks)`` each, the
    last rank short by the padding."""
    total = n_per_source * len(cfg["source_wavelengths_um"])
    k = -(-total // ranks)
    return min(rank * k, total), min((rank + 1) * k, total)


def rays(cfg, n_per_source, dtype, device, first, end) -> engine.Rays:
    """Rays ``first .. end - 1`` of ``doublet_reference.rays``' six lines,
    the same numbers, without the rest of the set."""
    d = cfg["lens_diameter"]
    width = cfg["line_width_factor"] * d / 2
    ps, wls = [], []
    for s, wl in enumerate(cfg["source_wavelengths_um"]):
        a, b = max(first, s * n_per_source), min(end, (s + 1) * n_per_source)
        if a >= b:
            continue
        y = torch.linspace(-width / 2, width / 2, n_per_source, dtype=torch.float64,
                           device=device)[a - s * n_per_source:b - s * n_per_source]
        p = torch.zeros((3, b - a), dtype=torch.float64, device=device)
        p[0] = cfg["source_x"]
        p[1] = y + cfg["line_offset_factor"] * d
        ps.append(p)
        wls.append(torch.full((b - a,), wl, dtype=torch.float64, device=device))
    p = torch.cat(ps, dim=1)
    direction = torch.zeros_like(p)
    direction[0] = 1.0
    ids = torch.arange(first, end, dtype=torch.float64, device=device)
    return engine.make_rays(p, direction, torch.cat(wls), ids, dtype)


def _blocks(n, block):
    for start in range(0, n, block):
        yield slice(start, min(start + block, n))


def value_and_grad(cfg, theta, rays, block, combine, keep=True):
    """The loss over every rank's rays at ``theta`` (dict of leaf tensors
    that require grad) and its gradient, ``rays`` this rank's.  A rank
    with ``keep=False`` adds nothing to the sums (a planted fault: its
    rays left out)."""
    leaves = list(theta.values())
    dtype = rays.p.dtype
    grp = groups(cfg, theta, dtype, rays.p.device)

    def parts(sl, tables):
        rec, mask = engine.trace(grp, rays.block(sl), cfg["generation_limit"],
                                 cfg["ray_offset"], cfg["world_index"], tables)
        return loss_parts(cfg, rec, mask)

    with torch.no_grad():
        tables = engine.scene_tables(grp, dtype)
        sums = torch.zeros(2, dtype=dtype, device=rays.p.device)
        for sl in _blocks(rays.n, block):
            sums += torch.stack(parts(sl, tables))
        a_sum, b_sum = combine(sums if keep else torch.zeros_like(sums))
        value = loss_value(a_sum, b_sum)
        scale = loss_value(torch.ones_like(b_sum), b_sum)  # 1 / max(B, floor)
    tables = engine.scene_tables(grp, dtype)
    grads = [torch.zeros_like(t) for t in leaves]
    for sl in _blocks(rays.n, block) if keep else ():
        a, b = parts(sl, tables)
        piece = (a - value * b) * scale
        if piece.requires_grad:
            for acc, g in zip(grads, torch.autograd.grad(piece, leaves, retain_graph=True,
                                                         allow_unused=True)):
                if g is not None:
                    acc += g
    flat = combine(torch.cat([g.reshape(-1) for g in grads]))
    out, start = {}, 0
    for k, t in theta.items():
        out[k] = flat[start:start + t.numel()].reshape(t.shape)
        start += t.numel()
    return value, out


def adam_steps(cfg, theta0, rays, learning_rate, schedule_steps, steps, block, combine,
               keep=True):
    """``solve.adam_steps`` over every rank's rays: ``steps`` Adam steps
    from ``theta0`` as ``optimize`` takes them.  Returns (losses, first
    gradient, parameters after the last step)."""
    params = {k: v.detach().clone().requires_grad_(True) for k, v in theta0.items()}
    opt = torch.optim.Adam(list(params.values()), lr=learning_rate)
    sched = (torch.optim.lr_scheduler.CosineAnnealingLR(opt, T_max=schedule_steps)
             if schedule_steps else None)
    losses, first = [], None
    for _ in range(steps):
        value, grads = value_and_grad(cfg, params, rays, block, combine, keep)
        losses.append(float(value))
        if first is None:
            first = {k: g.detach().clone() for k, g in grads.items()}
        for k, p in params.items():
            p.grad = grads[k].detach().to(p.dtype)
        opt.step()
        if sched is not None:
            sched.step()
    return losses, first, {k: p.detach().clone() for k, p in params.items()}

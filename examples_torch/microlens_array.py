"""Microlens array: 16x16 = 256 plano-convex lenslets, traced and
differentiated end-to-end.

The reference handles arbitrary component lists with a per-component
Python loop (PyRayT's pyrayt/_pyrayt.py:377-392) — graceful at any count,
but each component costs a Python-time pass.  Here all 256 lenslets share
one CSG shape, so the engine batches the whole array into a single wide
scene (pyrayt_tpu_torch/tracer/engine.py): on the CUDA card one launch of
the wide trace kernel searches every lenslet for every ray.

The script:
1. traces a collimated square beam through the array to its focal plane,
2. reports the per-lenslet focusing quality (median distance of detector
   hits to the nearest lenslet center),
3. differentiates the mean spot size with respect to the (shared) lenslet
   radius of curvature — the gradient a lenslet-array designer descends —
4. and, with ``--optimize N``, actually descends it: adam walks a 15%%
   detuned radius back toward nominal.  On the card every step runs the
   wide forward kernel and the STAGED backward kernels at any array size.
   ``--optimize-per-lenslet N`` runs the freeform mode: every lenslet gets
   its own randomly detuned radius and adam descends all n*n radii + the
   detector plane jointly.

Run:  python examples_torch/microlens_array.py [--n 16] [--rays 65536] [--optimize 30]
      python examples_torch/microlens_array.py --optimize-per-lenslet 30
          (freeform mode: n*n independent lenslet radii + the detector
           plane, each lenslet randomly detuned — exercises per-tree
           gradient accumulation at scale)
"""

import sys

import numpy as np
import torch

import pyrayt_tpu_torch as pyrayt
from pyrayt_tpu_torch import components
from pyrayt_tpu_torch.analysis import build_objective
from pyrayt_tpu_torch.analysis.metrics import COL, masked_mean, surface_mask
from pyrayt_tpu_torch.config import TraceConfig, default_device
from pyrayt_tpu_torch.scene.objects import fresh_ids

PITCH = 1.0  # mm
R_LENSLET = 2.0  # mm radius of curvature
THICKNESS = 0.25  # mm


def build_system(n, r=R_LENSLET):
    lenslets = components.microlens_array(r, THICKNESS, n, n, PITCH)
    # the detector plane is FIXED at the nominal focal length: it is the
    # design target, not a function of the traced radius (and lensmakers
    # with r2 = inf is non-differentiable — inf * 0 = NaN in the backward)
    focus = pyrayt.lensmakers_equation(R_LENSLET, np.inf, 1.5, THICKNESS)
    detector = components.baffle((2.0 * n * PITCH, 2.0 * n * PITCH)).move_x(focus)
    return lenslets + [detector], detector, focus


def main(n=16, n_rays=1 << 16, steps=0, *, device=None, dtype=torch.float32):
    device = default_device(device)
    system, detector, focus = build_system(n)
    span = n * PITCH * 0.95
    source = components.GridOfRays(span, span).move_x(-1.0)

    tracer = pyrayt.RayTracer(
        source, system, rays_per_source=n_rays, generation_limit=4,
        device=device, dtype=dtype,
    )
    frame = tracer.trace()
    hits = frame[frame.surface == detector.get_id()]
    # distance of each focal-plane hit to its nearest lenslet center (for
    # even n the centers sit at half-pitch offsets: (i - (n-1)/2) * pitch)
    off = 0.0 if n % 2 else PITCH / 2.0
    dy = hits["y1"] - (PITCH * np.round((hits["y1"] - off) / PITCH) + off)
    dz = hits["z1"] - (PITCH * np.round((hits["z1"] - off) / PITCH) + off)
    spot = np.hypot(dy, dz)
    print(f"{n}x{n} lenslets ({2 * n * n} leaves), {n_rays} rays")
    print(f"  focal plane x = {focus:.3f} mm")
    print(f"  detector hits: {len(hits)} / {n_rays}")
    print(f"  median |hit - lenslet center|: {np.median(spot):.4f} mm "
          f"(cell half-pitch {PITCH / 2:.2f})")

    # --- the differentiable-design path: d(spot size)/d(radius) ------------
    rays = source.generate_rays(n_rays, device=device, dtype=dtype)
    rays = rays.replace(id=torch.arange(n_rays, dtype=rays.dtype, device=rays.device))

    def build(r):
        return build_system(n, r)[0]

    with fresh_ids():
        det_id = float(build(torch.tensor(R_LENSLET, device=device, dtype=dtype))[-1].get_id())

    def lenslet_blur(res):
        """Mean squared distance of focal-plane hits to their own lenslet's
        center — the per-cell spot objective an MLA designer minimizes.
        round() is piecewise constant, so the loss is differentiable a.e."""
        m = surface_mask(res, det_id)
        y = res.records[:, COL["y1"], :]
        z = res.records[:, COL["z1"], :]
        dy = y - (PITCH * torch.round((y - off) / PITCH) + off)
        dz = z - (PITCH * torch.round((z - off) / PITCH) + off)
        return masked_mean(dy**2 + dz**2, m)

    objective = build_objective(
        build, rays, lenslet_blur, TraceConfig(generation_limit=4, fixed_loop=True)
    )
    r0 = torch.tensor(R_LENSLET, device=device, dtype=dtype, requires_grad=True)
    value = objective(r0)
    (grad,) = torch.autograd.grad(value, r0)
    value = value.detach()
    print(f"  per-lenslet blur (MSE): {float(value):.6f} mm^2; "
          f"d(blur)/d(r) = {float(grad):+.6f} "
          f"({n * n} lenslets, one backward pass)")

    # --- optional: descend it.  Start the shared radius detuned 15% high
    # and let adam walk the whole ARRAY back to focus — on the card every
    # step runs the wide forward kernel and the STAGED backward kernels
    # (any array size).
    if steps:
        from pyrayt_tpu_torch.analysis import optimize

        r_start = R_LENSLET * 1.15
        theta, history = optimize(
            lambda th: objective(th["r"]),
            {"r": torch.tensor(r_start, device=device, dtype=dtype)},
            steps=steps,
            learning_rate=2e-2,
        )
        print(f"  optimize({steps} steps): r {r_start:.3f} -> "
              f"{float(theta['r']):.4f} mm (nominal {R_LENSLET}); "
              f"blur {history[0]:.5f} -> {min(history):.5f} mm^2")
    return float(value), float(grad)


def main_per_lenslet(n=16, n_rays=1 << 16, steps=30, seed=3, *, device=None,
                     dtype=torch.float32):
    """Freeform-array design: ``n*n`` INDEPENDENT lenslet radii (plus the
    detector-plane position) optimized jointly.  Each lenslet starts with
    its own random detuning, so recovery requires genuinely per-tree
    gradients — the wide backward accumulates one cotangent per lenslet
    per step (tests/test_torch/test_torch_wide_grad_radii.py pins them
    against the JAX package at f64).  The reference's FD loop would need
    ``n*n + 1`` re-traces per step for the same search direction (PyRayT's
    examples/lens_design.ipynb cells 28-33)."""
    import numpy as np

    from pyrayt_tpu_torch.analysis import optimize

    device = default_device(device)
    rng = np.random.default_rng(seed)
    span = n * PITCH * 0.95
    source = components.GridOfRays(span, span).move_x(-1.0)
    rays = source.generate_rays(n_rays, device=device, dtype=dtype)
    rays = rays.replace(id=torch.arange(n_rays, dtype=rays.dtype, device=rays.device))
    focus = pyrayt.lensmakers_equation(R_LENSLET, np.inf, 1.5, THICKNESS)
    off = 0.0 if n % 2 else PITCH / 2.0

    def build(theta):
        lenslets = components.microlens_array(
            theta["radii"], THICKNESS, n, n, PITCH
        )
        detector = components.baffle(
            (2.0 * n * PITCH, 2.0 * n * PITCH)
        ).move_x(theta["det_x"])
        return lenslets + [detector]

    radii0 = torch.as_tensor(R_LENSLET * (1.0 + 0.15 * rng.standard_normal(n * n)),
                             device=device, dtype=dtype)
    theta0 = {"radii": radii0, "det_x": torch.tensor(focus * 1.05, device=device, dtype=dtype)}
    with fresh_ids():
        det_id = float(build(theta0)[-1].get_id())

    def lenslet_blur(res):
        m = surface_mask(res, det_id)
        y = res.records[:, COL["y1"], :]
        z = res.records[:, COL["z1"], :]
        dy = y - (PITCH * torch.round((y - off) / PITCH) + off)
        dz = z - (PITCH * torch.round((z - off) / PITCH) + off)
        return masked_mean(dy**2 + dz**2, m)

    objective = build_objective(
        build, rays, lenslet_blur, TraceConfig(generation_limit=4, fixed_loop=True)
    )
    theta, history = optimize(
        objective, theta0, steps=steps, learning_rate=2e-2
    )
    r_err0 = np.abs(radii0.cpu().numpy() - R_LENSLET)
    r_err1 = np.abs(theta["radii"].cpu().numpy() - R_LENSLET)
    print(f"{n}x{n} per-lenslet optimize ({steps} steps, {n * n + 1} params):")
    print(f"  blur {history[0]:.5f} -> {min(history):.5f} mm^2")
    print(f"  mean |r - nominal|: {r_err0.mean():.4f} -> {r_err1.mean():.4f} mm")
    print(f"  detector x: {focus * 1.05:.3f} -> {float(theta['det_x']):.3f} "
          f"(nominal {focus:.3f})")
    return history, theta


if __name__ == "__main__":
    n = int(sys.argv[sys.argv.index("--n") + 1]) if "--n" in sys.argv else 16
    rays = (
        int(sys.argv[sys.argv.index("--rays") + 1])
        if "--rays" in sys.argv
        else 1 << 16
    )
    steps = (
        int(sys.argv[sys.argv.index("--optimize") + 1])
        if "--optimize" in sys.argv
        else 0
    )
    if "--optimize-per-lenslet" in sys.argv:
        per_steps = int(sys.argv[sys.argv.index("--optimize-per-lenslet") + 1])
        main_per_lenslet(n=n, n_rays=rays, steps=per_steps)
    else:
        main(n=n, n_rays=rays, steps=steps)

"""Where a training step's host time goes, before and after the rebuild's
redesign: the traced rebuild and the training step on the card, for the
``rebuild_ms`` and ms-per-step figures of PERF.md and a comparison of two
checkouts in one run.

    python3 tests/test_torch/card_rebuild_times.py [--root DIR] [--label NAME] [--steps N]

Objectives (float32), as ``chip_smoke.py`` phases 7 and 12 run them: the
singlet (2**20 rays, RmsSpotRadius through K1 + K3), the 8x8 microlens array
with a shared radius and with 64 radii plus the detector plane (2**18 rays,
the lenslet blur through K2 and the staged backward), and the 16x16 array
with a shared radius (2**20 rays, the same route).  Per objective, host
clock, synchronized: the builders alone (``build_ms``: Python object
construction), ``compile_scene`` of what they built (``compile_ms``), the
whole rebuild, the objective's value, its value and gradient
(``chip_smoke.step_breakdown``), and ms per ``optimize`` step; the
profiler's device time per value and gradient (``device_ms``: every CUDA
kernel of the call, ours and PyTorch's) and its host ops by self CPU time
(``host_top_ms``); and the non-view aten ops of the
rebuild and of its backward (``chip_smoke.aten_counter``).  Prints one
JSON line per objective and a last line with all of them and the card's
name and power limit.  ``--root`` imports ``pyrayt_tpu_torch`` from
another checkout (e.g. the parent commit unpacked under ``build/parent``);
the scenes and helpers are this checkout's ``chip_smoke.py``.  Needs one
CUDA device and ``nvcc``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parents[1]


def profiled(torch, cs, fn, calls=3, top=8):
    """``(device ms, host ms by op)`` per call of ``fn`` under the profiler,
    after a warm-up: every CUDA kernel it records, and the ``top`` host ops
    and functions by their self CPU time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    events = prof.key_averages()
    device = sum(cs.device_us(e) for e in events
                 if e.device_type == torch.autograd.DeviceType.CUDA) / calls / 1e3
    host = sorted(((e.key, e.self_cpu_time_total / calls / 1e3) for e in events
                   if e.device_type == torch.autograd.DeviceType.CPU),
                  key=lambda item: -item[1])[:top]
    return device, {name[:70]: ms for name, ms in host}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", default=str(ROOT))
    parser.add_argument("--label", default="tree")
    parser.add_argument("--steps", type=int, default=5)
    args = parser.parse_args()
    root = Path(args.root).resolve()
    sys.path[:0] = [str(ROOT)]
    import chip_smoke as cs  # this checkout's scenes and helpers

    sys.path[:1] = [str(root)]
    import numpy as np
    import torch

    import pyrayt_tpu_torch as pyrayt
    from pyrayt_tpu_torch import components as comp
    from pyrayt_tpu_torch import materials as matl
    from pyrayt_tpu_torch.analysis import build_objective, metrics, optimize
    from pyrayt_tpu_torch.config import TraceConfig
    from pyrayt_tpu_torch.ops import fused_trace as ft
    from pyrayt_tpu_torch.scene import fresh_ids
    from pyrayt_tpu_torch.scene.compile import compile_scene

    assert Path(ft.__file__).resolve().is_relative_to(root), ft.__file__
    ft.build_kernels()
    device = torch.device("cuda", 0)

    singlet_rays = comp.LineOfRays(0.4).move_x(-1.0).generate_rays(
        cs.N_RAYS, device=device, dtype=torch.float32)
    with fresh_ids():
        singlet_det = float(compile_scene(cs.build_singlet({"r1": 3.0}, comp, matl),
                                          device=device).spec.leaf_ids[-1])

    def grid(n, n_rays):
        span = n * cs.MLA_PITCH * 0.95
        rays = comp.GridOfRays(span, span).move_x(-1.0).generate_rays(
            n_rays, device=device, dtype=torch.float32)
        return rays.replace(id=torch.arange(n_rays, dtype=torch.float32, device=device))

    def mla(n):
        return lambda th: cs.mla_system(comp, pyrayt, n, th["r"])[0]

    focus8 = pyrayt.lensmakers_equation(cs.MLA_R, float("inf"), 1.5, cs.MLA_THICKNESS)
    radii8 = cs.MLA_R * (1.0 + 0.15 * np.random.default_rng(3).standard_normal(
        cs.TRAIN_N * cs.TRAIN_N))
    wide_config = TraceConfig(generation_limit=cs.MLA_GENERATIONS, fixed_loop=True)
    cases = [
        ("singlet", lambda th: cs.build_singlet(th, comp, matl), {"r1": 2.0}, singlet_rays,
         metrics.RmsSpotRadius(singlet_det), TraceConfig(generation_limit=4, fixed_loop=True),
         5e-2),
        ("8x8_shared", mla(cs.TRAIN_N), {"r": cs.MLA_R * 1.15},
         grid(cs.TRAIN_N, cs.TRAIN_RAYS), None, wide_config, 2e-2),
        ("8x8_free", lambda th: cs.build_free8(comp, th),
         {"radii": radii8, "det_x": focus8 * 1.05}, grid(cs.TRAIN_N, cs.TRAIN_RAYS), None,
         wide_config, 2e-2),
        ("16x16_shared", mla(cs.MLA_N), {"r": cs.MLA_R * 1.15}, grid(cs.MLA_N, cs.N_RAYS), None,
         wide_config, 2e-2),
    ]
    results = {}
    for name, build, theta0, rays, loss, config, lr in cases:
        def theta():
            return {k: torch.tensor(np.asarray(v, dtype=np.float32), device=device,
                                    requires_grad=True) for k, v in theta0.items()}

        if loss is None:
            n = cs.TRAIN_N if name.startswith("8x8") else cs.MLA_N
            with fresh_ids():
                det = float(cs.mla_system(comp, pyrayt, n)[1].get_id())
            if name == "8x8_free":
                with fresh_ids():
                    det = float(build(theta())[-1].get_id())
            loss = cs.lenslet_blur_loss(torch, metrics, det, n)
        objective = build_objective(build, rays, loss, config)
        th = theta()
        out = {}

        def built():
            with fresh_ids():
                return build(th)

        out["build_ms"] = cs.host_ms(torch, built, 5)
        parts = built()
        out["compile_ms"] = cs.host_ms(
            torch, lambda: compile_scene(parts, device=device, dtype=torch.float32), 5)
        out.update(cs.step_breakdown(torch, compile_scene, fresh_ids, build, objective, th,
                                     device, 5))
        out["device_ms"], out["host_top_ms"] = profiled(
            torch, cs, lambda: torch.autograd.grad(objective(th), list(th.values())))
        forward, backward = cs.aten_counter(), cs.aten_counter()
        with forward, fresh_ids():
            scene = compile_scene(build(th), device=device, dtype=torch.float32)
        with backward:
            torch.autograd.grad([scene.params["world"].sum() + scene.params["prim"].sum()],
                                list(th.values()))
        out.update(leaves=scene.spec.n_leaves, ops=forward.ops, backward_ops=backward.ops)
        objective(theta())  # warm-up of the step
        torch.cuda.synchronize()
        start = time.perf_counter()
        _, history = optimize(objective, theta(), steps=args.steps, learning_rate=lr)
        torch.cuda.synchronize()
        out["ms_per_step"] = (time.perf_counter() - start) / args.steps * 1e3
        out["loss"] = [float(h) for h in history]
        results[name] = out
        print(json.dumps({args.label: {name: out}}), flush=True)
        del objective, rays
        torch.cuda.empty_cache()
    print(json.dumps({"label": args.label, "root": str(root), "card": cs.card_line(),
                      "objectives": results}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

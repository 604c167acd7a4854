"""Smoke test of the PyTorch port on one NVIDIA GPU.

Drives ``pyrayt_tpu_torch`` on the card in phases; every phase passes or
raises, and any failure exits non-zero:

1. build   — compile the CUDA kernels from ``pyrayt_tpu_torch/csrc``;
2. compare — the kernel against its plain PyTorch version on the
             condenser (cone source at 10 deg, BK7 thick lens, baffle;
             2**20 rays, 6 generations), at float64 and float32;
3. main    — ``RayTracer(...).trace()`` on the condenser at float32 with
             the default dispatch; the kernel's launch count must rise,
             and the frame must match the plain engine's in shape;
4. tutorial — the convex-collimator tutorial through the kernel: exactly
             150 rows, generation-2 rays collimated at x = 1;
5. times   — kernel and plain version on the condenser, CUDA events;
6. gradients — the backward kernels against autograd of the plain forward
             (``fused_trace_plain``) at the bench's gradient configuration
             (condenser, 2**20 rays, 6 generations, fixed loop, remat):
             (a) ``RmsSpotRadius`` through the loss-fused K3 Function at
             float64 and float32, and two K3 launches bit-identical;
             (b) a loss over masked records and final positions through
             the generic K4 Function; (c) the achromatic-doublet objective
             of examples/lens_design.py (SoftFocusError, 8 generations,
             ~2**20 rays) with respect to theta through the differentiable
             rebuild, K3 against the plain engine, float64;
7. training — the main path of this slice: ``build_objective`` and 60
             Adam steps of ``optimize`` on the singlet of
             tests/test_analysis/test_optimize.py at 2**20 rays, float32,
             through K1 + K3; then 5 steps with a generic loss through
             K1 + K4;
8. backward times — K3, K4 and their plain versions on the condenser at
             float32, CUDA events, beside each kernel's bound.

Run from the repository root: ``python3 chip_smoke.py``.  It needs one
CUDA device and ``nvcc``; the kernels build into ``build/torch_kernels``.
The last line of standard output is the JSON status line.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

N_RAYS = 1 << 20
GENERATIONS = 6
# float64: masks agree on at least this share of rays, and records of the
# rays whose masks agree within RTOL64 / ATOL64 (the kernel contracts
# multiply-adds into FMAs, eager PyTorch does not)
MASK_SHARE64 = 0.99999
RTOL64 = ATOL64 = 1e-9
# float32: at most this share of rays may differ above ATOL32 in any
# masked record value (the bound the TPU build used for kernel vs engine)
DIFF_SHARE32 = 0.001
ATOL32 = 1e-4
# gradients: max |kernel - plain| <= REL64 * max |plain| + ABS64 at float64
# (FMA contraction and a million-term sum in another order; a wrong adjoint
# misses by far more), <= REL32 * max |plain| at float32
REL64, ABS64 = 1e-7, 1e-12
REL32 = 1e-3
# published H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, float32 FLOP/s
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12
# floating-point operations per (ray, generation it ran), counted from the
# CUDA sources (an FMA counts 2, a compare or select 0): every leaf's
# world-to-object transform (33) and intersector, then the hit leaf's
# normal (50), refraction with its Sellmeier index (75), record, tilt and
# push-off (15); the backward adds the hit leaf's re-intersection and
# endpoint derivative (100), the adjoints of the normal (110), refraction
# and Sellmeier (150), tilt and record (40), and the block's staged
# parameter fold (22 S + 7 M adds per ray)
LOCAL_RAY = 33
INTERSECT = {0: 26, 1: 30, 2: 12, 3: 14, 4: 28}  # sphere, paraboloid, plane, cube, cylinder
INTERACT = 140
ADJOINT = 400


def log(*parts):
    print(*parts, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True,
        text=True,
        timeout=60,
        check=True,
    )
    return out.stdout.strip().splitlines()[0]


def condenser(comp, matl):
    lens = comp.thick_lens(1.0, -1.0, 0.25, aperture=0.5, material=matl.glass["BK7"])
    detector = comp.baffle((1.0, 1.0)).move_x(1.0)
    source = comp.ConeOfRays(cone_angle=10.0).move_x(-0.5)
    return source, [lens, detector]


# examples/lens_design.py: a 50 mm f/2.4 BK7/SF2 achromatic doublet (mm)
LENS_DIAMETER = 25.4
DOUBLET_FOCUS = 50.0
L1_THICKNESS, L2_THICKNESS = 8.0, 2.0
DOUBLET_RADII = 174763  # rays per wavelength: 6 x 174763 ~ 2**20
TRAIN_STEPS = 60
GENERIC_STEPS = 5


def doublet_radii_initial(matl):
    """lens_design.doublet_radii_initial: power split by Abbe number."""
    import numpy as np

    crown, flint = matl.glass["BK7"], matl.glass["SF2"]
    p_sys = 1 / DOUBLET_FOCUS
    v1, v2 = crown.abbe(), flint.abbe()
    p1, p2 = p_sys * v1 / (v1 - v2), p_sys * v2 / (v2 - v1)
    n1, n2 = float(crown.index_at(0.633)), float(flint.index_at(0.633))
    r1 = (n1 - 1) * (1 + np.sqrt(1 - p1 * L1_THICKNESS / n1)) / p1
    r4 = 1.0 / (1.0 / -r1 - p2 / (n2 - 1))
    return np.array([r1, -r1, -r1, r4])


def build_doublet(comp, matl, radii):
    """lens_design.build_doublet: signs static (+, -, -, -), magnitudes free."""
    l1 = comp.thick_lens(radii[0], radii[1], L1_THICKNESS, aperture=LENS_DIAMETER,
                         material=matl.glass["BK7"], r1_sign=1, r2_sign=-1)
    l2 = comp.thick_lens(radii[2], radii[3], L2_THICKNESS, aperture=LENS_DIAMETER,
                         material=matl.glass["SF2"], r1_sign=-1, r2_sign=-1,
                         ).move_x(1.01 * (L1_THICKNESS + L2_THICKNESS) / 2)
    imager = comp.baffle((LENS_DIAMETER, LENS_DIAMETER)).move_x(DOUBLET_FOCUS)
    return [l1, l2, imager]


def design_rays(comp, torch, device, dtype, n_radii,
                wavelengths=(0.45, 0.5, 0.55, 0.6, 0.65, 0.7)):
    """lens_design.design_rays: lines of rays across the aperture, one per
    wavelength, with ids 0..n-1."""
    from pyrayt_tpu_torch.tracer.rayset import concatenate

    sets = [
        comp.LineOfRays(0.45 * LENS_DIAMETER / 2, wavelength=wl).move_x(-10.0)
        .move_y(LENS_DIAMETER / 8).generate_rays(n_radii, device=device, dtype=dtype)
        for wl in wavelengths
    ]
    rays = concatenate(sets)
    return rays.replace(id=torch.arange(rays.n_rays, dtype=dtype, device=device))


def build_singlet(theta, comp, matl):
    """tests/test_analysis/test_optimize.py: a biconvex singlet with traced
    radius and a detector at x = 2."""
    lens = comp.thick_lens(r1=theta["r1"], r2=-theta["r1"], thickness=0.1, aperture=0.8,
                           material=matl.glass["ideal"], r1_sign=1, r2_sign=-1)
    return [lens, comp.baffle((3.0, 3.0)).move_x(2.0)]


def compare(torch, ft, spec, config, inputs, dtype):
    """Kernel vs plain on the same inputs: agreement shares and errors."""
    k_rec, k_mask, k_fin = ft.fused_trace(spec, config, *inputs)
    p_rec, p_mask, p_fin = ft.fused_trace_plain(spec, config, *inputs)
    torch.cuda.synchronize()
    n = k_mask.shape[1]
    agree = (k_mask == p_mask).all(dim=0)  # (n,) rays whose masks agree
    live = (k_mask & agree[None]).unsqueeze(1)  # (G, 1, n) rows to compare
    diff = torch.where(live, (k_rec - p_rec).abs(), 0.0)
    if dtype == torch.float64:
        tol = RTOL64 * p_rec.abs() + ATOL64
    else:
        tol = torch.full_like(p_rec, ATOL32)
    rec_ok = torch.where(live, diff <= tol, True).all(dim=0).all(dim=0) & agree
    fin_diff = torch.where(agree[None], (k_fin - p_fin).abs(), 0.0)
    return {
        "dtype": str(dtype).replace("torch.", ""),
        "rays": n,
        "mask_agree_share": float(agree.float().mean()),
        "record_tolerance": RTOL64 if dtype == torch.float64 else ATOL32,
        "share_outside_tolerance": float(1.0 - rec_ok.float().mean()),
        "max_abs_err": float(diff.max()),
        "final_state_max_abs_err": float(fin_diff.max()),
        "records_finite": bool(torch.isfinite(torch.where(live, k_rec, 0.0)).all()),
    }


def grad_compare(torch, kernel, plain, dtype):
    """Per name: max |kernel - plain|, max |plain|, their ratio, within bound."""
    out = {}
    for name, k in kernel.items():
        p = plain[name]
        scale = float(p.abs().max())
        err = float((k.double() - p.double()).abs().max())
        bound = REL64 * scale + ABS64 if dtype == torch.float64 else REL32 * scale
        out[name] = {"max_abs_err": err, "max_abs_plain": scale,
                     "ratio": err / scale if scale else 0.0, "within": err <= bound,
                     "finite": bool(torch.isfinite(k).all())}
    return out


def assert_within(report):
    for name, r in report.items():
        assert r["within"] and r["finite"], (name, r)


def flops_per_ray_generation(spec, backward: bool) -> int:
    forward = sum(LOCAL_RAY + INTERSECT[t] for t in spec.leaf_types) + INTERACT
    if not backward:
        return forward
    return forward + ADJOINT + 22 * spec.n_leaves + 7 * len(spec.mat_kinds)


def bound(bytes_moved, flops):
    """(bound ms, "bytes" or "operations") at the published H100 peaks."""
    t_bytes = bytes_moved / PEAK_BYTES * 1e3
    t_ops = flops / PEAK_F32 * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


PROFILED_STEPS = 5


def host_ms(torch, fn, repeats=10):
    """Host-clock ms per call, synchronized, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = time.perf_counter()
    for _ in range(repeats):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - start) / repeats * 1e3


def device_us(event):
    """Self device time (us) of a profiler key average, across versions."""
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(event, attr):
            return getattr(event, attr)
    return 0.0


def cuda_ms(torch, fn, repeats=10, warmup=2):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import numpy as np

    import pyrayt_tpu_torch as pyrayt
    from pyrayt_tpu_torch import components as comp
    from pyrayt_tpu_torch import materials as matl
    from pyrayt_tpu_torch.analysis import build_objective, metrics, optimize
    from pyrayt_tpu_torch.config import TraceConfig
    from pyrayt_tpu_torch.ops import fused_grad as fg
    from pyrayt_tpu_torch.ops import fused_trace as ft
    from pyrayt_tpu_torch.scene import fresh_ids
    from pyrayt_tpu_torch.scene.compile import compile_scene
    from pyrayt_tpu_torch.tracer import engine
    from pyrayt_tpu_torch.tracer.frame import records_to_dataframe

    package_dir = os.path.dirname(os.path.abspath(pyrayt.__file__))
    if os.path.dirname(package_dir) != HERE:
        print(f"chip_smoke: pyrayt_tpu_torch found at {package_dir}, not in {HERE}",
              file=sys.stderr)
        return 2
    if "jax" in sys.modules:
        print("chip_smoke: jax was imported", file=sys.stderr)
        return 2

    device = torch.device("cuda", 0)
    log("device:", torch.cuda.get_device_name(0), "| torch", torch.__version__,
        "| cuda", torch.version.cuda)

    # 1. build -------------------------------------------------------------
    phase_start = time.perf_counter()
    for stem, (lib_path, build_s, build_log) in ft.build_kernels().items():
        log(f"build {stem}: {build_s:.2f} s -> {os.path.relpath(lib_path, HERE)}")
        for line in build_log.splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                log("  ptxas:", line.strip())
    phase_seconds = {"build": time.perf_counter() - phase_start}

    # 2. kernel vs plain on the condenser -----------------------------------
    phase_start = time.perf_counter()
    config = TraceConfig(generation_limit=GENERATIONS)
    results = {}
    for dtype in (torch.float64, torch.float32):
        with fresh_ids():
            source, parts = condenser(comp, matl)
            scene = compile_scene(parts, device=device, dtype=dtype)
            rays = source.generate_rays(N_RAYS, device=device, dtype=dtype)
        inputs = ft.kernel_inputs(scene.params, rays)
        res = compare(torch, ft, scene.spec, config, inputs, dtype)
        results[res["dtype"]] = res
        log("compare:", json.dumps(res))
    r64, r32 = results["float64"], results["float32"]
    assert r64["mask_agree_share"] >= MASK_SHARE64, r64
    assert r64["share_outside_tolerance"] <= 1.0 - MASK_SHARE64, r64
    assert r32["share_outside_tolerance"] <= DIFF_SHARE32, r32
    assert r64["records_finite"] and r32["records_finite"], results
    phase_seconds["compare"] = time.perf_counter() - phase_start

    # 3. the main path: RayTracer.trace() at float32 ---------------------
    phase_start = time.perf_counter()
    with fresh_ids():
        source, parts = condenser(comp, matl)
    tracer = pyrayt.RayTracer(
        source, parts, rays_per_source=N_RAYS, generation_limit=GENERATIONS,
        device=device, dtype=torch.float32,
    )
    ft.fused_trace.launches = fg.fused_bwd_loss.launches = fg.fused_bwd.launches = 0
    start = time.perf_counter()
    frame = tracer.trace()
    main_s = time.perf_counter() - start
    launches = ft.fused_trace.launches
    assert launches > 0, "the main path did not launch the kernel"
    plain_tracer = pyrayt.RayTracer(
        source, parts, rays_per_source=N_RAYS, generation_limit=GENERATIONS,
        config=TraceConfig(use_fused=False), device=device, dtype=torch.float32,
    )
    plain_frame = plain_tracer.trace()
    assert list(frame.columns) == list(plain_frame.columns) and frame.shape[1] == 15
    assert np.isfinite(frame.to_numpy()).all(), "non-finite values in the frame"
    log(f"main: RayTracer.trace() {main_s:.3f} s (host clock, first call), "
        f"{len(frame)} rows x {frame.shape[1]} cols; plain engine {len(plain_frame)} rows; "
        f"kernel launches {launches}")
    assert len(frame) == len(plain_frame), (len(frame), len(plain_frame))

    # where a warm call's time goes (host clock, synchronized per stage)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    scene = compile_scene(parts, device=device, dtype=torch.float32)
    rays = source.generate_rays(N_RAYS, device=device, dtype=torch.float32)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    result = engine.trace_rays(scene, rays, tracer.get_config())
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    warm_frame = records_to_dataframe(result.records, result.record_mask)
    t3 = time.perf_counter()
    stages = {"scene_and_rays_s": t1 - t0, "trace_s": t2 - t1, "frame_s": t3 - t2,
              "frame_rows": len(warm_frame)}
    log("main stages (warm, host clock):", json.dumps(stages))
    phase_seconds["main"] = time.perf_counter() - phase_start

    # 4. the tutorial collimator through the kernel ----------------------
    phase_start = time.perf_counter()
    before = ft.fused_trace.launches
    lens = comp.biconvex_lens(2, 2, 0.25, aperture=1)
    focus = pyrayt.lensmakers_equation(2, -2, 1.5, 0.25)
    cone = comp.ConeOfRays(cone_angle=6).move_x(-focus)
    baffle = comp.baffle((1, 1)).move_x(1)
    tut = pyrayt.RayTracer(cone, [lens, baffle], rays_per_source=50, generation_limit=100,
                           device=device, dtype=torch.float32).trace()
    assert ft.fused_trace.launches > before, "the tutorial did not launch the kernel"
    assert len(tut) == 150, len(tut)
    assert np.allclose(tut[tut.generation == 2]["x1"], 1.0), "generation 2 not at x = 1"
    log(f"tutorial: {len(tut)} rows, generation-2 x1 == 1")
    phase_seconds["tutorial"] = time.perf_counter() - phase_start

    # 5. times -----------------------------------------------------------
    phase_start = time.perf_counter()
    with fresh_ids():
        source, parts = condenser(comp, matl)
        scene = compile_scene(parts, device=device, dtype=torch.float32)
        rays = source.generate_rays(N_RAYS, device=device, dtype=torch.float32)
    inputs = ft.kernel_inputs(scene.params, rays)
    saved = ft.fused_trace.launches
    ms = cuda_ms(torch, lambda: ft.fused_trace(scene.spec, config, *inputs))
    plain_ms = cuda_ms(torch, lambda: ft.fused_trace_plain(scene.spec, config, *inputs))
    ft.fused_trace.launches = saved
    card = card_line()
    log(f"times: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms "
        f"({N_RAYS} rays x {GENERATIONS} generations, float32, median of 10) on {card}")
    phase_seconds["times"] = time.perf_counter() - phase_start

    # 6. gradients against autograd of the plain forward -------------------
    phase_start = time.perf_counter()
    grad_config = TraceConfig(generation_limit=GENERATIONS, fixed_loop=True, remat=True)
    names = ("world", "prim", "glass")

    def condenser_scene(dtype):
        with fresh_ids():
            source, parts = condenser(comp, matl)
            scene = compile_scene(parts, device=device, dtype=dtype)
            rays = source.generate_rays(N_RAYS, device=device, dtype=dtype)
        return scene, rays, float(scene.spec.leaf_ids[-1])  # the detector

    def param_grads(scene, value_of):
        params = {k: v.detach().clone().requires_grad_(True) for k, v in scene.params.items()}
        value = value_of(params)
        grads = torch.autograd.grad(value, [params[k] for k in names])
        return float(value.detach()), dict(zip(names, grads))

    def plain_result(scene, params, rays):
        records, masks, fstate = ft.fused_trace_plain(
            scene.spec, grad_config, *ft.kernel_inputs(params, rays))
        return engine.TraceResult(records, masks, ft.rays_from_state(fstate),
                                  masks.any(dim=1).sum())

    def generic_loss(result):
        m = result.record_mask.to(result.records.dtype)
        hits = (result.records[:, 9] ** 2 + result.records[:, 10] ** 2) * m
        return hits.sum() / N_RAYS + result.final_rays.positions[1].sum() / N_RAYS

    grad_reports = {}
    for dtype in (torch.float64, torch.float32):
        tag = str(dtype).replace("torch.", "")
        scene, rays, sid = condenser_scene(dtype)
        loss = metrics.RmsSpotRadius(sid)
        value_fn = fg.build_fused_value_and_grad_fn(scene.spec, scene.materials, grad_config, loss)
        k_value, k_grads = param_grads(scene, lambda p: value_fn(p, rays))
        p_value, p_grads = param_grads(scene, lambda p: loss(plain_result(scene, p, rays)))
        report = grad_compare(torch, k_grads, p_grads, dtype)
        grad_reports[f"k3_rms_{tag}"] = report
        log(f"gradient (a) K3 RmsSpotRadius {tag}: value {k_value!r} vs plain {p_value!r}; "
            + json.dumps(report))
        assert_within(report)
        if dtype == torch.float64:
            _, again = param_grads(scene, lambda p: value_fn(p, rays))
            identical = all(torch.equal(again[k], k_grads[k]) for k in names)
            log(f"gradient (a) two K3 launches bit-identical: {identical}")
            assert identical, "two K3 launches differ"
        trace_fn = fg.build_fused_vjp_trace_fn(scene.spec, scene.materials, grad_config)
        k_value, k_grads = param_grads(scene, lambda p: generic_loss(trace_fn(p, rays)))
        p_value, p_grads = param_grads(scene, lambda p: generic_loss(plain_result(scene, p, rays)))
        report = grad_compare(torch, k_grads, p_grads, dtype)
        grad_reports[f"k4_generic_{tag}"] = report
        log(f"gradient (b) K4 masked records + final positions {tag}: value {k_value!r} vs "
            f"plain {p_value!r}; " + json.dumps(report))
        assert_within(report)
        del scene, rays, value_fn, trace_fn, k_grads, p_grads
        torch.cuda.empty_cache()

    # (c) the achromatic doublet of examples/lens_design.py, float64
    rays = design_rays(comp, torch, device, torch.float64, n_radii=DOUBLET_RADII)
    r0 = doublet_radii_initial(matl)
    signs = torch.as_tensor(np.sign(r0), device=device, dtype=torch.float64)

    def build_doublet_theta(log_mags):
        return build_doublet(comp, matl, signs * torch.exp(log_mags))

    with fresh_ids():
        imager_id = float(build_doublet(comp, matl, r0)[-1].get_id())
    soft = metrics.SoftFocusError(
        DOUBLET_FOCUS, imager_id, half_widths=(LENS_DIAMETER / 2, LENS_DIAMETER / 2),
        ramp=LENS_DIAMETER / 20)
    theta_grads = {}
    for label, use_fused in (("k3", None), ("plain", False)):
        objective = build_objective(
            build_doublet_theta, rays, soft,
            TraceConfig(generation_limit=8, fixed_loop=True, remat=True, use_fused=use_fused))
        theta = torch.log(torch.abs(torch.as_tensor(r0, device=device))).requires_grad_(True)
        before = fg.fused_bwd_loss.launches
        value = objective(theta)
        (theta_grads[label],) = torch.autograd.grad(value, theta)
        launched = fg.fused_bwd_loss.launches - before
        assert launched == (1 if use_fused is None else 0), (label, launched)
        log(f"gradient (c) doublet {label}: value {float(value.detach())!r}, "
            f"d theta {theta_grads[label].tolist()}")
    report = grad_compare(torch, {"theta": theta_grads["k3"]}, {"theta": theta_grads["plain"]},
                          torch.float64)
    grad_reports["k3_doublet_float64"] = report
    log(f"gradient (c) doublet, {rays.n_rays} rays, 8 generations: " + json.dumps(report))
    assert_within(report)
    del rays
    torch.cuda.empty_cache()
    phase_seconds["gradients"] = time.perf_counter() - phase_start

    # 7. training: build_objective + optimize through K1 + K3, then K4 ----
    phase_start = time.perf_counter()
    singlet_rays = comp.LineOfRays(0.4).move_x(-1.0).generate_rays(
        N_RAYS, device=device, dtype=torch.float32)
    with fresh_ids():
        detector_id = float(compile_scene(build_singlet({"r1": 3.0}, comp, matl)).spec.leaf_ids[-1])
    singlet_config = TraceConfig(generation_limit=4, fixed_loop=True)
    objective = build_objective(lambda th: build_singlet(th, comp, matl), singlet_rays,
                                metrics.RmsSpotRadius(detector_id), singlet_config)
    theta0 = {"r1": torch.tensor(3.0, device=device, dtype=torch.float32)}
    loss0 = float(objective(theta0))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ft.fused_trace.launches = fg.fused_bwd_loss.launches = fg.fused_bwd.launches = 0
    start = time.perf_counter()
    theta_opt, history = optimize(objective, theta0, steps=TRAIN_STEPS, learning_rate=5e-2)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - start
    train_launches = {"fused_trace": ft.fused_trace.launches,
                      "fused_bwd_loss": fg.fused_bwd_loss.launches,
                      "fused_bwd": fg.fused_bwd.launches}
    train_peak = torch.cuda.max_memory_allocated()
    loss_opt = float(objective(theta_opt))
    r1 = float(theta_opt["r1"])
    log(f"training: {TRAIN_STEPS} Adam steps, {N_RAYS} rays, float32: loss {loss0!r} -> "
        f"{loss_opt!r}, r1 3.0 -> {r1!r}; {train_s / TRAIN_STEPS * 1e3:.2f} ms/step "
        f"(host clock); launches {json.dumps(train_launches)}; peak memory "
        f"{train_peak / 2**30:.3f} GiB")
    assert loss_opt < loss0 / 5, (loss0, loss_opt)
    assert history[-1] < history[0], history
    assert 1.5 < r1 < 2.5, r1
    assert train_launches["fused_trace"] >= TRAIN_STEPS, train_launches
    assert train_launches["fused_bwd_loss"] >= TRAIN_STEPS, train_launches

    def rms_on_detector(result):  # no descriptor: the generic K4 backward
        return metrics.rms_spot_radius(result, detector_id)

    generic_objective = build_objective(lambda th: build_singlet(th, comp, matl), singlet_rays,
                                        rms_on_detector, singlet_config)
    ft.fused_trace.launches = fg.fused_bwd_loss.launches = fg.fused_bwd.launches = 0
    _, generic_history = optimize(generic_objective, theta0, steps=GENERIC_STEPS,
                                  learning_rate=5e-2)
    torch.cuda.synchronize()
    generic_launches = {"fused_trace": ft.fused_trace.launches,
                        "fused_bwd_loss": fg.fused_bwd_loss.launches,
                        "fused_bwd": fg.fused_bwd.launches}
    log(f"training, generic loss: {GENERIC_STEPS} steps, losses {generic_history} vs K3 "
        f"{history[:GENERIC_STEPS]}; launches {json.dumps(generic_launches)}")
    assert generic_launches["fused_bwd"] >= GENERIC_STEPS, generic_launches
    assert generic_launches["fused_trace"] >= GENERIC_STEPS, generic_launches
    np.testing.assert_allclose(generic_history, history[:GENERIC_STEPS], rtol=1e-3)

    # where a training step's time goes: host clock (synchronized) for the
    # rebuild alone, the objective's value, and value plus gradient; then
    # torch.profiler's device time over a few value-plus-gradient calls
    theta_t = {"r1": torch.tensor(2.0, device=device, requires_grad=True)}

    def rebuild():
        with fresh_ids():
            compile_scene(build_singlet(theta_t, comp, matl), device=device,
                          dtype=torch.float32)

    def value_and_grad():
        return torch.autograd.grad(objective(theta_t), [theta_t["r1"]])

    breakdown = {
        "rebuild_ms": host_ms(torch, rebuild),
        "value_ms": host_ms(torch, lambda: objective(theta_t)),
        "value_and_grad_ms": host_ms(torch, value_and_grad),
    }
    from torch.profiler import ProfilerActivity, profile

    value_and_grad()
    torch.cuda.synchronize()
    start = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILED_STEPS):
            value_and_grad()
        torch.cuda.synchronize()
    wall_us = (time.perf_counter() - start) * 1e6
    # device-side events only: a CPU op's self device time repeats the
    # kernels it launched
    kernels = sorted(
        ((e.key, device_us(e)) for e in prof.key_averages()
         if e.device_type == torch.autograd.DeviceType.CUDA and device_us(e) > 0),
        key=lambda item: -item[1])
    busy_ms = sum(us for _, us in kernels) / PROFILED_STEPS / 1e3
    breakdown["profiled_device_ms_per_step"] = busy_ms
    breakdown["device_busy_share_of_step"] = busy_ms / breakdown["value_and_grad_ms"]
    breakdown["profiled_wall_ms_per_step"] = wall_us / PROFILED_STEPS / 1e3
    breakdown["top_device_kernels_ms_per_step"] = {
        name[:60]: us / PROFILED_STEPS / 1e3 for name, us in kernels[:6]}
    log("training step breakdown (float32, 2**20 rays):", json.dumps(breakdown))
    phase_seconds["training"] = time.perf_counter() - phase_start

    # 8. backward times on the condenser, float32 ----------------------------
    phase_start = time.perf_counter()
    scene, rays, sid = condenser_scene(torch.float32)
    spec = scene.spec
    state0, obj_tx, prim, glass = ft.kernel_inputs(scene.params, rays)
    saved = (ft.fused_trace.launches, fg.fused_bwd_loss.launches, fg.fused_bwd.launches)
    records, masks, fstate = ft.fused_trace(spec, grad_config, state0, obj_tx, prim, glass)
    plan = fg.loss_plan(metrics.RmsSpotRadius(sid))
    scal = plan.row(plan.scalars(records, masks), torch.ones((), device=device))
    gen = torch.Generator(device=device).manual_seed(0)
    d_records = torch.randn(records.shape, generator=gen, device=device) * masks[:, None]
    d_fstate = torch.randn(state0.shape, generator=gen, device=device)
    bwd_args = (spec, grad_config, state0, obj_tx, prim, glass, records, masks)
    torch.cuda.reset_peak_memory_stats()
    k3_ms = cuda_ms(torch, lambda: fg.fused_bwd_loss(*bwd_args, scal, plan))
    k4_ms = cuda_ms(torch, lambda: fg.fused_bwd(*bwd_args, d_records, d_fstate))
    kernel_peak = torch.cuda.max_memory_allocated()
    k3_plain_ms = cuda_ms(torch, lambda: fg.fused_bwd_loss_plain(*bwd_args, scal, plan),
                          repeats=3, warmup=1)
    k4_plain_ms = cuda_ms(torch, lambda: fg.fused_bwd_plain(*bwd_args, d_records, d_fstate),
                          repeats=3, warmup=1)
    params = {k: v.detach().clone().requires_grad_(True) for k, v in scene.params.items()}
    plain_value = metrics.RmsSpotRadius(sid)(plain_result(scene, params, rays))
    autograd_ms = cuda_ms(torch, lambda: torch.autograd.grad(
        plain_value, list(params.values()), retain_graph=True), repeats=3, warmup=1)
    ft.fused_trace.launches, fg.fused_bwd_loss.launches, fg.fused_bwd.launches = saved
    run = fg.generations_ran(records, masks)  # (G, n): the generations each ray ran
    ran = int(run.sum())
    # generations a ray did not run whose tilt rows the backward reads to
    # see the skip (the mask before them is set)
    skip_checks = int((masks[:-1] & ~run[1:]).sum())
    item = 4
    n, g = N_RAYS, GENERATIONS
    table_bytes = item * (22 * spec.n_leaves + 7 * glass.shape[0]) * 2
    # K1 writes every generation's records (zeros where a ray stopped)
    k1_bytes = item * (15 * g * n + 2 * 13 * n) + g * n + table_bytes
    # the backward reads what this run's data makes it read: 15 record rows
    # per generation run, 3 tilt rows per skip check, masks[0..G-2] (K3 also
    # the last mask of rays that ran the last generation), 11 state0 rows
    # (the w rows are constants), and writes 13 d_state0 rows
    k3_bytes = (item * (15 * ran + 3 * skip_checks + 11 * n + 13 * n)
                + (g - 1) * n + int(run[-1].sum()) + table_bytes)
    # K4 adds 15 d_records rows per generation run and 11 d_fstate rows, and
    # reads no mask of the last generation
    k4_bytes = k3_bytes - int(run[-1].sum()) + item * (15 * ran + 11 * n)
    k1_bound = bound(k1_bytes, ran * flops_per_ray_generation(spec, backward=False))
    k3_bound = bound(k3_bytes, ran * flops_per_ray_generation(spec, backward=True))
    k4_bound = bound(k4_bytes, ran * flops_per_ray_generation(spec, backward=True))
    log(f"backward times ({N_RAYS} rays x {GENERATIONS} generations, {ran} ray-generations "
        f"run, {skip_checks} skip checks, float32, median): K3 {k3_ms:.4f} ms, "
        f"K4 {k4_ms:.4f} ms; plain K3 {k3_plain_ms:.2f} ms, plain K4 {k4_plain_ms:.2f} ms, "
        f"plain autograd backward of fused_trace_plain {autograd_ms:.2f} ms; kernel peak memory "
        f"{kernel_peak / 2**30:.3f} GiB on {card}")
    log("bounds: " + json.dumps({
        "fused_trace": {"bytes": k1_bytes, "ms": k1_bound[0], "by": k1_bound[1]},
        "fused_bwd_loss": {"bytes": k3_bytes, "ms": k3_bound[0], "by": k3_bound[1]},
        "fused_bwd": {"bytes": k4_bytes, "ms": k4_bound[0], "by": k4_bound[1]},
        "flops_per_ray_generation": {"forward": flops_per_ray_generation(spec, False),
                                     "backward": flops_per_ray_generation(spec, True)},
    }))
    phase_seconds["backward_times"] = time.perf_counter() - phase_start
    log("phase seconds:", json.dumps(phase_seconds))

    def k_err(key):
        return max(r["max_abs_err"] for r in grad_reports[key].values())

    log(json.dumps({"kernels": [
        {
            "name": "fused_trace",
            "route": "cuda",
            "source": "pyrayt_tpu_torch/csrc/fused_trace.cu",
            "replaces": "pyrayt_tpu/ops/fused_trace.py:343",
            "launches": launches,
            "max_abs_err": r32["max_abs_err"],
            "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": k1_bound[0],
            "bound_by": k1_bound[1],
            "library_ms": None,
        },
        {
            "name": "fused_bwd_loss",
            "route": "cuda",
            "source": "pyrayt_tpu_torch/csrc/fused_grad.cu",
            "replaces": "pyrayt_tpu/ops/fused_grad.py:127",
            "launches": train_launches["fused_bwd_loss"],
            "max_abs_err": k_err("k3_rms_float32"),
            "ms": k3_ms,
            "plain_ms": k3_plain_ms,
            "bound_ms": k3_bound[0],
            "bound_by": k3_bound[1],
            "library_ms": None,
        },
        {
            "name": "fused_bwd",
            "route": "cuda",
            "source": "pyrayt_tpu_torch/csrc/fused_grad.cu",
            "replaces": "pyrayt_tpu/ops/fused_grad.py:127",
            "launches": generic_launches["fused_bwd"],
            "max_abs_err": k_err("k4_generic_float32"),
            "ms": k4_ms,
            "plain_ms": k4_plain_ms,
            "bound_ms": k4_bound[0],
            "bound_by": k4_bound[1],
            "library_ms": None,
        },
    ]}))
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": 1,
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

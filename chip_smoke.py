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
5. times   — kernel and plain version on the condenser, CUDA events.

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
    from pyrayt_tpu_torch.config import TraceConfig
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
    lib_path, build_s, build_log = ft.build_kernels()
    ptxas = [line for line in build_log.splitlines() if "registers" in line or "spill" in line]
    log(f"build: {build_s:.2f} s -> {os.path.relpath(lib_path, HERE)}")
    for line in ptxas:
        log("  ptxas:", line.strip())

    # 2. kernel vs plain on the condenser -----------------------------------
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

    # 3. the main path: RayTracer.trace() at float32 ---------------------
    with fresh_ids():
        source, parts = condenser(comp, matl)
    tracer = pyrayt.RayTracer(
        source, parts, rays_per_source=N_RAYS, generation_limit=GENERATIONS,
        device=device, dtype=torch.float32,
    )
    ft.fused_trace.launches = 0
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

    # 4. the tutorial collimator through the kernel ----------------------
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

    # 5. times -----------------------------------------------------------
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

    log(json.dumps({"kernels": [{
        "name": "fused_trace",
        "route": "cuda",
        "source": "pyrayt_tpu_torch/csrc/fused_trace.cu",
        "replaces": "pyrayt_tpu/ops/fused_trace.py:343",
        "launches": launches,
        "max_abs_err": r32["max_abs_err"],
        "ms": ms,
        "plain_ms": plain_ms,
    }]}))
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Traffic kind ``spot``: Monte Carlo tolerance trials of a design.

Each call draws the design's parameters within the traffic's tolerance
from the seed's stream, rebuilds the system from those plain numbers,
traces every source's rays with ``RayTracer(...).trace_device()`` and reads
``analysis.metrics.rms_spot_radius`` on the imager back as one float: what
a stray-light or tolerancing study repeats.

``correct``: the spot radius of calls drawn from the seed and of the last
call against the reference's for the same parameters (relative gap).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark.harness import calls, common, profiling
from benchmark.reference import solve


def run(cell: common.Cell) -> common.Result:
    from pyrayt_tpu_torch import RayTracer
    from pyrayt_tpu_torch.analysis.metrics import rms_spot_radius
    from pyrayt_tpu_torch.scene.objects import fresh_ids

    cfg, traffic, port, device = cell.cfg, cell.traffic, cell.port, cell.device
    dtype = getattr(torch, cfg["dtype"])
    rng = np.random.default_rng(cell.seed)
    sources = port.sources(cfg)
    per_source = traffic["rays_per_source"]
    n_rays = per_source * len(sources)
    thetas = []

    def call(_):
        theta = cell.ref.theta(cfg, traffic, rng)
        thetas.append(theta)
        with cell.span("build"), fresh_ids():
            system = port.components(cfg, theta)
        surface_id = system[-1].get_id()
        tracer = RayTracer(sources, system, rays_per_source=per_source,
                           generation_limit=cfg["generation_limit"], device=device, dtype=dtype)
        with cell.span("trace_device"):
            result = cell.altered("result", tracer.trace_device())
        with cell.span("metric"):
            radius = cell.altered("radius", float(rms_spot_radius(result, surface_id)))
        return radius, result, surface_id

    for i in range(2):
        call(i)
    traced = None
    if cell.trace:
        def profiled():
            for i in range(traffic["profiled_calls"]):
                call(i)
            return traffic["profiled_calls"]
        traced = profiling.profile(profiled)

    keep = calls.sampled(cell.seed)
    thetas.clear()
    t_open, t_close, n_calls, kept = calls.window(cell, call, keep,
                                                  lambda a: (a[0], None, a[2]))
    setup_s = t_open - cell.process_start
    peak = common.memory_peak(cell)

    _, result, _ = kept[n_calls - 1]
    radii = {i: r for i, (r, _, _) in kept.items()}
    failed = sum(int(not np.isfinite(r)) for r in radii.values())
    ctx = {}
    if cell.trace:
        ctx = common.trace_context(cell, traced, result.records, result.record_mask,
                                   backward=False)
    drawn = {i: thetas[i] for i in radii}
    del kept, result
    common.release()

    start = time.perf_counter()
    rays = cell.ref.rays(cfg, per_source, torch.float64, device)
    spot_gap = 0.0
    for i, r in radii.items():
        th = {k: torch.as_tensor(np.asarray(v, dtype=np.float64)) for k, v in drawn[i].items()}
        _, ref_r = solve.spot(cell.ref, cfg, th, rays, traffic["reference_block"])
        spot_gap = max(spot_gap, abs(r - ref_r) / ref_r)
    ok, checks = common.judge({"spot_gap": spot_gap}, cell.limits)
    common.log(f"{n_calls} calls in {t_close - t_open:.2f} s, {len(radii)} compared; "
               f"reference {time.perf_counter() - start:.1f} s")
    if cell.trace:
        metrics = common.per_layer(cell, ctx)
        breakdown = {"device_ops": profiling.top_device_ops(traced),
                     "idle_gaps": profiling.idle_by_host(traced)}
    else:
        metrics = {"trace_rays_per_s": {"value": n_calls * n_rays / (t_close - t_open),
                                        "unit": "rays/s"},
                   "setup_s": {"value": setup_s, "unit": "s"}}
        breakdown = None
    return common.Result(ok and failed == 0, n_calls, failed, metrics,
                         common.device_info(cell, peak, traced), checks, breakdown)

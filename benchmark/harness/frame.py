"""Traffic kind ``frame``: ``RayTracer(...).trace()`` to the results frame.

PyRayT's primary use: the scene is built once in set-up (plain numbers
from the seed), and the window calls ``trace()`` back to back, each call
generating the sources' rays, compiling the scene, tracing and converting
the records to the pandas frame on the host.

``correct``: the frames of calls drawn from the seed and of the last call
are held against the reference's trace of the same scene and sources,
row by row, keyed by (generation, ray id): the share of rows present on
one side only, and the share of matched rows that differ anywhere by more
than ``ROW_TOL`` (mm, or the column's own unit).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark.harness import calls, common, profiling
from benchmark.reference import solve

ROW_TOL = 1e-4
GEN, ID = 0, 4  # frame columns


def run(cell: common.Cell) -> common.Result:
    from pyrayt_tpu_torch import RayTracer
    from pyrayt_tpu_torch.scene.objects import fresh_ids

    cfg, traffic, port, device = cell.cfg, cell.traffic, cell.port, cell.device
    dtype = getattr(torch, cfg["dtype"])
    theta = cell.ref.theta(cfg, traffic, np.random.default_rng(cell.seed))
    with fresh_ids():
        system = port.components(cfg, theta)
    sources = port.sources(cfg)
    per_source = traffic["rays_per_source"]
    n_rays = per_source * len(sources)
    tracer = RayTracer(sources, system, rays_per_source=per_source,
                       generation_limit=cfg["generation_limit"], device=device, dtype=dtype)

    def call(_):
        with cell.span("trace"):
            return cell.altered("frame", tracer.trace())

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
    t_open, t_close, n_calls, kept = calls.window(cell, call, keep)
    setup_s = t_open - cell.process_start
    peak = common.memory_peak(cell)
    failed = sum(int(not np.isfinite(f.to_numpy()).all()) for f in kept.values())

    ctx = {}
    if cell.trace:
        with torch.no_grad():
            res = tracer.trace_device()
        ctx = common.trace_context(cell, traced, res.records, res.record_mask, backward=False)
        del res
    frames = {i: f.to_numpy() for i, f in kept.items()}
    del tracer, kept
    common.release()

    start = time.perf_counter()
    ref_rows = reference_rows(cell, theta, torch.float64)
    gaps = [frame_gaps(f, ref_rows) for f in frames.values()]
    numbers = {k: max(g[k] for g in gaps) for k in gaps[0]}
    ok, checks = common.judge(numbers, cell.limits)
    common.log(f"{n_calls} calls in {t_close - t_open:.2f} s, {len(frames)} frames compared; "
               f"reference {time.perf_counter() - start:.1f} s")
    if cell.trace:
        metrics = common.per_layer(cell, ctx)
        breakdown = {"device_ops": profiling.top_device_ops(traced),
                     "idle_gaps": profiling.idle_by_host(traced)}
    else:
        metrics = {"frame_rays_per_s": {"value": n_calls * n_rays / (t_close - t_open),
                                        "unit": "rays/s"},
                   "setup_s": {"value": setup_s, "unit": "s"}}
        breakdown = None
    return common.Result(ok and failed == 0, n_calls, failed, metrics,
                         common.device_info(cell, peak, traced), checks, breakdown)


def reference_rows(cell, theta, dtype):
    """The reference's frame rows (R, 15) as float64 NumPy, in the frame's
    order (generation by generation, ray by ray)."""
    traffic = cell.traffic
    rays = cell.ref.rays(cell.cfg, traffic["rays_per_source"], dtype, cell.device)
    th = {k: torch.as_tensor(np.asarray(v, dtype=np.float64)) for k, v in theta.items()}
    records, masks = solve.trace_records(cell.ref, cell.cfg, th, rays, dtype,
                                         traffic["reference_block"])
    rows = records.permute(0, 2, 1)[masks]
    return rows.to(torch.float64).cpu().numpy()


def frame_gaps(program, reference):
    """Shares of rows on one side only and of matched rows off by more than
    ``ROW_TOL`` in any column; rows are keyed by (generation, ray id)."""
    def keys(rows):
        return rows[:, GEN].astype(np.int64) * (1 << 32) + rows[:, ID].astype(np.int64)

    pk, rk = keys(program), keys(reference)
    _, pi, ri = np.intersect1d(pk, rk, return_indices=True)
    unmatched = (len(pk) - len(pi) + len(rk) - len(ri)) / max(len(rk), 1)
    diff = np.abs(program[pi].astype(np.float64) - reference[ri])
    off = float((diff.max(axis=1, initial=0.0) > ROW_TOL).mean()) if len(pi) else 1.0
    return {"rows_unmatched": float(unmatched), "rows_off": off}

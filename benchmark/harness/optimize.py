"""Traffic kind ``optimize``: a lens designer's runs of ``optimize()``.

The window drives design runs back to back, each ``steps`` Adam steps from
the seed's parameters (cosine decay over the run when the traffic says so),
through the program's ``build_objective`` and ``optimize``, and closes at
the first step that would start after ``--seconds``.  A step is timed whole,
from one objective call to the next (``optimize`` reads each loss back, so
the host clock follows the card).

``correct``: every design run that took three steps in the window is held
against the reference's three steps from the same parameters: the loss at
each of the three iterates, the first gradient as Adam holds it after one
step (its first moment over 1 - beta1) and the parameters' change after
three steps, both by the worst leaf's gap of norms.
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Optional

import numpy as np
import torch

from benchmark.harness import common, profiling
from benchmark.reference import solve

COMPARED_STEPS = 3
BETA1 = 0.9  # torch.optim.Adam's default, which optimize() uses


class WindowClosed(Exception):
    """Raised by the objective at the first step past the window's end."""


@dataclasses.dataclass
class Run:
    calls: List[float] = dataclasses.field(default_factory=list)
    losses: List[torch.Tensor] = dataclasses.field(default_factory=list)
    end: Optional[float] = None  # optimize() returned
    closed: Optional[float] = None  # the window closed inside it
    moment: Optional[list] = None  # Adam's first moments after one step
    params: Optional[list] = None  # the parameters after COMPARED_STEPS steps

    def durations(self):
        stop = self.end if self.end is not None else self.closed
        marks = self.calls + ([stop] if stop is not None else [])
        return list(np.diff(marks))


class Recorder:
    """The objective ``optimize()`` calls, wrapped: it times each call,
    keeps each loss, and reads Adam's state and the parameters where the
    comparison needs them.  Its ``optimizer`` is the factory ``optimize()``
    takes, ``torch.optim.Adam(params, lr)`` as by default."""

    def __init__(self, objective, learning_rate, altered, span):
        self.objective = objective
        self.span = span
        self.learning_rate = learning_rate
        self.altered = altered
        self.deadline = None
        self.runs: List[Run] = []

    def optimizer(self, params):
        self.params = params
        self.opt = self.altered("optimizer", torch.optim.Adam(params, lr=self.learning_rate))
        self.runs.append(Run())
        return self.opt

    def __call__(self, theta):
        now = time.perf_counter()
        run = self.runs[-1]
        if self.deadline is not None and now >= self.deadline:
            run.closed = now
            raise WindowClosed
        k = len(run.calls)
        run.calls.append(now)
        if k == 1:
            run.moment = [self.opt.state[p]["exp_avg"].detach().clone() for p in self.params]
        if k == COMPARED_STEPS:
            run.params = [p.detach().clone() for p in self.params]
        with self.span("objective"):
            loss = self.objective(theta)
        run.losses.append(loss.detach())
        return loss


def run(cell: common.Cell) -> common.Result:
    from pyrayt_tpu_torch.analysis import build_objective, optimize
    from pyrayt_tpu_torch.config import TraceConfig
    from pyrayt_tpu_torch.scene.objects import fresh_ids

    cfg, traffic, port, device = cell.cfg, cell.traffic, cell.port, cell.device
    dtype = getattr(torch, cfg["dtype"])
    theta_np = cell.ref.theta(cfg, traffic, np.random.default_rng(cell.seed))
    theta0 = {k: torch.as_tensor(v, dtype=dtype, device=device) for k, v in theta_np.items()}
    rays = port.rays(cfg, traffic["rays_per_source"], device, dtype)
    rays = cell.altered("rays", rays)
    with fresh_ids():
        surface_id = port.components(cfg, theta0)[-1].get_id()
    build_s = []

    def build(theta):
        start = time.perf_counter()
        with cell.span("build"):
            parts = port.components(cfg, theta)
        build_s.append(time.perf_counter() - start)
        return parts

    config = TraceConfig(generation_limit=cfg["generation_limit"], fixed_loop=True)
    objective = build_objective(build, rays, port.loss(cfg, surface_id), config)
    recorder = Recorder(cell.altered("objective", objective), traffic["learning_rate"],
                        cell.altered, cell.span)
    steps = traffic["steps"]
    schedule = None
    if traffic.get("schedule") == "cosine":
        def schedule(o):
            return torch.optim.lr_scheduler.CosineAnnealingLR(o, T_max=steps)

    def design(n):
        return optimize(recorder, theta0, steps=n, optimizer=recorder.optimizer,
                        scheduler=schedule)

    for _ in range(2):  # builds and loads the kernels, then runs warm
        design(traffic["warmup_steps"])

    traced = None
    if cell.trace:
        def profiled():
            design(traffic["profiled_steps"])
            return traffic["profiled_steps"]
        traced = profiling.profile(profiled)

    recorder.runs.clear()
    build_s.clear()
    t_open = time.perf_counter()
    setup_s = t_open - cell.process_start
    recorder.deadline = t_open + cell.seconds
    while True:
        try:
            design(steps)
        except WindowClosed:
            t_close = recorder.runs[-1].closed
            break
        recorder.runs[-1].end = time.perf_counter()
        if recorder.runs[-1].end >= recorder.deadline:
            t_close = recorder.runs[-1].end
            break
    peak = common.memory_peak(cell)

    durations = [d for r in recorder.runs for d in r.durations()]
    n_steps = len(durations)
    losses = torch.stack([x for r in recorder.runs for x in r.losses[:len(r.durations())]])
    failed = int((~torch.isfinite(losses)).sum())
    compared = [r for r in recorder.runs if r.params is not None]

    ctx = {}
    if cell.trace:
        records, masks = _program_records(cell, theta0, rays, build)
        ctx = common.trace_context(cell, traced, records, masks, backward=True,
                                   build_ms=1e3 * float(np.mean(build_s)) if build_s else None)
        del records, masks
    theta_ref = {k: v.detach().to(torch.float64) for k, v in theta0.items()}
    program = [_readings(r, theta0) for r in compared]
    del objective, recorder, rays
    common.release()

    start = time.perf_counter()
    ok, checks = common.judge(numbers(reference_readings(cell, theta_ref), program),
                              cell.limits)
    took = 1e3 * np.asarray(durations)
    common.log(f"{n_steps} steps in {t_close - t_open:.2f} s (step ms: median "
               f"{np.median(took):.2f}, p10 {np.percentile(took, 10):.2f}, p90 "
               f"{np.percentile(took, 90):.2f}, max {took.max():.2f}), {len(program)} design "
               f"runs compared; reference {time.perf_counter() - start:.1f} s")
    if cell.trace:
        metrics = common.per_layer(cell, ctx)
        breakdown = {"device_ops": profiling.top_device_ops(traced),
                     "idle_gaps": profiling.idle_by_host(traced)}
    else:
        metrics = {
            "step_ms": {"value": 1e3 * (t_close - t_open) / max(n_steps, 1), "unit": "ms"},
            "step_ms_p95": {"value": 1e3 * float(np.percentile(durations, 95))
                            if durations else float("nan"), "unit": "ms"},
            "setup_s": {"value": setup_s, "unit": "s"},
        }
        breakdown = None
    return common.Result(ok and failed == 0 and n_steps > 0, n_steps, failed, metrics,
                         common.device_info(cell, peak, traced), checks, breakdown)


def _readings(run: Run, theta0):
    names = list(theta0)
    return {
        "losses": [float(x) for x in run.losses[:COMPARED_STEPS]],
        "grad": {k: m.to(torch.float64) / (1 - BETA1) for k, m in zip(names, run.moment)},
        "change": {k: p.to(torch.float64) - theta0[k].to(torch.float64)
                   for k, p in zip(names, run.params)},
    }


def reference_readings(cell: common.Cell, theta_ref, dtype=torch.float64, n_rays=None):
    """The reference's three steps from ``theta_ref`` in ``dtype`` (float64
    for the truth, bfloat16 for the control), as ``_readings`` gives the
    program's; ``n_rays`` keeps only the first rays (a planted fault)."""
    traffic = cell.traffic
    rays = cell.ref.rays(cell.cfg, traffic["rays_per_source"], dtype, cell.device)
    if n_rays is not None:
        rays = rays.block(slice(0, n_rays))
    schedule = traffic["steps"] if traffic.get("schedule") == "cosine" else None
    losses, grad, theta3 = solve.adam_steps(
        cell.ref, cell.cfg, {k: v.to(dtype) for k, v in theta_ref.items()}, rays,
        traffic["learning_rate"], schedule, COMPARED_STEPS, traffic["reference_block"])
    return {"losses": losses,
            "grad": {k: g.to(torch.float64) for k, g in grad.items()},
            "change": {k: theta3[k].to(torch.float64) - theta_ref[k] for k in theta_ref}}


def numbers(ref, program):
    """The three numbers of the worst compared design run (1 each when no
    run took three steps)."""
    if not program:
        return {"loss_gap": 1.0, "grad_gap": 1.0, "change_gap": 1.0}
    moved = solve.moved_leaves(ref["grad"])
    return {
        "loss_gap": max(abs(p - r) / abs(r) for run in program
                        for p, r in zip(run["losses"], ref["losses"])),
        "grad_gap": max(solve.norm_gaps(run["grad"], ref["grad"]) for run in program),
        "change_gap": max(solve.norm_gaps(run["change"], ref["change"], moved)
                          for run in program),
    }


def _program_records(cell, theta0, rays, build):
    """The program's trace at the seed's parameters: the masks the step's
    least time is counted from."""
    from pyrayt_tpu_torch.config import TraceConfig
    from pyrayt_tpu_torch.scene.compile import compile_scene
    from pyrayt_tpu_torch.scene.objects import fresh_ids
    from pyrayt_tpu_torch.tracer import engine

    with torch.no_grad(), fresh_ids():
        scene = compile_scene(build(theta0), device=rays.device, dtype=rays.dtype)
        res = engine.trace_rays(scene, rays, TraceConfig(
            generation_limit=cell.cfg["generation_limit"], fixed_loop=True))
    return res.records, res.record_mask

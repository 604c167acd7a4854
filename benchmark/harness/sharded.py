"""Traffic kind ``sharded``: the design loop of ``optimize`` with the ray
batch sharded over the ranks of one host, one process per card.

The runner's process is rank 0.  It builds the kernels, then spawns ranks
1 .. n-1 (``python3 -m benchmark.harness.sharded``), each on its own card,
and joins a group with them on the configuration's backend (NCCL on the
cards; gloo on the CPU in the tests).  A deadline kills every rank: rank
0 kills the others and exits past it or when one of them fails, and each
of them exits past it or when rank 0 is gone.  Every rank generates its
own block of the rays (the port's ``rays``), builds
``parallel.build_sharded_objective`` and runs ``optimize()`` unchanged:
design runs back to back from the seed's parameters.  Rank 0 times the
steps and closes the window for every rank at the first step that would
start past ``--seconds`` (a flag it sends each step over a gloo group of
the benchmark's own, which the program's counters do not see).  Only rank
0 is profiled, and only rank 0 prints.

``correct``: the first design run of the window against the float64
reference over all the rays, run by every rank on its own block after the
window (``configs/<config>_reference.py``, the sums combined over the
ranks): the loss at the first ``compared_steps`` iterates, the first
gradient and the parameters' change after ``compared_steps`` steps, as
``optimize`` compares them (``limits/<cell>.json`` sets
``compared_steps``).  Every rank must end every design run with the same
parameter bits and loss history as rank 0, or the run is not correct.
"""

from __future__ import annotations

import dataclasses
import importlib
import json
import os
import socket
import subprocess
import sys
import threading
import time
import traceback
from typing import List, Optional

import numpy as np
import torch
import torch.distributed as dist

from benchmark.harness import common, manifest, optimize, profiling

# seconds past the window's end after which every rank is killed: the
# set-up before it, the traced steps, the program's records and the
# reference after it
GRACE_S = 600.0
JOIN_TIMEOUT_S = 600
LEAVE_S = 60.0


def _limits_file(cell):
    with open(manifest.BENCH / "limits" / f"{cell.name}.json") as f:
        return json.load(f)


@dataclasses.dataclass
class Run(optimize.Run):
    final: Optional[list] = None  # the parameters when the run ended


class Recorder:
    """``optimize()``'s objective on one rank, wrapped: it times each call,
    keeps each loss and the readings the comparison needs, and raises
    ``optimize.WindowClosed`` on every rank at once when rank 0 finds the
    window closed."""

    def __init__(self, objective, learning_rate, compared, ctrl, altered, span):
        self.objective = objective
        self.learning_rate = learning_rate
        self.compared = compared
        self.ctrl = ctrl
        self.altered = altered
        self.span = span
        self.window = False  # every rank exchanges the flag while it is open
        self.deadline = None  # rank 0's
        self.runs: List[Run] = []

    def optimizer(self, params):
        self.params = params
        self.opt = self.altered("optimizer", torch.optim.Adam(params, lr=self.learning_rate))
        self.runs.append(Run())
        return self.opt

    def end_run(self):
        self.runs[-1].final = [p.detach().cpu().clone() for p in self.params]

    def __call__(self, theta):
        now = time.perf_counter()
        run = self.runs[-1]
        if self.window:
            flag = torch.tensor([float(self.deadline is not None and now >= self.deadline)])
            dist.all_reduce(flag, group=self.ctrl)
            if flag.item() > 0:
                run.closed = now
                raise optimize.WindowClosed
        k = len(run.calls)
        run.calls.append(now)
        if k == 1:
            run.moment = [self.opt.state[p]["exp_avg"].detach().clone() for p in self.params]
        if k == self.compared:
            run.params = [p.detach().clone() for p in self.params]
        with self.span("objective"):
            loss = self.objective(theta)
        run.losses.append(loss.detach())
        return loss


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _fault_name(fault):
    return None if fault is None else f"{fault.__module__}:{fault.__qualname__}"


def _load_fault(name):
    if name is None:
        return None
    module, qualname = name.split(":")
    return getattr(importlib.import_module(module), qualname)


class _Ranks:
    """Ranks 1 .. n-1 as child processes, watched from rank 0."""

    def __init__(self, cell, world, init, deadline, extra):
        args = {"workload": cell.name, "seed": cell.seed, "seconds": cell.seconds,
                "trace": cell.trace, "device": cell.device.type, "world": world,
                "init": init, "deadline": deadline, "parent": os.getpid(),
                "traffic": cell.traffic, "cfg": cell.cfg, "fault": _fault_name(cell.fault),
                **extra}
        self.deadline = deadline
        self.procs = [subprocess.Popen(
            [sys.executable, "-m", "benchmark.harness.sharded", json.dumps(dict(args, rank=r))],
            cwd=str(manifest.ROOT)) for r in range(1, world)]
        self.done = threading.Event()
        self.failed = None
        threading.Thread(target=self._watch, args=(cell.device.type == "cuda",),
                         daemon=True).start()

    def _watch(self, exit_on_failure):
        while not self.done.wait(0.5):
            bad = [(r + 1, p.returncode) for r, p in enumerate(self.procs)
                   if p.poll() not in (None, 0)]
            if bad or time.time() > self.deadline:
                self.failed = f"ranks {bad} failed" if bad else "past the deadline"
                common.log(f"sharded: {self.failed}; every rank stopped")
                self.kill()
                if exit_on_failure:  # rank 0 may be blocked in a collective
                    os._exit(1)
                return

    def kill(self):
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.wait()

    def close(self, timeout=LEAVE_S):
        """Wait for every rank to exit, kill those still running; raises
        unless all ended well."""
        end = time.monotonic() + timeout
        for p in self.procs:
            try:
                p.wait(timeout=max(end - time.monotonic(), 0.1))
            except subprocess.TimeoutExpired:
                pass
        self.done.set()
        self.kill()
        codes = [p.returncode for p in self.procs]
        if any(codes) or self.failed:
            raise RuntimeError(f"sharded ranks ended with {codes} ({self.failed})")


def _world(cell, fn, extra=None):
    """``fn(cell, 0, world, init)`` on rank 0 beside ranks 1 .. n-1, each
    running the same (``extra`` tells them which)."""
    world = cell.cfg["ranks"]
    if cell.device.type == "cuda":
        from pyrayt_tpu_torch.ops import fused_trace

        fused_trace.build_kernels()  # once, before the ranks load them
    init = f"tcp://127.0.0.1:{_free_port()}"
    ranks = _Ranks(cell, world, init, time.time() + cell.seconds + GRACE_S, extra or {})
    try:
        out = fn(cell, 0, world, init)
    finally:
        _leave()
        ranks.close()
    return out


def _leave():
    """Leave the group.  Every rank leaves at about the same time (NCCL's
    destroy can wait for the others); one still leaving after ``LEAVE_S``
    is left behind."""
    if dist.is_initialized():
        leaving = threading.Thread(target=dist.destroy_process_group, daemon=True)
        leaving.start()
        leaving.join(LEAVE_S)
        if leaving.is_alive():
            common.log(f"sharded: the group's destroy still runs after {LEAVE_S:.0f} s")


def _orphan_guard(parent, deadline):
    """A child rank exits when rank 0 is gone or past the deadline."""

    def watch():
        while True:
            time.sleep(0.5)
            if os.getppid() != parent or time.time() > deadline:
                os._exit(1)

    threading.Thread(target=watch, daemon=True).start()


def _join(cell, rank, world, init):
    from pyrayt_tpu_torch.parallel import default_mesh, initialize_distributed

    if cell.device.type == "cuda":
        torch.cuda.set_device(rank)
        device, backend = torch.device("cuda", rank), cell.cfg["backend"]
    else:
        device, backend = torch.device("cpu"), "gloo"
    initialize_distributed(init, world, rank, initialization_timeout=JOIN_TIMEOUT_S,
                           backend=backend)
    mesh = default_mesh(device=device)
    if mesh.shape != cell.cfg["mesh"]:
        raise ValueError(f"mesh {mesh.shape}, the configuration's {cell.cfg['mesh']}")
    return mesh, dist.new_group(backend="gloo")


def run(cell: common.Cell) -> common.Result:
    """Rank 0: spawn the other ranks, run with them, return the result."""
    from pyrayt_tpu_torch.parallel import build_sharded_objective  # noqa: F401  (fails early)

    return _world(cell, _rank)


def _rank(cell, rank, world, init):
    """One rank's run; rank 0 returns the result, the others None."""
    from pyrayt_tpu_torch.config import TraceConfig
    from pyrayt_tpu_torch.parallel import build_sharded_objective
    from pyrayt_tpu_torch.parallel import mesh as mesh_module
    from pyrayt_tpu_torch.analysis import optimize as optimize_loop
    from pyrayt_tpu_torch.scene.objects import fresh_ids

    mesh, ctrl = _join(cell, rank, world, init)
    cell.altered("rank", rank)
    cfg, traffic, port, device = cell.cfg, cell.traffic, cell.port, mesh.device
    dtype = getattr(torch, cfg["dtype"])
    compared = _limits_file(cell).get("compared_steps", optimize.COMPARED_STEPS)
    theta_np = cell.ref.theta(cfg, traffic, np.random.default_rng(cell.seed))
    theta0 = {k: torch.as_tensor(v, dtype=dtype, device=device) for k, v in theta_np.items()}
    rays = cell.altered("rays", port.rays(cfg, traffic["rays_per_source"], mesh, dtype))
    with fresh_ids():
        surface_id = port.components(cfg, theta0)[-1].get_id()

    def build(theta):
        with cell.span("build"):
            return port.components(cfg, theta)

    config = TraceConfig(generation_limit=cfg["generation_limit"], fixed_loop=True)
    objective = build_sharded_objective(build, rays, port.loss(cfg, surface_id), config, mesh)
    recorder = Recorder(cell.altered("objective", objective), traffic["learning_rate"],
                        compared, ctrl, cell.altered, cell.span)
    steps = traffic["steps"]
    schedule = None
    if traffic.get("schedule") == "cosine":
        def schedule(o):
            return torch.optim.lr_scheduler.CosineAnnealingLR(o, T_max=steps)

    def design(n):
        try:
            optimize_loop(recorder, theta0, steps=n, optimizer=recorder.optimizer,
                          scheduler=schedule)
        finally:
            recorder.end_run()

    for _ in range(2):  # loads the kernels, then runs warm
        design(traffic["warmup_steps"])

    traced, per_step_bytes = None, None
    if cell.trace:
        traced, per_step_bytes = _profiled(cell, rank, ctrl, design, mesh_module)

    recorder.runs.clear()
    dist.barrier(group=ctrl)
    t_open = time.perf_counter()
    setup_s = t_open - cell.process_start
    recorder.window = True
    recorder.deadline = t_open + cell.seconds if rank == 0 else None
    while True:
        try:
            design(steps)
        except optimize.WindowClosed:
            t_close = recorder.runs[-1].closed
            break
        recorder.runs[-1].end = time.perf_counter()
    recorder.window = False
    peak = common.memory_peak(cell) if cell.device.type == "cuda" else 0

    # every rank's parameter bits and loss histories, and memory peaks
    mine = ([r.final for r in recorder.runs],
            [[float(x) for x in r.losses] for r in recorder.runs], int(peak))
    every = [None] * world
    dist.all_gather_object(every, mine, group=ctrl)
    agree = all(_same(every[0], other) for other in every[1:])

    durations = [d for r in recorder.runs for d in r.durations()]
    losses = torch.stack([x for r in recorder.runs for x in r.losses[:len(r.durations())]])
    failed = int((~torch.isfinite(losses)).sum())
    first = recorder.runs[0]
    program = [optimize._readings(first, theta0)] if first.params is not None else []

    ctx = {}
    if cell.trace and rank == 0:
        records, masks = optimize._program_records(cell, theta0, rays, build)
        ctx = common.trace_context(cell, traced, records, masks, backward=True,
                                   combine_bytes=per_step_bytes)
        del records, masks
    theta_ref = {k: v.detach().to(torch.float64) for k, v in theta0.items()}
    del objective, recorder, rays
    common.release()

    if cell.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    start = time.perf_counter()
    ref = reference_readings(cell, mesh, theta_ref, compared)
    ref_s = time.perf_counter() - start
    ref_peak = common.memory_peak(cell)
    if rank != 0:
        return None
    ok, checks = common.judge(optimize.numbers(ref, program), cell.limits)
    took = 1e3 * np.asarray(durations) if durations else np.zeros(1)
    common.log(f"{len(durations)} steps in {t_close - t_open:.2f} s on {world} ranks (step ms: "
               f"median {np.median(took):.2f}, p10 {np.percentile(took, 10):.2f}, p90 "
               f"{np.percentile(took, 90):.2f}, max {took.max():.2f}); ranks agree: {agree}; "
               f"memory peaks {[e[2] for e in every]}; reference {ref_s:.1f} s over "
               f"{compared} step(s), its peak {ref_peak}")
    if cell.trace:
        metrics = common.per_layer(cell, ctx)
        breakdown = {"device_ops": profiling.top_device_ops(traced),
                     "idle_gaps": profiling.idle_by_host(traced)}
    else:
        metrics = {
            "step_ms": {"value": 1e3 * (t_close - t_open) / max(len(durations), 1),
                        "unit": "ms"},
            "step_ms_p95": {"value": 1e3 * float(np.percentile(durations, 95))
                            if durations else float("nan"), "unit": "ms"},
            "setup_s": {"value": setup_s, "unit": "s"},
        }
        breakdown = None
    info = common.device_info(cell, max(e[2] for e in every), traced)
    info["count"] = world
    return common.Result(ok and agree and failed == 0 and len(durations) > 0,
                         len(durations), failed, metrics, info, checks, breakdown)


def _same(a, b):
    """The same parameter bits and loss histories, run by run."""
    finals_a, hist_a, _ = a
    finals_b, hist_b, _ = b
    if len(finals_a) != len(finals_b) or hist_a != hist_b:
        return False
    return all(len(x) == len(y) and all(torch.equal(p, q) for p, q in zip(x, y))
               for x, y in zip(finals_a, finals_b))


def _profiled(cell, rank, ctrl, design, mesh_module):
    """Rank 0 profiles design runs of ``profiled_steps`` (a session that
    records no kernel runs again); the other ranks run each one with it.
    Returns rank 0's trace and the bytes the program's collectives moved
    per step (None where the program counts none)."""
    steps = cell.traffic["profiled_steps"]
    counter = getattr(mesh_module, "all_reduce", None)

    def again(go):
        flag = torch.tensor([float(go)])
        dist.broadcast(flag, 0, group=ctrl)
        return flag.item() > 0

    if rank != 0:
        while again(False):
            design(steps)
        return None, None
    sessions = []

    def profiled():
        again(True)
        before = getattr(counter, "bytes", None)
        design(steps)
        after = getattr(counter, "bytes", None)
        sessions.append(None if before is None else (after - before) / steps)
        return steps

    traced = profiling.profile(profiled)
    again(False)
    return traced, sessions[-1]


def reference_readings(cell, mesh, theta_ref, compared, dtype=torch.float64, left_out=None):
    """The reference's ``compared`` steps from ``theta_ref`` over every
    rank's rays in ``dtype`` (float64 for the truth, bfloat16 for the
    control), each rank its block, as ``optimize._readings`` gives the
    program's; rank ``left_out`` adds nothing to the sums (a planted
    fault)."""
    traffic, cfg = cell.traffic, cell.cfg
    first, end = cell.ref.block_bounds(cfg, traffic["rays_per_source"], mesh.size, mesh.rank)
    rays = cell.ref.rays(cfg, traffic["rays_per_source"], dtype, mesh.device, first, end)
    schedule = traffic["steps"] if traffic.get("schedule") == "cosine" else None

    def combine(t):
        t = t.clone()
        dist.all_reduce(t)
        return t

    losses, grad, theta = cell.ref.adam_steps(
        cfg, {k: v.to(dtype) for k, v in theta_ref.items()}, rays, traffic["learning_rate"],
        schedule, compared, traffic["reference_block"], combine, keep=mesh.rank != left_out)
    return {"losses": losses,
            "grad": {k: g.to(torch.float64) for k, g in grad.items()},
            "change": {k: theta[k].to(torch.float64) - theta_ref[k] for k in theta_ref}}


def calibrate(name, seed, device="cuda", traffic=None, cfg=None, left_out=1):
    """Rank 0 of :func:`_calibrate`'s world: ``{"control": numbers,
    "left_out": numbers}`` (``traffic`` and ``cfg`` replace the cell's
    sizes in the tests)."""
    cell = common.Cell.load(name, seed, 0.0, False, device, time.perf_counter(), traffic,
                            cfg=cfg)
    return _world(cell, lambda *a: _calibrate(*a, left_out), {"calibrate": left_out})


def _calibrate(cell, rank, world, init, left_out):
    """The cell's numbers with the bfloat16 reference in the program's
    place, and with the float64 reference with rank ``left_out``'s rays
    left out; rank 0 returns ``{"control": ..., "left_out": ...}``."""
    mesh, _ = _join(cell, rank, world, init)
    theta_np = cell.ref.theta(cell.cfg, cell.traffic, np.random.default_rng(cell.seed))
    theta = {k: torch.as_tensor(v, device=mesh.device).to(getattr(torch, cell.cfg["dtype"]))
             .to(torch.float64) for k, v in theta_np.items()}
    compared = _limits_file(cell).get("compared_steps", optimize.COMPARED_STEPS)
    truth = reference_readings(cell, mesh, theta, compared)
    low = reference_readings(cell, mesh, theta, compared, torch.bfloat16)
    part = reference_readings(cell, mesh, theta, compared, left_out=left_out)
    if rank != 0:
        return None
    return {"control": optimize.numbers(truth, [low]),
            "left_out": optimize.numbers(truth, [part])}


def main(argv):
    args = json.loads(argv[0])
    _orphan_guard(args["parent"], args["deadline"])
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    cell = common.Cell.load(args["workload"], args["seed"], args["seconds"], args["trace"],
                            args["device"], time.perf_counter(), args["traffic"],
                            _load_fault(args["fault"]), args["cfg"])
    code = 1
    try:
        if args.get("calibrate") is not None:
            _calibrate(cell, args["rank"], args["world"], args["init"], args["calibrate"])
        else:
            _rank(cell, args["rank"], args["world"], args["init"])
        code = 0
    except BaseException:
        traceback.print_exc()
    finally:
        _leave()
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(code)  # past a destroy left behind


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

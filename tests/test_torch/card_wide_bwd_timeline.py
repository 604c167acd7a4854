"""Where the time of one call of the monolithic wide backward K8
(``ops/fused_grad.py:fused_bwd_wide``) and of one staged backward step
(``staged_bwd``: K5, K6, K7 per generation run) goes, on the host and on
the card.

    python3 tests/test_torch/card_wide_bwd_timeline.py [--rays N] [--root DIR] [--label NAME]

On the 16x16 microlens array (513 leaves, the bench's ray grid, 2**20 rays,
4 generations, float32, RmsSpotRadius loss mode) it measures each by CUDA
events (median of 10), by the host clock until the call returns
(enqueue only: the device waits for the host for as long before its first
kernel) and under ``torch.profiler`` (CPU and CUDA activities, five calls,
each closed by a synchronize): the device time per kernel as the mean of
the launches the profiler recorded times its launches per call (the
profiler can miss the first call's early launches, so a sum divided by
the calls undercounts), their sum, the event time less that sum, and the
host's operators by self CPU time per call.  The chrome traces go to
``chiprun_out/wide_bwd_timeline/<label>_<k8|staged_step>.json``.

``--root`` imports ``pyrayt_tpu_torch`` and ``chip_smoke`` from another
checkout (an older commit, for a comparison in one run).  Needs one CUDA
device and ``nvcc``.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
CALLS = 5


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--rays", type=int, default=1 << 20)
    parser.add_argument("--root", default=str(ROOT))
    parser.add_argument("--label", default="tree")
    args = parser.parse_args()
    sys.path.insert(0, args.root)
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    import chip_smoke as cs
    import pyrayt_tpu_torch as pyrayt
    from pyrayt_tpu_torch import components as comp
    from pyrayt_tpu_torch.analysis import metrics
    from pyrayt_tpu_torch.config import TraceConfig
    from pyrayt_tpu_torch.ops import fused_grad as fg
    from pyrayt_tpu_torch.ops import fused_trace as ft
    from pyrayt_tpu_torch.scene import fresh_ids
    from pyrayt_tpu_torch.scene.compile import compile_scene

    assert Path(fg.__file__).resolve().is_relative_to(Path(args.root).resolve()), fg.__file__
    device = torch.device("cuda", 0)
    with fresh_ids():
        system, detector, _ = cs.mla_system(comp, pyrayt, cs.MLA_N)
        scene = compile_scene(system, device=device, dtype=torch.float32)
    span = cs.MLA_N * cs.MLA_PITCH * 1.05
    rays = comp.GridOfRays(span, span).move_x(-1.0).generate_rays(args.rays, device=device,
                                                                  dtype=torch.float32)
    config = TraceConfig(generation_limit=cs.MLA_GENERATIONS, fixed_loop=True)
    inputs = ft.wide_kernel_inputs(scene.spec, scene.params, rays)
    records, masks, _ = ft.fused_trace_wide(scene.spec, config, *inputs)
    plan = fg.loss_plan(metrics.RmsSpotRadius(float(detector.get_id())))
    scal = plan.row(plan.scalars(records, masks), torch.ones((), device=device))

    def k8_call():
        return fg.fused_bwd_wide(scene.spec, config, *inputs, records, masks, scal=scal,
                                 plan=plan)

    _, _, _, fold5, win = ft.fused_trace_wide(scene.spec, config, *inputs, save_fold=True)
    state0, obj_tx, prim, glass, slots = inputs[:5]

    def staged_step():
        return fg.staged_bwd(scene.spec, config, state0, obj_tx, prim, glass, slots, records,
                             masks, fold5, win, scal=scal, plan=plan)

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    out = ROOT / "chiprun_out" / "wide_bwd_timeline"
    out.mkdir(parents=True, exist_ok=True)
    summary = {"label": args.label, "root": args.root, "rays": args.rays, "card": card}
    for name, call in (("k8", k8_call), ("staged_step", staged_step)):
        event_ms = cs.cuda_ms(torch, call, repeats=10, warmup=3)
        enqueue = []
        for _ in range(10):
            torch.cuda.synchronize()
            start = time.perf_counter()
            call()
            enqueue.append((time.perf_counter() - start) * 1e3)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for i in range(CALLS):
                with record_function(f"call_{i}"):
                    call()
                torch.cuda.synchronize()
        prof.export_chrome_trace(str(out / f"{args.label}_{name}.json"))
        averages = prof.key_averages()
        # per kernel: its launches per call (the most the profiler saw in
        # one call's worth, rounded) times its mean device time per launch
        kernels = {}
        for e in averages:
            if (e.device_type == torch.autograd.DeviceType.CUDA and cs.device_us(e) > 0
                    and not e.key.startswith("call_")):  # the annotations' device spans
                per_launch = cs.device_us(e) / e.count / 1e3
                per_call = max(1, round(e.count / CALLS))
                kernels[e.key[:48]] = {"ms_per_launch": per_launch, "launches_per_call": per_call,
                                       "launches_seen": e.count}
        device_ms = sum(k["ms_per_launch"] * k["launches_per_call"] for k in kernels.values())
        host_ops = sorted(((e.key[:48], e.self_cpu_time_total / CALLS / 1e3) for e in averages
                           if e.device_type == torch.autograd.DeviceType.CPU
                           and not e.key.startswith(("call_", "cudaDeviceSynchronize"))),
                          key=lambda kv: -kv[1])
        summary[name] = {
            "event_ms": event_ms, "device_ms_per_call": device_ms,
            "event_minus_device_ms": event_ms - device_ms,
            "enqueue_ms_median": statistics.median(enqueue), "kernels": kernels,
            "host_ops_self_ms_per_call": dict(host_ops[:10])}
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Time the two kernels that run the wide fold, K2
(``ops/fused_trace.py:fused_trace_wide``) and K8
(``ops/fused_grad.py:fused_bwd_wide``), on the 16x16 microlens array at
float32 and float64, for a comparison of two checkouts in one run.

    python3 tests/test_torch/card_wide_fold_times.py [--root DIR] [--rays N]

Per dtype: K2 without save_fold on phase 13's grid of ``chip_smoke.py``
(0.95 of the array) and on the bench's (1.05, bench.py:1258), and K8 in
RmsSpotRadius loss mode on the bench's grid, each the median of 10 launches
by CUDA events after 2 warm-up launches; K8's per-ray kernel as the mean
device time of its launches in ``torch.profiler`` (5 calls).  Prints one
JSON line with the
card's name and power limit and, when this run built the kernels, what
``nvcc -Xptxas -v`` reported for K2's, K6/K7's and K8's entry functions
(registers, stack frame, spill stores and loads).  ``--root`` imports
``pyrayt_tpu_torch`` and ``chip_smoke`` from another checkout (e.g. the
parent commit unpacked under ``build/parent``).  Needs one CUDA device and ``nvcc``.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
# the entry functions whose build the script reports: K2, K6/K7, K8
KERNELS = ("fused_trace_wide_kernel", "staged_fold_kernel", "wide_fused_bwd_kernel")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", default=str(ROOT))
    parser.add_argument("--rays", type=int, default=1 << 20)
    args = parser.parse_args()
    sys.path.insert(0, args.root)
    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    import pyrayt_tpu_torch as pyrayt
    from pyrayt_tpu_torch import components as comp
    from pyrayt_tpu_torch.analysis import metrics
    from pyrayt_tpu_torch.config import TraceConfig
    from pyrayt_tpu_torch.ops import fused_grad as fg
    from pyrayt_tpu_torch.ops import fused_trace as ft
    from pyrayt_tpu_torch.scene import fresh_ids
    from pyrayt_tpu_torch.scene.compile import compile_scene

    assert Path(ft.__file__).resolve().is_relative_to(Path(args.root).resolve()), ft.__file__
    device = torch.device("cuda", 0)
    usage = {}
    for stem, (_, _, log) in ft.build_kernels().items():
        lines = log.splitlines()
        for i, line in enumerate(lines[:-2]):
            for kernel in KERNELS:
                at = line.find(kernel)
                if "Compiling entry" in line and at >= 0:
                    name = line[at:at + len(kernel) + 6].split("EE")[0].split("Ev")[0]
                    usage[name] = " ".join(x.replace("ptxas info    :", "").strip()
                                           for x in lines[i + 1:i + 4]
                                           if "stack frame" in x or "registers" in x)
    out = {"root": args.root, "rays": args.rays, "card": cs.card_line(), "ptxas": usage}
    config = TraceConfig(generation_limit=cs.MLA_GENERATIONS, fixed_loop=True)
    for dtype in (torch.float32, torch.float64):
        tag = str(dtype).replace("torch.", "")
        with fresh_ids():
            system, detector, _ = cs.mla_system(comp, pyrayt, cs.MLA_N)
            scene = compile_scene(system, device=device, dtype=dtype)
        spec = scene.spec
        for grid_name, factor in (("phase13", 0.95), ("bench", 1.05)):
            span = cs.MLA_N * cs.MLA_PITCH * factor
            rays = comp.GridOfRays(span, span).move_x(-1.0).generate_rays(
                args.rays, device=device, dtype=dtype)
            inputs = ft.wide_kernel_inputs(spec, scene.params, rays)
            records, masks, _ = ft.fused_trace_wide(spec, config, *inputs)
            plan = fg.loss_plan(metrics.RmsSpotRadius(float(detector.get_id())))
            scal = plan.row(plan.scalars(records, masks), torch.ones((), device=device))
            out[f"k2_{grid_name}_{tag}_ms"] = cs.cuda_ms(
                torch, lambda: ft.fused_trace_wide(spec, config, *inputs))
            if grid_name == "bench":
                def k8():
                    return fg.fused_bwd_wide(spec, config, *inputs, records, masks,
                                             scal=scal, plan=plan)

                out[f"k8_{tag}_ms"] = cs.cuda_ms(torch, k8)
                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    for _ in range(5):
                        k8()
                    torch.cuda.synchronize()
                per_ray = [cs.device_us(e) / e.count / 1e3 for e in prof.key_averages()
                           if "wide_fused_bwd_kernel" in e.key and cs.device_us(e) > 0]
                out[f"k8_per_ray_device_{tag}_ms"] = per_ray[0] if per_ray else None
            del rays, inputs, records, masks
        del scene
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

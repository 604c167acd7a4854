"""Build the monolithic wide backward K8 (``csrc/wide_fused_grad.cu``) under
other ``__launch_bounds__`` and register caps, and time each build on the
16x16 microlens array (513 leaves, 2**20 rays, 4 generations, float32,
RmsSpotRadius loss mode) against the shipped one.

    python3 tests/test_torch/card_launch_bounds.py [--rays N]

Per variant: ptxas's registers, stack frame and spills, the median ms of
ten launches (CUDA events), and whether its gradients equal the shipped
build's bit for bit (a register allocation changes no arithmetic).  Needs
one CUDA device and ``nvcc``; the variants build into a temporary
directory.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
SHIPPED = "__launch_bounds__(kThreads) wide_fused_bwd_kernel"
# (label, launch bounds of the kernel, extra nvcc flags)
VARIANTS = (
    ("shipped (128)", "__launch_bounds__(kThreads)", []),
    ("(128, 1)", "__launch_bounds__(kThreads, 1)", []),
    ("(128, 2)", "__launch_bounds__(kThreads, 2)", []),
    ("(128, 4)", "__launch_bounds__(kThreads, 4)", []),
    ("(128), maxrregcount 255", "__launch_bounds__(kThreads)", ["-maxrregcount=255"]),
)


def build(ft, source: Path, out: Path, flags):
    cmd = [ft._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
           "-Xcompiler", "-fPIC", "-Xptxas", "-v", *flags, "-o", str(out), str(source)]
    log = subprocess.run(cmd, check=True, capture_output=True, text=True).stderr
    usage = {}
    entry = None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            entry = m.group(1)
            continue
        if entry and "wide_fused_bwd_kernel" in entry:
            kind = (("f32" if "IfLb" in entry else "f64")
                    + ("_loss" if "Lb1" in entry else "_generic"))
            u = usage.setdefault(kind, {})
            for key, pattern in (("stack", r"(\d+) bytes stack frame"),
                                 ("spill_stores", r"(\d+) bytes spill stores"),
                                 ("registers", r"Used (\d+) registers")):
                m = re.search(pattern, line)
                if m:
                    u[key] = int(m.group(1))
    return usage


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--rays", type=int, default=1 << 20)
    args = parser.parse_args()
    sys.path.insert(0, str(ROOT))
    import torch

    import chip_smoke as cs
    import pyrayt_tpu_torch as pyrayt
    from pyrayt_tpu_torch import components as comp
    from pyrayt_tpu_torch.analysis import metrics
    from pyrayt_tpu_torch.config import TraceConfig
    from pyrayt_tpu_torch.ops import fused_grad as fg
    from pyrayt_tpu_torch.ops import fused_trace as ft
    from pyrayt_tpu_torch.scene import fresh_ids
    from pyrayt_tpu_torch.scene.compile import compile_scene

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
    call = (scene.spec, config, *inputs[:5], inputs[6], records, masks, None, None, scal, plan)
    source = (ROOT / "pyrayt_tpu_torch" / "csrc" / "wide_fused_grad.cu").read_text()
    assert SHIPPED in source, "the kernel's launch bounds moved; update this script"
    reference = None
    results = []
    with tempfile.TemporaryDirectory() as tmp:
        for k, (label, bounds, flags) in enumerate(VARIANTS):
            src = Path(tmp) / f"k8_{k}.cu"
            for header in (ROOT / "pyrayt_tpu_torch" / "csrc").glob("*.cuh"):
                (Path(tmp) / header.name).write_text(header.read_text())
            src.write_text(source.replace(SHIPPED, f"{bounds} wide_fused_bwd_kernel"))
            lib_path = Path(tmp) / f"libk8_{k}.so"
            usage = build(ft, src, lib_path, flags)
            fg._wide_fused_library.cache_clear()
            ft.build_kernels = lambda lib_path=lib_path: {"wide_fused_grad": (str(lib_path), 0, "")}
            out = fg._wide_fused_launch(*call)
            if reference is None:
                reference = out
            identical = all(torch.equal(a, b) for a, b in zip(out, reference))
            for _ in range(2):
                fg._wide_fused_launch(*call)
            torch.cuda.synchronize()
            times = []
            for _ in range(10):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                fg._wide_fused_launch(*call)
                end.record()
                end.synchronize()
                times.append(start.elapsed_time(end))
            result = {"variant": label, "ms": statistics.median(times), "identical": identical,
                      "ptxas": usage}
            results.append(result)
            print(json.dumps(result), flush=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(f"K8 launch bounds, {cs.MLA_N}x{cs.MLA_N} array, {args.rays} rays, float32, loss mode, "
          f"on {card}")
    return 0 if all(r["identical"] for r in results) else 1


if __name__ == "__main__":
    sys.exit(main())

"""Run the wide kernels of pyrayt_tpu_torch (K2, K5, K6, K7) under NVIDIA's
compute-sanitizer, memcheck and initcheck, on small wide scenes.

    python3 tests/test_torch/card_sanitize.py [--csrc DIR] [--label NAME]

Starts one child process without a tool and one per tool, each under a time
limit.  A child builds the kernels, then drives K2 with ``save_fold`` and
the staged backward (K5 in its loss and generic modes, K6, K7) on the 5x5
microlens array, the array with CSG singles and the heterogeneous lens wall
at 256 rays, float64 and float32, and checks that the outputs are finite.
Each child's log and a summary (exit codes, the tools' error counts) go to
``chiprun_out/sanitize`` under the name ``--label`` (default ``shipped``);
the summary is also printed.

``--csrc`` builds the kernels from another copy of ``pyrayt_tpu_torch/csrc``
(into ``DIR/build``), so an edited copy can be held to the same checks.
Needs one CUDA device and the CUDA toolkit; exits non-zero if a child
without a tool fails.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
TOOLS = ("memcheck", "initcheck")


def sanitizer() -> str:
    for candidate in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin",
                                   "compute-sanitizer"), "/usr/local/cuda/bin/compute-sanitizer"):
        if os.path.exists(candidate):
            return candidate
    return "compute-sanitizer"


def child(csrc: str | None) -> int:
    sys.path[:0] = [str(ROOT), str(ROOT / "tests" / "test_torch")]
    import torch

    from pyrayt_tpu_torch import interop
    from pyrayt_tpu_torch.analysis import metrics
    from pyrayt_tpu_torch.config import TraceConfig
    from pyrayt_tpu_torch.ops import _cuda
    from pyrayt_tpu_torch.ops import fused_grad as fg
    from pyrayt_tpu_torch.ops import fused_trace as ft

    if csrc:
        _cuda._CSRC_DIR = Path(csrc)
        _cuda._BUILD_DIR = Path(csrc) / "build"
    from torch_parity_scenes import TORCH_NS, WIDE_SCENES, wide_rays

    ft.build_kernels()
    device = torch.device("cuda", 0)
    for name in ("mla5", "csg_singles", "hetero"):
        build, _, _, gens = WIDE_SCENES[name]
        for dtype in (torch.float64, torch.float32):
            with TORCH_NS.fresh_ids():
                scene = TORCH_NS.compile(build(TORCH_NS), device=device, dtype=dtype)
            spec = scene.spec
            rays = interop.rays_from_numpy(*wide_rays(name), device=device, dtype=dtype)
            inputs = ft.wide_kernel_inputs(spec, scene.params, rays)
            state0, obj_tx, prim, glass, slots = inputs[:5]
            config = TraceConfig(generation_limit=gens, fixed_loop=True)
            records, masks, fstate, fold5, win = ft.fused_trace_wide(spec, config, *inputs,
                                                                     save_fold=True)
            plan = fg.loss_plan(metrics.RmsSpotRadius(float(spec.leaf_ids[-1])))
            scal = plan.row(plan.scalars(records, masks), torch.ones((), device=device))
            gen = torch.Generator(device="cpu").manual_seed(3)
            d_records = (torch.randn(records.shape, generator=gen, dtype=torch.float64)
                         .to(device, dtype) * masks[:, None]).contiguous()
            d_fstate = torch.randn(fstate.shape, generator=gen, dtype=torch.float64).to(device,
                                                                                       dtype)
            loss = fg.staged_bwd(spec, config, state0, obj_tx, prim, glass, slots, records, masks,
                                 fold5, win, scal=scal, plan=plan)
            generic = fg.staged_bwd(spec, config, state0, obj_tx, prim, glass, slots, records,
                                    masks, fold5, win, d_records=d_records, d_fstate=d_fstate)
            torch.cuda.synchronize()
            outs = (records, fstate, fold5.nan_to_num(posinf=0.0)) + loss + generic
            finite = all(bool(torch.isfinite(t).all()) for t in outs)
            print(f"{name} {str(dtype)[6:]}: {int(masks.sum())} records, "
                  f"{int((win >= 0).sum())} tree hits, finite {finite}", flush=True)
            if not finite:
                return 1
    return 0


def errors_of(log: str):
    """The tool's own error count ("ERROR SUMMARY: N errors"), or None."""
    found = re.findall(r"ERROR SUMMARY: (\d+) error", log)
    return int(found[-1]) if found else None


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--csrc", help="another copy of pyrayt_tpu_torch/csrc to build from")
    parser.add_argument("--label", default="shipped")
    parser.add_argument("--timeout", type=int, default=600)
    parser.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.child:
        return child(args.csrc)

    out = ROOT / "chiprun_out" / "sanitize"
    out.mkdir(parents=True, exist_ok=True)
    me = [sys.executable, str(Path(__file__).resolve()), "--child"]
    if args.csrc:
        me += ["--csrc", args.csrc]
    summary = {}
    for tool in (None,) + TOOLS:
        cmd = me if tool is None else [sanitizer(), "--tool", tool, "--print-limit", "20"] + me
        # one device allocation per tensor, so memcheck sees each tensor's bounds
        env = dict(os.environ, CUDA_LAUNCH_BLOCKING="1", PYTORCH_NO_CUDA_MEMORY_CACHING="1")
        start = time.perf_counter()
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True, timeout=args.timeout,
                                  env=env, cwd=ROOT)
            rc, log = proc.returncode, proc.stdout + proc.stderr
        except subprocess.TimeoutExpired as exc:
            rc = "timeout"
            log = "".join(x.decode() if isinstance(x, bytes) else (x or "")
                          for x in (exc.stdout, exc.stderr))
        except OSError as exc:
            rc, log = "not started", str(exc)
        name = tool or "no_tool"
        (out / f"{args.label}_{name}.log").write_text(log)
        summary[name] = {"rc": rc, "seconds": round(time.perf_counter() - start, 1),
                         "errors": errors_of(log), "tail": log.strip().splitlines()[-3:]}
        print(args.label, name, json.dumps(summary[name]), flush=True)
    (out / f"{args.label}_summary.json").write_text(json.dumps(summary, indent=1))
    return 0 if summary["no_tool"]["rc"] == 0 else 1


if __name__ == "__main__":
    sys.exit(main())

"""Time the staged wide tail K5 (``ops/fused_grad.py:staged_tail``) on the
card and split where its time goes, for a comparison of two checkouts in
one run.

    python3 tests/test_torch/card_staged_tail_times.py [--root DIR] [--rays N]

Cases: the 16x16 microlens array of ``chip_smoke.py`` (513 leaves, the
phase-13 ray grid, 2**20 rays, 4 generations, a K2 trace with
``save_fold``) at float32 and float64, RmsSpotRadius through K5's loss mode
and the lenslet blur's record cotangent through its generic mode.  K5 gets
the inputs one staged backward step hands it (the reverse chain's carried
cotangents, captured by wrapping ``staged_tail`` during one ``staged_bwd``
call).  Per case, summed over the generations the step runs: the device
time of ``staged_tail_kernel`` and of its ``reduce_partials`` under
``torch.profiler`` (``chip_smoke.device_ms``), back-to-back calls between
one pair of CUDA events, one call between two events (host work
included), the wrapper's host time until it returns, and whether two
launches are bit-identical; and the blocks per SM that
``cudaOccupancyMaxActiveBlocksPerMultiprocessor`` allows at float32 and
float64.

Then it builds variants of ``csrc/wide_grad.cu`` into a temporary
directory (never into the library), all at once: the source as it is, the
glass fold removed, the adjoint removed (``tail_adjoint`` and the hit
point's adjoint, the record cotangent kept), and, where the source reads
every record row of every ray, the reads of the rays that did not run the
generation removed; each variant's registers, stack frame and spills
(``nvcc -Xptxas -v``), its occupancy and its K5 device time per step at
float32 in both modes.  A variant that removes work computes wrong
cotangents: it only splits the time.  Prints one JSON line per case and
variant and a last JSON line with everything and the card's name and power
limit.  ``--root`` imports ``pyrayt_tpu_torch`` from another checkout (e.g. the
parent commit unpacked under ``build/parent``) and builds its sources; the
scenes and the timing helpers are this checkout's ``chip_smoke.py``.  Needs one CUDA device
and ``nvcc``.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
import tempfile
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parents[1]

# cudaOccupancyMaxActiveBlocksPerMultiprocessor for a source that does not
# export it (K5 with its block-wide glass fold): its launch's shared memory
OCCUPANCY_SNIPPET = r"""
extern "C" int pyrayt_staged_tail_occupancy(int f64, int loss, int n_glass) {
  const size_t item = f64 ? sizeof(double) : sizeof(float);
  const size_t smem = sizeof(double) * kGlass * kThreads +
                      item * (kGlass * static_cast<size_t>(n_glass) + kMaxScal) +
                      sizeof(int) * (static_cast<size_t>(n_glass) + kThreads);
  int blocks = 0;
  cudaError_t err;
  if (f64) {
    auto k = loss ? staged_tail_kernel<double, true> : staged_tail_kernel<double, false>;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, k, kThreads, smem);
  } else {
    auto k = loss ? staged_tail_kernel<float, true> : staged_tail_kernel<float, false>;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, k, kThreads, smem);
  }
  cudaGetLastError();  // leave no error for the next launch to report
  return err == cudaSuccess ? blocks : -static_cast<int>(err);
}
"""

# the block-wide glass fold: staging, a barrier, 7 M threads each walking
# the block's rays in order
BLOCK_FOLD = re.compile(r"  // glass cotangents: stage, then fold.*?\n  }\n(?=}\n)", re.S)
# what a removed fold leaves: the glass values stay live
KEEP_GLASS = ("  if (slot_out >= 0) {\n    double s = 0.0;\n"
              "    for (int k = 0; k < kGlass; ++k) s += static_cast<double>(gl[k]);\n"
              "    if (s == 1.25e300) partials[blockIdx.x] = s;\n  }\n")
ADJOINT = re.compile(r"      TailAdjoint<T> a;\n.*?      bar = input_bar\(a\);\n", re.S)
# what a removed adjoint leaves: the fold rows and the record cotangent
# stay live
NO_ADJOINT = ("      slot_out = slot;\n"
              "      for (int k = 0; k < kGlass; ++k) gl[k] = rb[k] + nrm[k % 3];\n"
              "      t_bar = best + rb[7];\n"
              "      for (int c = 0; c < 3; ++c) nrm_bar[c] = nrm[c] * rb[c];\n"
              "      bar.p[0] += rb[8] + rb[9] + rb[10] + rb[11] + rb[12] + rb[13] + rb[14];\n")
# K5 reading all 15 record rows of every ray before it knows whether the
# ray ran the generation
ALL_READS = "    for (int c = 0; c < kRecordCols; ++c) r[c] = rec[c * n + i];\n"
LIVE_READS = ("    bool live = pmask == nullptr || pmask[i];\n"
              "    for (int c = 12; c < 15; ++c) r[c] = live ? rec[c * n + i] : T(0);\n"
              "    live = live && (pmask == nullptr || r[12] != T(0) || r[13] != T(0) ||"
              " r[14] != T(0));\n"
              "    for (int c = 0; c < 12; ++c) r[c] = live ? rec[c * n + i] : T(0);\n")


def variants(source: str):
    """[(label, edited source)] of the variants this source allows."""
    out = [("as is", source)]
    if BLOCK_FOLD.search(source):
        out.append(("no glass fold", BLOCK_FOLD.sub(lambda m: KEEP_GLASS, source, count=1)))
    if ADJOINT.search(source):
        out.append(("no adjoint", ADJOINT.sub(lambda m: NO_ADJOINT, source, count=1)))
    if ALL_READS in source:
        out.append(("no dead reads", source.replace(ALL_READS, LIVE_READS)))
    return out


def ptxas_usage(log: str):
    """{entry: {registers, stack, spill_stores, spill_loads}} of K5's entry
    functions (staged_tail_kernel in both modes and types) and
    reduce_partials in an ``nvcc -Xptxas -v`` log."""
    usage, entry = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
            entry = None
            if "staged_tail_kernel" in name:
                entry = ("loss" if "Lb1" in name else "generic") + (
                    "_f32" if "IfLb" in name else "_f64")
            elif "reduce_partials" in name:
                entry = "reduce_" + ("f32" if "If" in name else "f64")
            continue
        if entry is None:
            continue
        u = usage.setdefault(entry, {})
        for key, pattern in (("stack", r"(\d+) bytes stack frame"),
                             ("spill_stores", r"(\d+) bytes spill stores"),
                             ("spill_loads", r"(\d+) bytes spill loads"),
                             ("registers", r"Used (\d+) registers")):
            m = re.search(pattern, line)
            if m:
                u[key] = int(m.group(1))
    return usage


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", default=str(ROOT))
    parser.add_argument("--rays", type=int, default=1 << 20)
    args = parser.parse_args()
    root = Path(args.root).resolve()
    sys.path[:0] = [str(ROOT)]
    import chip_smoke as cs  # this checkout's scenes and timing helpers

    sys.path[:1] = [str(root)]
    import ctypes

    import torch

    import pyrayt_tpu_torch as pyrayt
    from pyrayt_tpu_torch import components as comp
    from pyrayt_tpu_torch.analysis import metrics
    from pyrayt_tpu_torch.config import TraceConfig
    from pyrayt_tpu_torch.ops import _cuda
    from pyrayt_tpu_torch.ops import fused_grad as fg
    from pyrayt_tpu_torch.ops import fused_trace as ft
    from pyrayt_tpu_torch.scene import fresh_ids
    from pyrayt_tpu_torch.scene.compile import compile_scene
    from pyrayt_tpu_torch.tracer import engine

    assert Path(ft.__file__).resolve().is_relative_to(root), ft.__file__
    device = torch.device("cuda", 0)
    config = TraceConfig(generation_limit=cs.MLA_GENERATIONS, fixed_loop=True)
    span = cs.MLA_N * cs.MLA_PITCH * 0.95  # chip_smoke.py phase 13's grid
    grid = comp.GridOfRays(span, span).move_x(-1.0)

    def calls_of(dtype):
        """{mode: [one K5 call per generation of a staged step]} and the
        number of glass slots."""
        with fresh_ids():
            system, detector, _ = cs.mla_system(comp, pyrayt, cs.MLA_N)
            scene = compile_scene(system, device=device, dtype=dtype)
        spec = scene.spec
        rays = grid.generate_rays(args.rays, device=device, dtype=dtype)
        inputs = ft.wide_kernel_inputs(spec, scene.params, rays)
        state0, obj_tx, prim, glass, slots = inputs[:5]
        records, masks, fstate, fold5, win = ft.fused_trace_wide(spec, config, *inputs,
                                                                 save_fold=True)
        det_id = float(detector.get_id())
        plan = fg.loss_plan(metrics.RmsSpotRadius(det_id))
        scal = plan.row(plan.scalars(records, masks), torch.ones((), device=device))
        rec_var = records.detach().clone().requires_grad_(True)
        (d_records,) = torch.autograd.grad(cs.lenslet_blur_loss(torch, metrics, det_id, cs.MLA_N)(
            engine.TraceResult(rec_var, masks, ft.rays_from_state(fstate),
                               masks.any(dim=1).sum())), rec_var)
        modes = {"loss": dict(scal=scal, plan=plan),
                 "generic": dict(d_records=d_records.contiguous(),
                                 d_fstate=torch.zeros_like(fstate))}
        out = {}
        real = fg.staged_tail
        for mode, kw in modes.items():
            captured = []

            def capture(*a, **k):
                captured.append((a, k))
                return real(*a, **k)

            capture.launches = 0  # the wrapper counts through the module's name

            fg.staged_tail = capture
            try:
                fg.staged_bwd(spec, config, state0, obj_tx, prim, glass, slots, records, masks,
                              fold5, win, **kw)
            finally:
                fg.staged_tail = real
            out[mode] = [lambda a=a, k=k: fg.staged_tail(*a, **k) for a, k in captured]
        return out, glass.shape[0]

    def step_times(calls, full=True):
        """K5's times per staged step: each kind summed over the step's
        calls."""
        total = {}
        for call in calls:
            if full:
                t = cs.kernel_times(torch, call, cs.K5_NAMES)
                first, second = call(), call()
                t["bit_identical"] = all(torch.equal(a, b) for a, b in zip(first, second))
            else:
                t = {"device_ms": cs.device_ms(torch, call, cs.K5_NAMES)[0]}
            for key, v in t.items():
                if key == "device_by_kernel":
                    for name, ms in v.items():
                        total.setdefault(key, {})[name] = total.get(key, {}).get(name, 0.0) + ms
                elif key == "bit_identical":
                    total[key] = total.get(key, True) and v
                else:
                    total[key] = total.get(key, 0.0) + v
        total["launches_per_step"] = len(calls)
        return total

    # the variants, built together into a temporary directory
    csrc = root / "pyrayt_tpu_torch" / "csrc"
    source = (csrc / "wide_grad.cu").read_text()
    tmp = tempfile.TemporaryDirectory()
    for header in csrc.glob("*.cuh"):
        (Path(tmp.name) / header.name).write_text(header.read_text())
    builds = []
    for k, (label, text) in enumerate(variants(source)):
        if "pyrayt_staged_tail_occupancy" not in text:
            text += OCCUPANCY_SNIPPET
        src, lib = Path(tmp.name) / f"tail_{k}.cu", Path(tmp.name) / f"libtail_{k}.so"
        src.write_text(text)
        cmd = [_cuda._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
               "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", str(lib), str(src)]
        builds.append((label, lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                    stderr=subprocess.STDOUT, text=True)))
    library = ft.build_kernels()["wide_grad"]
    out = {"root": str(root), "rays": args.rays, "card": cs.card_line(),
           "ptxas": ptxas_usage(library[2]), "cases": {}, "variants": []}
    built = []
    for label, lib, proc in builds:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            out["variants"].append({"variant": label, "build_failed": log[-2000:]})
            continue
        built.append((label, lib, ptxas_usage(log)))

    def occupancy(lib_path, n_glass):
        lib = ctypes.CDLL(str(lib_path))
        fn = lib.pyrayt_staged_tail_occupancy
        fn.argtypes = [ctypes.c_int] * 3
        fn.restype = ctypes.c_int
        return {f"{mode}_{tag}": fn(int(f64), int(mode == "loss"), n_glass)
                for mode in ("loss", "generic") for tag, f64 in (("f32", False), ("f64", True))}

    timed, n_glass = {}, 0
    for dtype in (torch.float32, torch.float64):
        tag = str(dtype).replace("torch.", "")
        calls, n_glass = calls_of(dtype)
        for mode, mode_calls in calls.items():
            res = step_times(mode_calls)
            out["cases"][f"{mode}_{tag}"] = res
            print(json.dumps({f"{mode}_{tag}": res}), flush=True)
            if dtype == torch.float32:
                timed[mode] = mode_calls
        if dtype == torch.float64:
            del calls
            torch.cuda.empty_cache()
    base = [lib for label, lib, _ in built if label == "as is"]
    if base:
        out["blocks_per_sm"] = occupancy(base[0], n_glass)
    real_build = _cuda.build_kernels
    for label, lib, usage in built:
        _cuda.library.cache_clear()
        _cuda.build_kernels = lambda lib=lib: {**real_build(), "wide_grad": (str(lib), 0.0, "")}
        entry = {"variant": label, "ptxas": usage, "blocks_per_sm": occupancy(lib, n_glass)}
        for mode, mode_calls in timed.items():
            entry[f"{mode}_f32_device_ms"] = step_times(mode_calls, full=False)["device_ms"]
        out["variants"].append(entry)
        print(json.dumps(entry), flush=True)
    _cuda.build_kernels = real_build
    _cuda.library.cache_clear()
    tmp.cleanup()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Time the narrow backward kernels K3 (``ops/fused_grad.py:fused_bwd_loss``)
and K4 (``fused_bwd``) and split where their time goes, for a comparison of
two checkouts in one run.

    python3 tests/test_torch/card_narrow_bwd_times.py [--root DIR] [--rays N]

Cases: the condenser of ``chip_smoke.py`` at float32 and float64 (2**20
rays, 6 generations, RmsSpotRadius), the achromatic doublet of
examples/lens_design.py at float64 (1,048,578 rays, 8 generations,
SoftFocusError, as ``chip_smoke.py`` phase 6 runs it) and the 31-leaf
``hetero_row`` gradient scene of ``torch_parity_scenes.py`` at float32
and float64 (2**20 rays, 5 generations, RmsSpotRadius on its detector).
K4 gets seeded record and final-state cotangents.  Per case and kernel:
the median ms of 10 calls by CUDA events after 2 warm-ups, the device time
per launch of the main kernel and of ``reduce_partials`` under
``torch.profiler`` (5 calls), the median host ms until the wrapper returns
(10 calls, each after a synchronize), and the blocks per SM that
``cudaOccupancyMaxActiveBlocksPerMultiprocessor`` allows.

Then it builds variants of ``csrc/fused_grad.cu`` into a temporary
directory (never into the library), all at once: the source as it is, the
parameter fold removed (its per-generation scan alone, where the source
has one, and the whole fold with its barriers), the warp-level fold
always key by key or always column by column (where the source chooses
between them), the adjoint removed after the forward recompute, and
other launch bounds and block sizes where the source names them; each
variant's registers, stack frame and spills
(``nvcc -Xptxas -v``), its occupancy and its K3/K4 times on the condenser
and on ``hetero_row`` at float32.  A variant that removes work computes
wrong gradients: it only splits the time.  Prints one JSON line per
variant and a last JSON line with everything and the card's name and
power limit.  ``--root`` imports ``pyrayt_tpu_torch`` and ``chip_smoke``
from another checkout (e.g. the parent commit unpacked under
``build/parent``) and builds its sources.  Needs one CUDA device and
``nvcc``.
"""

from __future__ import annotations

import argparse
import json
import re
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parents[1]
PROFILED = 5

# cudaOccupancyMaxActiveBlocksPerMultiprocessor for a source that does not
# export it (the kernel before the warp-level fold): its launch's shared
# memory formula
OCCUPANCY_SNIPPET = r"""
extern "C" int pyrayt_bwd_occupancy(int f64, int loss, int n_leaves, int n_glass,
                                    int program_len) {
  const size_t n_entries =
      22 * static_cast<size_t>(n_leaves) + kGlass * static_cast<size_t>(n_glass);
  const size_t item = f64 ? sizeof(double) : sizeof(float);
  const size_t smem = sizeof(double) * (n_entries + (kGeo + kGlass) * kThreads) +
                      item * (n_entries + kMaxScal) +
                      sizeof(int) * (2 * kThreads + static_cast<size_t>(program_len));
  int blocks = 0;
  cudaError_t err;
  if (f64) {
    auto k = loss ? fused_bwd_kernel<double, true> : fused_bwd_kernel<double, false>;
    if (smem > 48 * 1024) {
      cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    }
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, k, kThreads, smem);
  } else {
    auto k = loss ? fused_bwd_kernel<float, true> : fused_bwd_kernel<float, false>;
    if (smem > 48 * 1024) {
      cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    }
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, k, kThreads, smem);
  }
  cudaGetLastError();  // leave no error for the next launch to report
  return err == cudaSuccess ? blocks : -static_cast<int>(err);
}
"""

# the kernel before the warp-level fold: each generation stages every ray's
# values, then scans them block-wide
STAGED_SCAN = "    if (__syncthreads_or(leaf >= 0)) {\n"
# what a removed fold leaves: the values it would have summed stay live
KEEP_VALUES = ("    if (leaf >= 0) { for (int k = 0; k < kGeo; ++k) bar.p[0] += geo[k]; }\n"
               "    if (slot >= 0) { for (int k = 0; k < kGlass; ++k) bar.p[0] += gl[k]; }\n")
ADJOINT_MARK = "  // ---- adjoint: next state, record and material --------------------------\n"
NO_ADJOINT = ("  leaf_out = no_hit ? -1 : leaf;\n  slot_out = -1;\n"
              "  for (int c = 0; c < 3; ++c) { geo[c] = nrm[c]; geo[3 + c] = ph[c]; }\n"
              "  bar.p[0] += t;\n  return;\n")


def fold_block(source: str):
    """The text of the per-generation fold in ``source``: the staging and
    scan of the kernel before the warp-level fold (from its staging to the
    barrier that closes the generation), or the warp-level fold's call."""
    start = source.find("    st_leaf[tid] = leaf;\n")
    if start >= 0:
        end = source.index("    __syncthreads();\n  }\n", start) + len("    __syncthreads();\n")
        return source[start:end]
    m = re.search(r"    warp_fold\([^;]*\);\n", source)
    return m.group(0) if m else None


def variants(source: str):
    """[(label, edited source)] of the variants this source allows."""
    out = [("as is", source)]
    if STAGED_SCAN in source:
        out.append(("no scan", source.replace(
            STAGED_SCAN, "    if (__syncthreads_or(leaf >= 0) && n_entries < 0) {\n")))
    block = fold_block(source)
    if block:
        out.append(("no fold", source.replace(block, KEEP_VALUES)))
    keys = re.search(r"constexpr int kKeyFoldMax = \d+;", source)
    if keys:
        for label, limit in (("key fold only", 64), ("column fold only", -1)):
            edited = source.replace(keys.group(0), f"constexpr int kKeyFoldMax = {limit};")
            out.append((label, edited))
    if ADJOINT_MARK in source:
        out.append(("no adjoint", source.replace(ADJOINT_MARK, ADJOINT_MARK + NO_ADJOINT)))
    bounds = re.search(r"__launch_bounds__\((\w+)\) fused_bwd_kernel", source)
    if bounds:
        for min_blocks in (2, 3, 4):
            out.append((f"launch bounds ({bounds.group(1)}, {min_blocks})", source.replace(
                bounds.group(0), f"__launch_bounds__({bounds.group(1)}, {min_blocks}) "
                                 "fused_bwd_kernel")))
    threads = re.search(r"constexpr int kBwdThreads = (\d+);", source)
    if threads:
        for n in (64, 256):
            out.append((f"{n} threads", source.replace(threads.group(0),
                                                       f"constexpr int kBwdThreads = {n};")))
    return out


def ptxas_usage(log: str):
    """{entry: {registers, stack, spill_stores, spill_loads}} of the
    backward's entry functions (the four fused_bwd_kernel instances and
    reduce_partials) in an ``nvcc -Xptxas -v`` log."""
    usage, entry = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
            entry = None
            if "fused_bwd_kernel" in name:
                entry = ("k3" if "Lb1" in name else "k4") + ("_f32" if "IfLb" in name else "_f64")
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
    sys.path[:0] = [str(root), str(HERE)]
    import ctypes

    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from pyrayt_tpu_torch import components as comp
    from pyrayt_tpu_torch import interop
    from pyrayt_tpu_torch import materials as matl
    from pyrayt_tpu_torch.analysis import metrics
    from pyrayt_tpu_torch.config import TraceConfig
    from pyrayt_tpu_torch.ops import _cuda
    from pyrayt_tpu_torch.ops import fused_grad as fg
    from pyrayt_tpu_torch.ops import fused_trace as ft
    from pyrayt_tpu_torch.scene import fresh_ids
    from pyrayt_tpu_torch.scene.compile import compile_scene
    from torch_parity_scenes import GRAD_SCENES, TORCH_NS, grad_rays

    assert Path(ft.__file__).resolve().is_relative_to(root), ft.__file__
    device = torch.device("cuda", 0)
    one = torch.ones((), device=device)

    def case(label, scene, rays, gens, loss):
        """(label, spec, K3 call, K4 call, occupancy arguments)."""
        spec = scene.spec
        config = TraceConfig(generation_limit=gens, fixed_loop=True)
        inputs = ft.kernel_inputs(scene.params, rays)
        records, masks, _ = ft.fused_trace(spec, config, *inputs)
        plan = fg.loss_plan(loss)
        scal = plan.row(plan.scalars(records, masks), one)
        gen = torch.Generator(device=device).manual_seed(0)
        d_records = torch.randn(records.shape, generator=gen, device=device, dtype=rays.dtype)
        d_records = d_records * masks[:, None]
        d_fstate = torch.randn(inputs[0].shape, generator=gen, device=device, dtype=rays.dtype)
        bwd = (spec, config, *inputs, records, masks)
        program_len = int(ft.device_program(spec, device).numel())
        return (label, spec, lambda: fg.fused_bwd_loss(*bwd, scal, plan),
                lambda: fg.fused_bwd(*bwd, d_records, d_fstate),
                (spec.n_leaves, inputs[3].shape[0], program_len))

    def cases():
        for dtype in (torch.float32, torch.float64):
            tag = str(dtype).replace("torch.", "")
            with fresh_ids():
                source, parts = cs.condenser(comp, matl)
                scene = compile_scene(parts, device=device, dtype=dtype)
                rays = source.generate_rays(args.rays, device=device, dtype=dtype)
            yield case(f"condenser_{tag}", scene, rays, cs.GENERATIONS,
                       metrics.RmsSpotRadius(float(scene.spec.leaf_ids[-1])))
        r0 = cs.doublet_radii_initial(matl)
        with fresh_ids():
            parts = cs.build_doublet(comp, matl, r0)
            scene = compile_scene(parts, device=device, dtype=torch.float64)
        rays = cs.design_rays(comp, torch, device, torch.float64,
                              n_radii=max(round(args.rays / 6), 1))
        soft = metrics.SoftFocusError(
            cs.DOUBLET_FOCUS, float(parts[-1].get_id()),
            half_widths=(cs.LENS_DIAMETER / 2, cs.LENS_DIAMETER / 2), ramp=cs.LENS_DIAMETER / 20)
        yield case("doublet_float64", scene, rays, 8, soft)
        build, _, _, gens, _ = GRAD_SCENES["hetero_row"]
        for dtype in (torch.float32, torch.float64):
            tag = str(dtype).replace("torch.", "")
            with TORCH_NS.fresh_ids():
                scene = TORCH_NS.compile(build(TORCH_NS), device=device, dtype=dtype)
            rays = interop.rays_from_numpy(*grad_rays("hetero_row", n=args.rays), device=device,
                                           dtype=dtype)
            yield case(f"hetero_row_{tag}", scene, rays, gens,
                       metrics.RmsSpotRadius(float(scene.spec.leaf_ids[-1])))

    def host_ms(fn):
        times = []
        for _ in range(10):
            torch.cuda.synchronize()
            start = time.perf_counter()
            fn()
            times.append((time.perf_counter() - start) * 1e3)
        torch.cuda.synchronize()
        return statistics.median(times)

    def profiled(fn):
        """Device ms per launch of the main kernel and of reduce_partials."""
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(PROFILED):
                fn()
            torch.cuda.synchronize()
        out = {"kernel_device_ms": None, "reduce_device_ms": None}
        for e in prof.key_averages():
            us = cs.device_us(e)
            if us > 0 and "fused_bwd_kernel" in e.key:
                out["kernel_device_ms"] = us / e.count / 1e3
            elif us > 0 and "reduce_partials" in e.key:
                out["reduce_device_ms"] = us / e.count / 1e3
        return out

    # the variants, built together into a temporary directory
    csrc = root / "pyrayt_tpu_torch" / "csrc"
    source = (csrc / "fused_grad.cu").read_text()
    tmp = tempfile.TemporaryDirectory()
    for header in csrc.glob("*.cuh"):
        (Path(tmp.name) / header.name).write_text(header.read_text())
    builds = []
    for k, (label, text) in enumerate(variants(source)):
        if "pyrayt_bwd_occupancy" not in text:
            text += OCCUPANCY_SNIPPET
        src, lib = Path(tmp.name) / f"bwd_{k}.cu", Path(tmp.name) / f"libbwd_{k}.so"
        src.write_text(text)
        cmd = [_cuda._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
               "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", str(lib), str(src)]
        builds.append((label, lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                    stderr=subprocess.STDOUT, text=True)))
    library = ft.build_kernels()["fused_grad"]
    out = {"root": str(root), "rays": args.rays, "card": cs.card_line(),
           "ptxas": ptxas_usage(library[2]), "cases": {}, "variants": []}
    built = []
    for label, lib, proc in builds:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            out["variants"].append({"variant": label, "build_failed": log[-2000:]})
            continue
        built.append((label, lib, ptxas_usage(log)))

    def occupancy(lib_path, dims, f64):
        lib = ctypes.CDLL(str(lib_path))
        fn = lib.pyrayt_bwd_occupancy
        fn.argtypes = [ctypes.c_int] * 5
        fn.restype = ctypes.c_int
        return {kernel: fn(int(f64), int(kernel == "k3"), *dims) for kernel in ("k3", "k4")}

    def use(lib_path, log):
        _cuda.library.cache_clear()
        _cuda.build_kernels = lambda: {**real_build(), "fused_grad": (str(lib_path), 0.0, log)}

    base_lib = built[0][1] if built and built[0][0] == "as is" else None
    timed = {}
    for label, spec, k3, k4, dims in cases():
        f64 = label.endswith("float64")
        res = {"n_leaves": dims[0], "n_glass": dims[1]}
        for name, fn in (("k3", k3), ("k4", k4)):
            res[f"{name}_ms"] = cs.cuda_ms(torch, fn)
            res[f"{name}_host_ms"] = host_ms(fn)
            res.update({f"{name}_{key}": v for key, v in profiled(fn).items()})
        if base_lib is not None:
            res["blocks_per_sm"] = occupancy(base_lib, dims, f64)
        out["cases"][label] = res
        print(json.dumps({label: res}), flush=True)
        if label in ("condenser_float32", "hetero_row_float32"):
            timed[label] = (k3, k4, dims)
        torch.cuda.empty_cache()
    real_build = _cuda.build_kernels
    for label, lib, usage in built:
        use(lib, "")
        entry = {"variant": label, "ptxas": usage}
        for case_label, (k3, k4, dims) in timed.items():
            entry[case_label] = {"k3_ms": cs.cuda_ms(torch, k3), "k4_ms": cs.cuda_ms(torch, k4),
                                 "blocks_per_sm": occupancy(lib, dims, False)}
        out["variants"].append(entry)
        print(json.dumps(entry), flush=True)
    _cuda.build_kernels = real_build
    _cuda.library.cache_clear()
    tmp.cleanup()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

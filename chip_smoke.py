"""Smoke test of the PyTorch port on one NVIDIA GPU.

Drives ``pyrayt_tpu_torch`` on the card in phases; every phase passes or
raises, and any failure exits non-zero:

1. build   — compile the CUDA kernels from ``pyrayt_tpu_torch/csrc``;
1b. device times — every kernel at the main path's shapes (float32,
             2**20 rays; ``kernel_device_times``): its device time under
             ``torch.profiler`` (``kernel_times``), back-to-back calls
             between two CUDA events, one call between two events and the
             wrapper's host time until it returns.  It runs before
             anything else: late in this script (after the training
             phases) profiler sessions recorded no device activity;
2. compare — the kernel against its plain PyTorch version on the
             condenser (cone source at 10 deg, BK7 thick lens, baffle;
             2**20 rays, 6 generations), at float64 and float32;
3. main    — ``RayTracer(...).trace()`` on the condenser at float32 with
             the default dispatch; the kernel's launch count must rise,
             and the frame must match the plain engine's in shape;
4. tutorial — the convex-collimator tutorial through the kernel: exactly
             150 rows, generation-2 rays collimated at x = 1;
5. times   — kernel and plain version on the condenser, CUDA events;
6. gradients — the backward kernels against autograd of the plain forward
             (``fused_trace_plain``) at the bench's gradient configuration
             (condenser, 2**20 rays, 6 generations, fixed loop, remat):
             (a) ``RmsSpotRadius`` through the loss-fused K3 Function at
             float64 and float32, and two K3 launches bit-identical;
             (b) a loss over masked records and final positions through
             the generic K4 Function; (c) the achromatic-doublet objective
             of examples/lens_design.py (SoftFocusError, 8 generations,
             ~2**20 rays) with respect to theta through the differentiable
             rebuild, K3 against the plain engine, float64;
7. training — the main path of this slice: ``build_objective`` and 60
             Adam steps of ``optimize`` on the singlet of
             tests/test_analysis/test_optimize.py at 2**20 rays, float32,
             through K1 + K3; then 5 steps with a generic loss through
             K1 + K4; the step's breakdown (``rebuild_ms``, ``value_ms``,
             ``value_and_grad_ms``, ms per step, host clock) and the traced
             rebuild on the card against the CPU's at float64 (params and
             theta-gradient within REBUILD_RTOL) with its aten ops, forward
             and backward, within REBUILD_OPS_PER_LEAF per leaf plus
             REBUILD_OPS_BASE (``rebuild_check``);
8. backward times — K3, K4 and their plain versions on the condenser and
             on the 31-leaf hetero row (10 elements of the lens wall, 4
             material slots, 2**20 rays on an unsorted line across them, 5
             generations) at float32, CUDA events, beside each kernel's
             bound; two K3 and two K4 launches bit-identical on both; the
             backward's registers, stack frame and spills from ptxas;
9. wide compare — the wide kernel K2 against its plain version on the
             16x16 microlens array of examples/microlens_array.py (513
             leaves, 2**20 rays, 4 generations) and on the 20-element
             heterogeneous lens wall (61 leaves, 2**20 rays), float64 and
             float32: masks, records, final state, fold5 and win;
10. wide main — ``RayTracer(...).trace()`` on the 16x16 array at float32
             through K2, with the example's detector statistics;
11. wide gradients — the staged backward (K2 with save_fold, then K5, K6,
             K7) against autograd of the plain engine on every 64th ray of
             the 16x16 array's grid (16,384 rays; the plain engine's
             (trees, rays) arrays are 256 times a ray row): RmsSpotRadius
             through K5's loss mode, the example's lenslet blur through its
             generic mode, float64 and float32, two launches bit-identical,
             and d blur / d r through ``build_objective``; the plain engine
             held to the kernels' rule at an exact tie between two trees
             (all to the first tree; it splits), its tied rays counted
             (``tree_ties``);
12. wide training — ``optimize`` of the shared lenslet radius from 2.3
             (30 steps) and of 64 radii plus the detector plane (30 steps,
             seed 3) on the 8x8 array at 2**18 rays, then 3 shared-radius
             steps on the 16x16 array at 2**20 rays, float32; each
             objective's step breakdown as in phase 7, and ``rebuild_check``
             on the 8x8 (shared; 64 radii and the detector) and the 16x16
             (shared; 256 radii);
13. wide staged kernels and times — K5, K6 and K7 each against its
             plain version, launch by launch, on the inputs the staged
             backward gives them over a K2 trace of the 16x16 array at
             2**20 rays (RmsSpotRadius through K5's loss mode, the lenslet
             blur's record cotangent through its generic mode), float64
             and float32, each output at its own scale; then K2 with and
             without save_fold (and at float64), K5, K6 and K7
             per generation and per step, and their plain versions, CUDA
             events, beside each kernel's bound; the group trees a ray
             evaluates per generation after the chunk skip of the union
             boxes and after K2's two-level cull on the tight boxes, and
             the cull's box tests (``cull_counts``), K2's operations bound
             from the second beside the bound from the first;
14. wide fused gradients — the main path of this slice, the monolithic
             wide backward K8 (``TraceConfig(wide_grad="fused")``): (a) K8
             against its plain version on the reverse chain of one K2 trace
             of the 8x8 array (129 leaves) and of the 16x16 array (513
             leaves, past the JAX package's 300-leaf cap on its K8), each at
             2**20 rays and 4 generations with bench.py:1245-1306's ray grid,
             RmsSpotRadius through K8's loss mode and the lenslet blur through
             its generic mode, float64 and float32, each output at its own
             scale, two launches bit-identical; (b) at float64 K8 against the
             staged backward on the same trace; (c) both 8x8 training
             witnesses of phase 12 through K2 + K8, K8's launches up and the
             staged kernels' none; (d) K8, its plain version and the staged
             backward per step, CUDA events, beside K8's bound (from the
             tree-level count, the chunk-level bound beside it);
15. row reduce — the table reduce that K6, K7 and K8 end with
             (``row_reduce``, csrc/row_reduce.cuh) alone against its plain
             version, float64 and float32, two launches bit-identical, on
             the tables of one K6 launch of a staged step (the one with the
             most nonzero values) and of one K8 call on the 16x16 array at
             2**20 rays (and bit for bit the sums those kernels returned),
             and on synthetic keys (every key -1, one row, 4096 rows, a
             detector-like skew, one entry, a ragged length); its
             time by CUDA events beside its bytes bound, its plain version
             and an ``index_add_`` yardstick the port never calls;
16. render and aberrations — the spherical and chromatic aberration
             curves and the coma metric of the achromatic doublet
             (``analysis.aberrations``, through ``RayTracer.trace()`` and
             K1) on the card at float64 and float32 against the same
             analyses on the CPU at float64 (float64 within RTOL64), and the
             edge and Gooch-shaded renderers (``render``, one nearest-hit
             pass of the plain engine over about 0.5 million pixel rays) on
             the card against the CPU's float64 images;
17. parallel — ``pyrayt_tpu_torch.parallel`` in worlds of rank processes
             (this script with ``--rank``) that build nothing: (a) a 2-rank
             gloo world on the one card (NCCL takes one device per rank),
             ``sharded_trace`` of the condenser through K1 per rank, f32
             and f64, gathered, equal bit for bit to one K1 launch over
             every ray; (b) ``build_train_step`` with
             ``metrics.rms_spot_radius`` through K1 + K4 per rank, f64 and
             f32, its summed gradient against the one-process step's
             (this process, no group) within REL64 / REL32 and two steps
             bit-identical; (c) the 16x16 array at full width: the sharded
             K2 trace against one K2 launch, one step through K2 + K5/K6/K7
             and one through K2 + K8 against the one-process steps, f32;
             (d) the tree axis: ``build_wide_sharded_trace_fn`` on the
             16x16 array (128 trees per rank, the plain engine, f64, at
             2**16 random rays: the plain fold's (trees x rays) arrays),
             records bit-equal to and gradient within REL64 of the
             one-process plain engine (both split a tie between two trees;
             the tied rays counted), and
             ``build_surface_sharded_nearest_hit`` on a 32x32 sphere grid
             against the one-rank fold; (e) a 1-rank NCCL world
             (``initialize_distributed(backend="nccl")``): one condenser
             step bit-identical to the step without a group; (f) each
             rank's times (host clock, CUDA events): the sharded trace,
             the step, the gather, the gradient sum and the MIN fold,
             and K1's and K2's times on a rank's block (``kernel_times``:
             both ranks at once, then one at a time).  Every path runs
             with the launch counts at 0 in its rank and reads them
             after; its kernels must launch, no other kernel and no plain
             path may.

The times of phases 5, 8 and 13-15 are one call between two CUDA events
(the wrapper's host work before its launch inside).  A kernel's own time
is its device time, phase 1b's; the kernels line gives it as ``ms``, with
that phase's ``event_ms`` and ``host_ms`` beside it.

Phases 1-8 keep their depth; phases 9-14 run the 16x16 array at full width
(2**20 rays) except where a phase says otherwise; phase 17 (d) cuts the
rays of the tree axis to 2**16.

Run from the repository root: ``python3 chip_smoke.py``.  It needs one
CUDA device and ``nvcc``; the kernels build into ``build/torch_kernels``.
The last line of standard output is the JSON status line.
"""

from __future__ import annotations

import json
import os
import shutil
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

N_RAYS = 1 << 20
GENERATIONS = 6
# float64: masks agree on at least this share of rays, and records of the
# rays whose masks agree within RTOL64 / ATOL64 (the kernel contracts
# multiply-adds into FMAs, eager PyTorch does not)
MASK_SHARE64 = 0.99999
RTOL64 = ATOL64 = 1e-9
# float32: at most this share of rays may differ above ATOL32 in any
# masked record value (the bound the TPU build used for kernel vs engine)
DIFF_SHARE32 = 0.001
ATOL32 = 1e-4
# gradients: max |kernel - plain| <= REL64 * max |plain| + ABS64 at float64
# (FMA contraction and a million-term sum in another order; a wrong adjoint
# misses by far more), <= REL32 * max |plain| at float32
REL64, ABS64 = 1e-7, 1e-12
REL32 = 1e-3
# published H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, float32 FLOP/s
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12
# floating-point operations per (ray, generation it ran), counted from the
# CUDA sources (an FMA counts 2, a compare or select 0): every leaf's
# world-to-object transform (33) and intersector, then the hit leaf's
# normal (50), refraction with its Sellmeier index (75), record, tilt and
# push-off (15); the backward adds the hit leaf's re-intersection and
# endpoint derivative (100), the adjoints of the normal (110), refraction
# and Sellmeier (150), tilt and record (40), and the sums of the hit leaf's
# 18 and the glass row's 7 parameter cotangents (25 adds: the function's
# work, whatever order a kernel sums them in)
LOCAL_RAY = 33
INTERSECT = {0: 26, 1: 30, 2: 12, 3: 14, 4: 28}  # sphere, paraboloid, plane, cube, cylinder
INTERACT = 140
ADJOINT = 400
PARAM_SUMS = 18 + 7


# examples/microlens_array.py: a 16x16 array of plano-convex lenslets (mm)
MLA_N = 16
MLA_PITCH = 1.0
MLA_R = 2.0
MLA_THICKNESS = 0.25
MLA_GENERATIONS = 4
MLA_SUBSET = 64  # phase 11 compares every 64th ray with the plain engine
TRAIN_N, TRAIN_RAYS, WIDE_TRAIN_STEPS, FULL_STEPS = 8, 1 << 18, 30, 3
# floating-point operations of the wide step, counted from the CUDA sources
# like those of the narrow kernels above: a chunk-box test (3 slabs), and
# per staged-backward ray a tail adjoint and a winning tree's re-evaluation
# with the adjoints of its normal and hit distance
BOX_TEST = 30
# K2's and K8's cull since the two-level redesign: a box test (per axis a
# subtraction and a multiply for each face) and, per ray and group, the
# reciprocals of v +- slope
CULL_TEST = 12
CULL_SETUP = 12
TAIL_ADJOINT = 250
TREE_ADJOINT = 250


def mla_system(comp, pyrayt, n, r=MLA_R):
    """microlens_array.build_system: the array and a detector fixed at the
    nominal focal plane."""
    lenslets = comp.microlens_array(r, MLA_THICKNESS, n, n, MLA_PITCH)
    focus = pyrayt.lensmakers_equation(MLA_R, float("inf"), 1.5, MLA_THICKNESS)
    detector = comp.baffle((2.0 * n * MLA_PITCH, 2.0 * n * MLA_PITCH)).move_x(focus)
    return lenslets + [detector], detector, focus


def hetero_wall(comp, matl, n_elements=20, seed=0, pitch=2.6):
    """tests/test_ops/test_fused_wide_hetero.py: 20 distinct biconvex
    elements along y, three glasses, and a detector (61 leaves)."""
    import numpy as np

    glasses = [matl.glass["BK7"], matl.glass["SF5"], matl.glass["SF2"]]
    rng = np.random.default_rng(seed)
    elements = []
    for i in range(n_elements):
        r1 = 3.0 + 4.0 * rng.random()
        r2 = -(3.0 + 4.0 * rng.random())
        y = (i - (n_elements - 1) / 2.0) * pitch
        elements.append(comp.thick_lens(r1, r2, 0.3 + 0.2 * rng.random(),
                                        aperture=1.5 + rng.random(),
                                        material=glasses[i % 3]).move_y(y))
    span = n_elements * pitch
    return elements + [comp.baffle((span, span)).move_x(6.0)]


HETERO_ROW = 10  # elements of the hetero row: 31 leaves, the narrow limit's side
HETERO_ROW_GENERATIONS = 5
HETERO_ROW_HALF = 12.35  # half-width of its line of rays (0.95 of the row)


def hetero_row_rays(interop, device, dtype, n, seed=5):
    """tests/test_torch/torch_parity_scenes.py's "hetero_row" rays: +X
    rays from x = -1.5 on an unsorted line across the row (neighbouring
    rays land on any element), positions jittered by 1e-4, wavelengths
    uniform over 0.45-0.65."""
    import numpy as np

    rng = np.random.default_rng(seed)
    pos = np.zeros((4, n))
    pos[:3] = np.array([-1.5, 0.0, 0.0])[:, None] + rng.normal(0.0, 1e-4, (3, n))
    pos[3] = 1.0
    pos[1] += rng.uniform(-HETERO_ROW_HALF, HETERO_ROW_HALF, n)
    dirs = np.zeros((4, n))
    dirs[0] = 1.0
    meta = np.stack((np.zeros(n), np.full(n, 100.0), rng.uniform(0.45, 0.65, n), np.ones(n),
                     np.arange(n, dtype=float)))
    return interop.rays_from_numpy(pos, dirs, meta, device=device, dtype=dtype)


def narrow_bwd_bytes(records, masks, run, n_leaves, n_glass, item):
    """(K3 bytes, K4 bytes, ray-generations run, skip checks): what this
    run's data makes the narrow backward read and write.  Per generation a
    ray ran: 15 record rows (K4 also 15 d_records rows); per generation a
    ray did not run whose mask before it is set: 3 tilt rows (to see the
    skip); masks[0..G-2] (K3 also the last mask of the rays that ran the
    last generation); 11 state0 rows (K4 also 11 d_fstate rows; the w rows
    are constants); 13 d_state0 rows written; the scene's tables read and
    their cotangents written."""
    g, n = masks.shape
    ran = int(run.sum())
    skip_checks = int((masks[:-1] & ~run[1:]).sum())
    table_bytes = item * (22 * n_leaves + 7 * n_glass) * 2
    k3 = (item * (15 * ran + 3 * skip_checks + 11 * n + 13 * n) + (g - 1) * n
          + int(run[-1].sum()) + table_bytes)
    k4 = k3 - int(run[-1].sum()) + item * (15 * ran + 11 * n)
    return k3, k4, ran, skip_checks


def ptxas_usage(log, kernel):
    """{entry: "registers, stack, spills"} of the entry functions named
    ``kernel`` in an ``nvcc -Xptxas -v`` log."""
    usage, entry = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1] if kernel in line else None
        elif entry and ("registers" in line or "stack frame" in line):
            usage[entry] = (usage.get(entry, "") + " " + line.replace("ptxas info    :", "")
                            .strip()).strip()
    return usage


def lenslet_offsets(torch, y, z, n):
    """Distance of (y, z) to the nearest lenslet center of an n x n array
    (for even n the centers sit at half-pitch offsets)."""
    off = 0.0 if n % 2 else MLA_PITCH / 2.0
    dy = y - (MLA_PITCH * torch.round((y - off) / MLA_PITCH) + off)
    dz = z - (MLA_PITCH * torch.round((z - off) / MLA_PITCH) + off)
    return dy, dz


def lenslet_blur_loss(torch, metrics, det_id, n):
    """microlens_array.lenslet_blur: mean squared distance of detector hits
    to their own lenslet's center (no descriptor: the generic backward)."""

    def lenslet_blur(res):
        m = metrics.surface_mask(res, det_id)
        dy, dz = lenslet_offsets(torch, res.records[:, metrics.COL["y1"], :],
                                 res.records[:, metrics.COL["z1"], :], n)
        return metrics.masked_mean(dy ** 2 + dz ** 2, m)

    return lenslet_blur


def wide_compare(torch, ft, fg, spec, config, inputs, dtype):
    """K2 against its plain version on the same inputs (save_fold)."""
    k = ft.fused_trace_wide(spec, config, *inputs, save_fold=True)
    p = ft.fused_trace_wide_plain(spec, config, *inputs, save_fold=True)
    torch.cuda.synchronize()
    k_rec, k_mask, k_fin, k_fold, k_win = k
    p_rec, p_mask, p_fin, p_fold, p_win = p
    ran = fg.generations_ran(p_rec, p_mask)
    agree = (k_mask == p_mask).all(dim=0) & (k_win == p_win).all(dim=0)
    live = (k_mask & agree[None]).unsqueeze(1)
    diff = torch.where(live, (k_rec - p_rec).abs(), 0.0)
    if dtype == torch.float64:
        tol = RTOL64 * p_rec.abs() + ATOL64
    else:
        tol = torch.full_like(p_rec, ATOL32)
    rec_ok = torch.where(live, diff <= tol, True).all(dim=0).all(dim=0) & agree
    both_inf = torch.isinf(k_fold) & torch.isinf(p_fold)
    fold_diff = torch.where(both_inf | ~(ran & agree[None]).unsqueeze(1), 0.0,
                            (k_fold - p_fold).abs())
    fin_diff = torch.where(agree[None], (k_fin - p_fin).abs(), 0.0)
    win_equal = (k_win == p_win) | ~ran
    return {
        "dtype": str(dtype).replace("torch.", ""),
        "rays": k_mask.shape[1],
        "ray_generations_run": int(ran.sum()),
        "mask_agree_share": float((k_mask == p_mask).all(dim=0).float().mean()),
        "win_equal_share": float(win_equal[ran].float().mean()),
        "share_outside_tolerance": float(1.0 - rec_ok.float().mean()),
        "first_rays_outside": (~rec_ok).nonzero().squeeze(1)[:8].tolist(),
        "max_abs_err": float(diff.max()),
        "fold5_max_abs_err": float(fold_diff.max()),
        "final_state_max_abs_err": float(fin_diff.max()),
        "records_finite": bool(torch.isfinite(torch.where(live, k_rec, 0.0)).all()),
        "tree_hits": int((k_win >= 0).sum()),
    }


# row blocks of the wide backward kernels' per-ray outputs that share a
# unit (a vector's rows are held at the vector's scale): buf = [p3, v3,
# d_best_d, d_best_n], dcarry = the carried rows' cotangents, dpv = [d_p3,
# d_v3], d_state0 = the initial state's 13 rows
RAY_BLOCKS = {"buf": ((0, 3), (3, 6), (6, 7), (7, 10)),
              "dcarry": ((0, 3), (3, 6), (6, 7), (7, 8), (8, 9), (9, 10), (10, 11)),
              "dpv": ((0, 3), (3, 6)),
              "d_state0": ((0, 3), (3, 4), (4, 7), (7, 8), (8, 9), (9, 10), (10, 11),
                           (11, 12), (12, 13))}


def hold(torch, stats, kernel, names, k_out, p_out, dtype):
    """Hold each output of ``kernel`` against the reference's at its own
    scale (max |reference|; for a per-ray output, of each block of
    RAY_BLOCKS), accumulating into ``stats``: max |kernel - reference|, the
    values of the summed outputs outside the bound, and the largest share
    of rays with a value outside it in one call."""
    for output, k, p in zip(names, k_out, p_out):
        k, p = k.double(), p.double()
        diff = (k - p).abs()
        blocks = RAY_BLOCKS.get(output)
        if blocks:
            scale = torch.cat([p[a:b].abs().max().expand(b - a) for a, b in blocks])[:, None]
        else:
            scale = p.abs().max()
        bound = REL64 * scale + ABS64 if dtype == torch.float64 else REL32 * scale
        outside = diff > bound
        s = stats.setdefault(f"{kernel}.{output}", {
            "max_abs_err": 0.0, "max_abs_plain": 0.0, "per_ray": bool(blocks),
            "values_outside": 0, "share_outside": 0.0, "first_rays_outside": [],
            "rows_outside": [], "finite": True})
        s["max_abs_err"] = max(s["max_abs_err"], float(diff.max()))
        s["max_abs_plain"] = max(s["max_abs_plain"], float(p.abs().max()))
        s["finite"] = s["finite"] and bool(torch.isfinite(k).all())
        if blocks:
            rays = outside.any(dim=0).nonzero().squeeze(1)
            s["share_outside"] = max(s["share_outside"], rays.numel() / k.shape[-1])
            s["first_rays_outside"] = (s["first_rays_outside"] + rays[:4].tolist())[:8]
            s["rows_outside"] = sorted(set(s["rows_outside"]) | set(
                outside.any(dim=1).nonzero().squeeze(1).tolist()))
        else:
            s["values_outside"] += int(outside.sum())


def assert_held(stats, dtype, torch, tag):
    """Every output of ``stats`` (``hold``) finite and inside its bound."""
    share = 1.0 - MASK_SHARE64 if dtype == torch.float64 else DIFF_SHARE32
    for key, s in stats.items():
        assert s["finite"], (tag, key, s)
        assert s["share_outside"] <= share if s["per_ray"] else s["values_outside"] == 0, \
            (tag, key, s)


def staged_kernel_compare(torch, ft, fg, spec, config, inputs, trace, modes, dtype):
    """K5, K6 and K7 each held against its plain version, launch by launch,
    on the inputs the staged backward (ops/fused_grad.py:staged_bwd) gives
    them: the reverse chain over one K2 trace (``trace`` = records, masks,
    fold5, win), carried on by the kernels' outputs.  ``modes`` maps a label
    to K5's record cotangent: ``(keyword arguments of generation g, initial
    carried cotangent)``.  Returns ``hold``'s statistics per kernel
    output."""
    state0, obj_tx, prim, glass, slots = inputs[:5]
    records, masks, fold5, win = trace
    plan_entries = ft.wide_fold_plan(spec)
    groups = [idx for kind, idx, _ in plan_entries if kind == "group"]
    has_singles = any(kind == "single" for kind, _, _ in plan_entries)
    ran_any = fg.generations_ran(records, masks).any(dim=1).tolist()
    stats = {}
    tail_names, fold_names = ("buf", "dcarry", "d_glass"), ("d_objtx", "d_prim", "dpv")
    for label, (kw_of, carry) in modes.items():
        for g in reversed(range(len(ran_any))):
            if not ran_any[g]:
                continue
            tail_args = (spec, config, state0, records[g], masks[g], masks[g - 1] if g else None,
                         fold5[g], glass, carry)
            k5 = fg.staged_tail(*tail_args, **kw_of(g))
            hold(torch, stats, "staged_tail", tail_names, k5,
                 fg.staged_tail_plain(*tail_args, **kw_of(g)), dtype)
            buf, dcarry, _ = k5
            dpv = dcarry[0:6]
            for gi in groups:
                k6 = fg.staged_group(spec, gi, buf, win[g], obj_tx, prim, slots)
                hold(torch, stats, "staged_group", fold_names, k6,
                     fg.staged_group_plain(spec, gi, buf, win[g], obj_tx, prim, slots), dtype)
                dpv = dpv + k6[2]
            if has_singles:
                k7 = fg.staged_singles(spec, buf, win[g], obj_tx, prim, slots)
                hold(torch, stats, "staged_singles", fold_names, k7,
                     fg.staged_singles_plain(spec, buf, win[g], obj_tx, prim), dtype)
                dpv = dpv + k7[2]
            carry = torch.cat((dpv, dcarry[6:11]))
    return stats


def cull_counts(torch, ft, spec, inputs, records, masks, fg, stride):
    """The group trees a ray evaluates per generation it ran, counted with
    torch ops on every ``stride``-th ray of this run's trace: ``chunk``,
    after the chunk skip on the JAX-equal union boxes (the TPU's scan,
    ops/fused_trace.py:_box_hit on every chunk, then every tree of the
    chunks it enters); ``tree``, after the two-level cull of K2 and K8 on
    the tight boxes (``cull_hit_plain``: the chunks whose box the ray
    enters, then the trees whose box it enters); ``box_tests``, the box
    tests that cull runs (every chunk's, then every tree's of the chunks it
    enters).  The kernels' prune of boxes entered past the best hit can
    only lower ``tree`` and ``box_tests``: they count without it."""
    state0, aabb, cull = inputs[0], inputs[5], inputs[6]
    ran = fg.generations_ran(records, masks)[:, ::stride]
    offsets = ft.cull_offsets(spec)[0]
    total = {"chunk": 0, "tree": 0, "box_tests": 0}
    count = 0
    for g in range(records.shape[0]):
        if g == 0:
            p, v = state0[0:3, ::stride], state0[4:7, ::stride]
        else:
            p, v = records[g, 6:9, ::stride], records[g, 12:15, ::stride]
        sel = ran[g]
        p, v = p[:, sel], v[:, sel]
        count += int(sel.sum())
        for gi, (kind, _, info) in enumerate(
                [e for e in ft.wide_fold_plan(spec) if e[0] == "group"]):
            t_count, nc, off = info["T"], info["n_chunks"], offsets[gi]
            slope = cull[off, :3]
            trees = ft.cull_hit_plain(cull[off + 1 + nc:off + 1 + nc + t_count], slope, p, v)
            if nc == 0:
                total["chunk"] += t_count * p.shape[1]
                total["box_tests"] += t_count * p.shape[1]
                total["tree"] += int(trees.sum())
                continue
            chunks = ft.cull_hit_plain(cull[off + 1:off + 1 + nc], slope, p, v)
            total["box_tests"] += nc * p.shape[1]
            for c in range(nc):
                t0 = c * ft.WIDE_CHUNK_TREES
                t1 = min(t0 + ft.WIDE_CHUNK_TREES, t_count)
                hit = ft._box_hit(aabb[info["chunk_off"] + c], p, v)
                total["chunk"] += (t1 - t0) * int(hit.sum())
                total["box_tests"] += (t1 - t0) * int(chunks[c].sum())
                total["tree"] += int((trees[t0:t1] & chunks[c]).sum())
    return {k: v / max(count, 1) for k, v in total.items()}


def train_witnesses(torch, np, pyrayt, comp, metrics, fresh_ids, build_objective, optimize,
                    device, train_config, reset, launches, label, compile_scene=None):
    """The 8x8 array's training witnesses at 2**18 rays, float32 (the
    example's two ``--optimize`` runs): the shared lenslet radius from 2.3
    (30 steps), then 64 radii plus the detector plane (30 steps, seed 3),
    under ``train_config``.  Each run's launch counts are zeroed just before
    it and read just after.  Returns the final radius, the per-lenslet mean
    |r - nominal| before and after, the host ms per step and the counts;
    given ``compile_scene``, also each objective's ``step_breakdown`` at its
    starting theta."""
    span8 = TRAIN_N * MLA_PITCH * 0.95
    rays8 = comp.GridOfRays(span8, span8).move_x(-1.0).generate_rays(
        TRAIN_RAYS, device=device, dtype=torch.float32)
    rays8 = rays8.replace(id=torch.arange(TRAIN_RAYS, dtype=torch.float32, device=device))
    with fresh_ids():
        det8 = float(mla_system(comp, pyrayt, TRAIN_N)[1].get_id())
    blur8 = lenslet_blur_loss(torch, metrics, det8, TRAIN_N)
    r_start = MLA_R * 1.15
    objective = build_objective(lambda th: mla_system(comp, pyrayt, TRAIN_N, th["r"])[0], rays8,
                                blur8, train_config)
    out = {"launches": {}}
    reset()
    start = time.perf_counter()
    theta, history = optimize(objective, {"r": torch.tensor(r_start, device=device)},
                              steps=WIDE_TRAIN_STEPS, learning_rate=2e-2)
    torch.cuda.synchronize()
    out["shared_ms_per_step"] = (time.perf_counter() - start) / WIDE_TRAIN_STEPS * 1e3
    out["launches"]["shared"] = launches()
    out["r"] = float(theta["r"])
    if compile_scene is not None:
        out["shared_breakdown"] = step_breakdown(
            torch, compile_scene, fresh_ids,
            lambda th: mla_system(comp, pyrayt, TRAIN_N, th["r"])[0], objective,
            {"r": torch.tensor(r_start, device=device, requires_grad=True)}, device, 5)
    log(f"wide training ({label}), shared radius ({TRAIN_N}x{TRAIN_N}, {TRAIN_RAYS} rays, "
        f"{WIDE_TRAIN_STEPS} steps): r {r_start:.3f} -> {out['r']:.4f} mm (nominal {MLA_R}); "
        f"blur {history[0]:.5f} -> {min(history):.5f} mm^2; {out['shared_ms_per_step']:.1f} "
        f"ms/step (host clock); launches {json.dumps(out['launches']['shared'])}")

    rng = np.random.default_rng(3)
    radii0 = MLA_R * (1.0 + 0.15 * rng.standard_normal(TRAIN_N * TRAIN_N))
    focus8 = pyrayt.lensmakers_equation(MLA_R, float("inf"), 1.5, MLA_THICKNESS)

    def build_free(th):
        return build_free8(comp, th)

    theta0 = {"radii": torch.tensor(radii0, dtype=torch.float32, device=device),
              "det_x": torch.tensor(focus8 * 1.05, dtype=torch.float32, device=device)}
    with fresh_ids():
        det_free = float(build_free(theta0)[-1].get_id())
    objective = build_objective(build_free, rays8, lenslet_blur_loss(torch, metrics, det_free,
                                                                     TRAIN_N), train_config)
    reset()
    start = time.perf_counter()
    theta, history = optimize(objective, theta0, steps=WIDE_TRAIN_STEPS, learning_rate=2e-2)
    torch.cuda.synchronize()
    out["free_ms_per_step"] = (time.perf_counter() - start) / WIDE_TRAIN_STEPS * 1e3
    out["launches"]["per_lenslet"] = launches()
    if compile_scene is not None:
        out["free_breakdown"] = step_breakdown(
            torch, compile_scene, fresh_ids, lambda th: build_free(th), objective,
            {k: v.clone().requires_grad_(True) for k, v in theta0.items()}, device, 5)
    out["err0"] = float(np.abs(radii0 - MLA_R).mean())
    out["err1"] = float((theta["radii"].double() - MLA_R).abs().mean())
    log(f"wide training ({label}), per lenslet ({TRAIN_N}x{TRAIN_N}, {TRAIN_RAYS} rays, "
        f"{WIDE_TRAIN_STEPS} steps, {TRAIN_N * TRAIN_N + 1} params, seed 3): blur "
        f"{history[0]:.5f} -> {min(history):.5f} mm^2; mean |r - nominal| {out['err0']:.4f} -> "
        f"{out['err1']:.4f} mm; detector x {focus8 * 1.05:.3f} -> {float(theta['det_x']):.3f} "
        f"(nominal {focus8:.3f}); {out['free_ms_per_step']:.1f} ms/step (host clock); launches "
        f"{json.dumps(out['launches']['per_lenslet'])}")
    return out


# the traced rebuild's size: at most this many non-view aten ops per leaf
# plus a constant, in its forward and in its backward (test_torch_rebuild.py)
REBUILD_OPS_PER_LEAF, REBUILD_OPS_BASE = 4, 200
# the card's traced rebuild against the CPU's, both float64: params and the
# theta-gradient within this share of their largest magnitude
REBUILD_RTOL = 1e-12


def aten_counter():
    """A ``TorchDispatchMode`` that counts the non-view aten ops dispatched
    inside it (``.ops``)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class AtenCount(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if not func.is_view:
                self.ops += 1
            return func(*args, **(kwargs or {}))

    return AtenCount()


def rebuild_check(torch, np, compile_scene, fresh_ids, build, theta0, device, label):
    """The traced rebuild ``build(theta)`` on the card against the same on
    the CPU, both float64: the params, and the gradient of a seeded random
    projection of ``world`` and ``prim`` with respect to theta, within
    REBUILD_RTOL of their largest magnitude; on the card the aten ops of the
    rebuild and of its backward within REBUILD_OPS_PER_LEAF per leaf plus
    REBUILD_OPS_BASE.  Returns the report (it asserts)."""
    rng = np.random.default_rng(17)
    cotangents, runs = None, {}
    for where, dev in (("card", device), ("cpu", torch.device("cpu"))):
        theta = {k: torch.tensor(np.asarray(v, dtype=float), dtype=torch.float64, device=dev,
                                 requires_grad=True) for k, v in theta0.items()}
        forward, backward = aten_counter(), aten_counter()
        with forward, fresh_ids():
            scene = compile_scene(build(theta), device=dev, dtype=torch.float64)
        if cotangents is None:
            cotangents = [rng.standard_normal(tuple(scene.params[k].shape))
                          for k in ("world", "prim")]
        with backward:
            grads = torch.autograd.grad(
                [scene.params["world"], scene.params["prim"]], list(theta.values()),
                [torch.as_tensor(c, device=dev) for c in cotangents])
        if dev.type == "cuda":
            torch.cuda.synchronize()
        runs[where] = {"params": {k: scene.params[k].detach().cpu() for k in ("world", "prim")},
                       "grads": {k: g.cpu() for k, g in zip(theta, grads)},
                       "ops": forward.ops, "backward_ops": backward.ops,
                       "leaves": scene.spec.n_leaves}

    def rel(a, b):
        return float((a - b).abs().max() / b.abs().max().clamp_min(1e-300))

    card, cpu = runs["card"], runs["cpu"]
    bound = REBUILD_OPS_PER_LEAF * card["leaves"] + REBUILD_OPS_BASE
    report = {"leaves": card["leaves"], "ops_bound": bound,
              "ops": {"card": card["ops"], "cpu": cpu["ops"]},
              "backward_ops": {"card": card["backward_ops"], "cpu": cpu["backward_ops"]},
              "params_rel_err": {k: rel(card["params"][k], cpu["params"][k])
                                 for k in card["params"]},
              "grad_rel_err": {k: rel(card["grads"][k], cpu["grads"][k]) for k in card["grads"]}}
    log(f"traced rebuild {label}, card against CPU, float64:", json.dumps(report))
    assert all(e <= REBUILD_RTOL for e in report["params_rel_err"].values()), report
    assert all(e <= REBUILD_RTOL for e in report["grad_rel_err"].values()), report
    assert all(float(g.abs().max()) > 0 for g in card["grads"].values()), report
    assert card["ops"] <= bound and card["backward_ops"] <= bound, report
    return report


def step_breakdown(torch, compile_scene, fresh_ids, build, objective, theta, device, repeats=10):
    """Host-clock ms (synchronized) of the float32 rebuild alone, the
    objective's value, and its value and gradient, at ``theta`` (tensors
    that require grad)."""

    def rebuild():
        with fresh_ids():
            compile_scene(build(theta), device=device, dtype=torch.float32)

    def value_and_grad():
        return torch.autograd.grad(objective(theta), list(theta.values()))

    return {"rebuild_ms": host_ms(torch, rebuild, repeats),
            "value_ms": host_ms(torch, lambda: objective(theta), repeats),
            "value_and_grad_ms": host_ms(torch, value_and_grad, repeats)}


class tree_ties:
    """Inside it, the plain engine's tree-axis reduce (``engine.
    _reduce_tree_axis``) records the rays whose nearest distance two or
    more trees of a wide group share (``count()``: over every call, which
    see the same rays each generation); with ``first_tree`` it also gives
    such a tie's whole distance cotangent to the first tree, the rule of
    the wide kernels and their plain versions (the plain engine splits it,
    as the JAX engine does)."""

    def __init__(self, torch, engine, first_tree=False):
        self.torch, self.engine, self.first_tree = torch, engine, first_tree
        self.tied = []

    def __enter__(self):
        torch, original = self.torch, self.engine._reduce_tree_axis
        self.original = original

        def reduce(dist, leaf):
            d = dist.detach()
            dmin = d.amin(dim=0)
            self.tied.append(((d == dmin).sum(dim=0) > 1) & torch.isfinite(dmin))
            if not self.first_tree:
                return original(dist, leaf)
            win = torch.argmin(dist, dim=0)
            dmin = torch.gather(dist, 0, win[None])[0]
            lmin = torch.gather(leaf, 0, win[None])[0]
            return dmin, torch.where(torch.isinf(dmin), -1, lmin).to(torch.int32)

        self.engine._reduce_tree_axis = reduce
        return self

    def __exit__(self, *exc):
        self.engine._reduce_tree_axis = self.original

    def count(self):
        if not self.tied:
            return 0
        return int(self.torch.stack(self.tied).any(dim=0).sum())


def build_free8(comp, th):
    """The 8x8 training witness's scene: 64 lenslet radii and the detector
    plane free."""
    lenslets = comp.microlens_array(th["radii"], MLA_THICKNESS, TRAIN_N, TRAIN_N, MLA_PITCH)
    size = 2.0 * TRAIN_N * MLA_PITCH
    return lenslets + [comp.baffle((size, size)).move_x(th["det_x"])]


def fold_ops(torch, ft, fg, spec, inputs, records, masks):
    """``(counts, ops, chunk_ops)``: :func:`cull_counts` on every 16th ray,
    and the wide fold's operations per ray and generation run: the single
    trees' leaves, the winner's INTERACT, and either the two-level cull's
    box tests and the leaves of the trees whose tight boxes the ray enters
    (``ops``, the work these inputs need of K2 and K8) or, as counted before
    the cull, every chunk's box test and the leaves of every tree of the
    chunks it enters (``chunk_ops``)."""
    counts = cull_counts(torch, ft, spec, inputs, records, masks, fg, 16)
    group_info = [info for kind, _, info in ft.wide_fold_plan(spec) if kind == "group"][0]
    tree_ops = sum(LOCAL_RAY + INTERSECT[t] for t in group_info["types_pos"])
    single_ops = sum(LOCAL_RAY + INTERSECT[spec.leaf_types[s]]
                     for kind, _, info in ft.wide_fold_plan(spec) if kind == "single"
                     for s in info["slots"])
    base = single_ops + INTERACT
    ops = base + CULL_SETUP + CULL_TEST * counts["box_tests"] + counts["tree"] * tree_ops
    chunk_ops = base + BOX_TEST * group_info["n_chunks"] + counts["chunk"] * tree_ops
    return counts, ops, chunk_ops


def log(*parts):
    print(*parts, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True,
        text=True,
        timeout=60,
        check=True,
    )
    return out.stdout.strip().splitlines()[0]


def condenser(comp, matl):
    lens = comp.thick_lens(1.0, -1.0, 0.25, aperture=0.5, material=matl.glass["BK7"])
    detector = comp.baffle((1.0, 1.0)).move_x(1.0)
    source = comp.ConeOfRays(cone_angle=10.0).move_x(-0.5)
    return source, [lens, detector]


# examples/lens_design.py: a 50 mm f/2.4 BK7/SF2 achromatic doublet (mm)
LENS_DIAMETER = 25.4
DOUBLET_FOCUS = 50.0
L1_THICKNESS, L2_THICKNESS = 8.0, 2.0
DOUBLET_RADII = 174763  # rays per wavelength: 6 x 174763 ~ 2**20
TRAIN_STEPS = 60
GENERIC_STEPS = 5


def doublet_radii_initial(matl):
    """lens_design.doublet_radii_initial: power split by Abbe number."""
    import numpy as np

    crown, flint = matl.glass["BK7"], matl.glass["SF2"]
    p_sys = 1 / DOUBLET_FOCUS
    v1, v2 = crown.abbe(), flint.abbe()
    p1, p2 = p_sys * v1 / (v1 - v2), p_sys * v2 / (v2 - v1)
    n1, n2 = float(crown.index_at(0.633)), float(flint.index_at(0.633))
    r1 = (n1 - 1) * (1 + np.sqrt(1 - p1 * L1_THICKNESS / n1)) / p1
    r4 = 1.0 / (1.0 / -r1 - p2 / (n2 - 1))
    return np.array([r1, -r1, -r1, r4])


def build_doublet(comp, matl, radii):
    """lens_design.build_doublet: signs static (+, -, -, -), magnitudes free."""
    l1 = comp.thick_lens(radii[0], radii[1], L1_THICKNESS, aperture=LENS_DIAMETER,
                         material=matl.glass["BK7"], r1_sign=1, r2_sign=-1)
    l2 = comp.thick_lens(radii[2], radii[3], L2_THICKNESS, aperture=LENS_DIAMETER,
                         material=matl.glass["SF2"], r1_sign=-1, r2_sign=-1,
                         ).move_x(1.01 * (L1_THICKNESS + L2_THICKNESS) / 2)
    imager = comp.baffle((LENS_DIAMETER, LENS_DIAMETER)).move_x(DOUBLET_FOCUS)
    return [l1, l2, imager]


def design_rays(comp, torch, device, dtype, n_radii,
                wavelengths=(0.45, 0.5, 0.55, 0.6, 0.65, 0.7)):
    """lens_design.design_rays: lines of rays across the aperture, one per
    wavelength, with ids 0..n-1."""
    from pyrayt_tpu_torch.tracer.rayset import concatenate

    sets = [
        comp.LineOfRays(0.45 * LENS_DIAMETER / 2, wavelength=wl).move_x(-10.0)
        .move_y(LENS_DIAMETER / 8).generate_rays(n_radii, device=device, dtype=dtype)
        for wl in wavelengths
    ]
    rays = concatenate(sets)
    return rays.replace(id=torch.arange(rays.n_rays, dtype=dtype, device=device))


def build_singlet(theta, comp, matl):
    """tests/test_analysis/test_optimize.py: a biconvex singlet with traced
    radius and a detector at x = 2."""
    lens = comp.thick_lens(r1=theta["r1"], r2=-theta["r1"], thickness=0.1, aperture=0.8,
                           material=matl.glass["ideal"], r1_sign=1, r2_sign=-1)
    return [lens, comp.baffle((3.0, 3.0)).move_x(2.0)]


def compare(torch, ft, spec, config, inputs, dtype):
    """Kernel vs plain on the same inputs: agreement shares and errors."""
    k_rec, k_mask, k_fin = ft.fused_trace(spec, config, *inputs)
    p_rec, p_mask, p_fin = ft.fused_trace_plain(spec, config, *inputs)
    torch.cuda.synchronize()
    n = k_mask.shape[1]
    agree = (k_mask == p_mask).all(dim=0)  # (n,) rays whose masks agree
    live = (k_mask & agree[None]).unsqueeze(1)  # (G, 1, n) rows to compare
    diff = torch.where(live, (k_rec - p_rec).abs(), 0.0)
    if dtype == torch.float64:
        tol = RTOL64 * p_rec.abs() + ATOL64
    else:
        tol = torch.full_like(p_rec, ATOL32)
    rec_ok = torch.where(live, diff <= tol, True).all(dim=0).all(dim=0) & agree
    fin_diff = torch.where(agree[None], (k_fin - p_fin).abs(), 0.0)
    return {
        "dtype": str(dtype).replace("torch.", ""),
        "rays": n,
        "mask_agree_share": float(agree.float().mean()),
        "record_tolerance": RTOL64 if dtype == torch.float64 else ATOL32,
        "share_outside_tolerance": float(1.0 - rec_ok.float().mean()),
        "max_abs_err": float(diff.max()),
        "final_state_max_abs_err": float(fin_diff.max()),
        "records_finite": bool(torch.isfinite(torch.where(live, k_rec, 0.0)).all()),
    }


def grad_compare(torch, kernel, plain, dtype):
    """Per name: max |kernel - plain|, max |plain|, their ratio, within bound."""
    out = {}
    for name, k in kernel.items():
        p = plain[name]
        scale = float(p.abs().max())
        err = float((k.double() - p.double()).abs().max())
        bound = REL64 * scale + ABS64 if dtype == torch.float64 else REL32 * scale
        out[name] = {"max_abs_err": err, "max_abs_plain": scale,
                     "ratio": err / scale if scale else 0.0, "within": err <= bound,
                     "finite": bool(torch.isfinite(k).all())}
    return out


def assert_within(report):
    for name, r in report.items():
        assert r["within"] and r["finite"], (name, r)


def flops_per_ray_generation(spec, backward: bool) -> int:
    forward = sum(LOCAL_RAY + INTERSECT[t] for t in spec.leaf_types) + INTERACT
    if not backward:
        return forward
    return forward + ADJOINT + PARAM_SUMS


def bound(bytes_moved, flops):
    """(bound ms, "bytes" or "operations") at the published H100 peaks."""
    t_bytes = bytes_moved / PEAK_BYTES * 1e3
    t_ops = flops / PEAK_F32 * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


PROFILED_STEPS = 5
# the table reduce's kernels (csrc/row_reduce.cuh), as the profiler names them
REDUCE_KERNELS = ("sort_segments", "scan_rows", "plan_rows", "sum_pieces", "finish_rows")
# each kernel's device functions, as the profiler names them: the kernel
# and the reduce of its per-block partials or of its table
K1_NAMES = ("fused_trace_kernel",)
K2_NAMES = ("fused_trace_wide_kernel",)
K34_NAMES = ("fused_bwd_kernel", "reduce_partials")
K5_NAMES = ("staged_tail_kernel", "reduce_partials")
K67_NAMES = ("staged_fold_kernel",) + REDUCE_KERNELS
K8_NAMES = ("wide_fused_bwd_kernel", "reduce_partials") + REDUCE_KERNELS
# the O(rows x keys) scan the reduce replaced, as PERF.md records it (NVIDIA
# H100 80GB HBM3, 700 W): reduce_rows' device time in one K8 call on the
# 16x16 array (the profiler's trace of the last commit with the scan), and
# one K6 launch with winners, its scan included (CUDA events)
OLD_SCAN_MS = {"k8_call": 8.12, "k6_launch": 1.51}
# float64 FLOP/s outside the tensor cores (NVIDIA H100 SXM data sheet)
PEAK_F64 = 34e12


def host_ms(torch, fn, repeats=10):
    """Host-clock ms per call, synchronized, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = time.perf_counter()
    for _ in range(repeats):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - start) / repeats * 1e3


def device_us(event):
    """Self device time (us) of a profiler key average, across versions."""
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(event, attr):
            return getattr(event, attr)
    return 0.0


def cuda_ms(torch, fn, repeats=10, warmup=2):
    """Median ms of one call between two CUDA events recorded on an idle
    device: the wrapper's host work before its first launch falls inside."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def wrapper_host_ms(torch, fn, repeats=10):
    """Median host ms from a call to its return, each call after a
    synchronize (what the device waits for before the call's first
    launch)."""
    times = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        start = time.perf_counter()
        fn()
        times.append((time.perf_counter() - start) * 1e3)
    torch.cuda.synchronize()
    return statistics.median(times)


def burst_ms(torch, fn, repeats=20):
    """ms per call of ``repeats`` calls back to back between one pair of
    events, the inputs made ahead: the host enqueues while the device runs,
    so its time hides wherever a call's device time exceeds it."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(repeats):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / repeats


def device_ms(torch, fn, names, calls=PROFILED_STEPS):
    """Device time of one call of ``fn`` under ``torch.profiler`` (CPU and
    CUDA activities, ``calls`` calls after a warm-up, then a synchronize).
    Per kernel name: its self device time over the launches the profiler
    recorded, times its launches per call (the recorded launches over the
    calls, rounded: the profiler can miss the first call's early launches).
    Returns ``(ms, by_kernel)``: ``ms`` sums the kernels whose names hold
    one of ``names`` (the kernel under test, its reduce included);
    ``by_kernel`` maps every kernel the call launched to its ms per call.
    Raises where the profiler recorded none of ``names``: late in a long
    process (this script after its training phases) sessions were seen to
    record no device activity at all, so ``kernel_device_times`` runs
    first."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    by_kernel = {}
    for e in prof.key_averages():
        us = device_us(e)
        if e.device_type == torch.autograd.DeviceType.CUDA and us > 0:
            by_kernel[e.key] = us / e.count / 1e3 * max(1, round(e.count / calls))
    ms = sum(v for k, v in by_kernel.items() if any(name in k for name in names))
    if ms <= 0:
        raise RuntimeError(f"torch.profiler recorded none of {names} on this card (device "
                           f"kernels seen: {sorted(by_kernel)})")
    return ms, {short_kernel_name(k): v for k, v in by_kernel.items()}


def short_kernel_name(key):
    """A profiler kernel key without its return type and arguments."""
    key = key.replace("(anonymous namespace)::", "").replace("pyrayt::", "")
    return key.removeprefix("void ").split("(", 1)[0][:72]


def kernel_times(torch, fn, names, repeats=10):
    """A kernel's times per call on the card: ``device_ms`` (the profiler's,
    the figure PERF.md reports), ``burst_ms`` (back-to-back calls between
    one pair of events), ``event_ms`` (one call between two events, host
    work included, as ``cuda_ms`` times the phases) and ``host_ms``
    (the wrapper's host time until it returns), and the profiler's device
    ms by kernel."""
    event = cuda_ms(torch, fn, repeats=repeats)
    device, by_kernel = device_ms(torch, fn, names)
    return {"device_ms": device, "burst_ms": burst_ms(torch, fn, 2 * repeats),
            "event_ms": event, "host_ms": wrapper_host_ms(torch, fn, repeats),
            "device_by_kernel": by_kernel}


def kernel_device_times(torch, pyrayt, comp, matl, metrics, TraceConfig, fg, ft, fresh_ids,
                        compile_scene, device):
    """Every kernel's ``kernel_times`` at the main path's shapes, float32,
    2**20 rays: K1 on the condenser (phase 5's trace), K3 (RmsSpotRadius)
    and K4 (seeded cotangents) on the condenser (phase 8), K2 on the 16x16
    array (phase 13's grid), K5 (loss mode, zero carried cotangent), K6 and
    K7 per generation of a K2 trace with save_fold, summed over a staged
    step, and the step (``staged_bwd``) itself, K8 in loss mode on the
    16x16 array with the bench's grid (phase 14) and the table reduce alone
    on the table that K8 call fills (phase 15).  Keyed by wrapper name;
    a staged kernel's entry holds each generation's ``device_by_kernel``."""
    one = torch.ones((), device=device)
    f32 = torch.float32
    times = {}
    with fresh_ids():
        source, parts = condenser(comp, matl)
        scene = compile_scene(parts, device=device, dtype=f32)
        rays = source.generate_rays(N_RAYS, device=device, dtype=f32)
    spec = scene.spec
    inputs = ft.kernel_inputs(scene.params, rays)
    config = TraceConfig(generation_limit=GENERATIONS)
    times["fused_trace"] = kernel_times(torch, lambda: ft.fused_trace(spec, config, *inputs),
                                        K1_NAMES)
    grad_config = TraceConfig(generation_limit=GENERATIONS, fixed_loop=True, remat=True)
    records, masks, _ = ft.fused_trace(spec, grad_config, *inputs)
    plan = fg.loss_plan(metrics.RmsSpotRadius(float(spec.leaf_ids[-1])))
    scal = plan.row(plan.scalars(records, masks), one)
    gen = torch.Generator(device=device).manual_seed(0)
    d_records = torch.randn(records.shape, generator=gen, device=device) * masks[:, None]
    d_fstate = torch.randn(inputs[0].shape, generator=gen, device=device)
    bwd = (spec, grad_config, *inputs, records, masks)
    times["fused_bwd_loss"] = kernel_times(torch, lambda: fg.fused_bwd_loss(*bwd, scal, plan),
                                           K34_NAMES)
    times["fused_bwd"] = kernel_times(torch, lambda: fg.fused_bwd(*bwd, d_records, d_fstate),
                                      K34_NAMES)
    del scene, rays, inputs, records, masks, d_records, d_fstate

    wide_config = TraceConfig(generation_limit=MLA_GENERATIONS, fixed_loop=True)
    for span in (MLA_N * MLA_PITCH * 0.95, MLA_N * MLA_PITCH * 1.05):
        with fresh_ids():
            system, detector, _ = mla_system(comp, pyrayt, MLA_N)
            scene = compile_scene(system, device=device, dtype=f32)
        spec = scene.spec
        rays = comp.GridOfRays(span, span).move_x(-1.0).generate_rays(N_RAYS, device=device,
                                                                      dtype=f32)
        inputs = ft.wide_kernel_inputs(spec, scene.params, rays)
        records, masks, _, fold5, win = ft.fused_trace_wide(spec, wide_config, *inputs,
                                                            save_fold=True)
        plan = fg.loss_plan(metrics.RmsSpotRadius(float(detector.get_id())))
        scal = plan.row(plan.scalars(records, masks), one)
        if span > MLA_N * MLA_PITCH:  # the bench's grid: K8 and its table's reduce
            k8_args = (spec, wide_config, *inputs, records, masks)
            times["fused_bwd_wide"] = kernel_times(
                torch, lambda: fg.fused_bwd_wide(*k8_args, scal=scal, plan=plan), K8_NAMES)
            tables, make_table = [], fg._reduce_table

            def keep(*args):
                tables.append(make_table(*args))
                return tables[-1]

            fg._reduce_table = keep
            try:
                fg.fused_bwd_wide(*k8_args, scal=scal, plan=plan)
            finally:
                fg._reduce_table = make_table
            keys, vals = tables[-1][0].reshape(-1), tables[-1][1].reshape(-1, 18)
            slots = torch.arange(spec.n_leaves, dtype=torch.int32, device=device)
            times["row_reduce"] = kernel_times(torch, lambda: fg.row_reduce(
                keys, vals, slots, spec.n_leaves, spec.n_leaves), REDUCE_KERNELS)
            continue
        state0, obj_tx, prim, glass, slots = inputs[:5]
        times["fused_trace_wide"] = kernel_times(
            torch, lambda: ft.fused_trace_wide(spec, wide_config, *inputs), K2_NAMES)
        ran = fg.generations_ran(records, masks)
        carry = torch.zeros((11, N_RAYS), dtype=f32, device=device)
        per_gen = {"staged_tail": [], "staged_group": [], "staged_singles": []}
        for g in range(MLA_GENERATIONS):
            if not bool(ran[g].any()):
                break
            tail_args = (spec, wide_config, state0, records[g], masks[g],
                         masks[g - 1] if g else None, fold5[g], glass, carry)
            per_gen["staged_tail"].append(kernel_times(
                torch, lambda: fg.staged_tail(*tail_args, scal=scal, plan=plan), K5_NAMES))
            buf, _, _ = fg.staged_tail(*tail_args, scal=scal, plan=plan)
            per_gen["staged_group"].append(kernel_times(
                torch, lambda: fg.staged_group(spec, 0, buf, win[g], obj_tx, prim, slots),
                K67_NAMES))
            per_gen["staged_singles"].append(kernel_times(
                torch, lambda: fg.staged_singles(spec, buf, win[g], obj_tx, prim, slots),
                K67_NAMES))
        for name, entries in per_gen.items():
            times[name] = {key: sum(t[key] for t in entries)
                           for key in ("device_ms", "burst_ms", "event_ms", "host_ms")}
            times[name].update(launches_per_step=len(entries),
                               device_by_kernel=[t["device_by_kernel"] for t in entries])
        times["staged_bwd"] = kernel_times(
            torch, lambda: fg.staged_bwd(spec, wide_config, state0, obj_tx, prim, glass, slots,
                                         records, masks, fold5, win, scal=scal, plan=plan),
            K5_NAMES + K67_NAMES)
        del buf
    del scene, rays, inputs, records, masks, fold5, win
    torch.cuda.empty_cache()
    return times


def subset_rays(torch, RaySet, rays, stride):
    """Every ``stride``-th ray of ``rays``, ids renumbered 0..k-1."""
    sub = RaySet(**{f: getattr(rays, f)[..., ::stride].contiguous()
                    for f in ("positions", "directions") + RaySet.fields})
    return sub.replace(id=torch.arange(sub.n_rays, dtype=sub.dtype, device=sub.device))


def wide_phases(torch, np, pyrayt, comp, matl, metrics, ft, fg, engine, TraceConfig, fresh_ids,
                compile_scene, build_objective, optimize, device, phase_seconds):
    """Phases 9-13 (module docstring); returns this slice's entries of the
    kernels line."""
    from pyrayt_tpu_torch.tracer.rayset import RaySet

    counters = {"fused_trace_wide": ft.fused_trace_wide, "staged_tail": fg.staged_tail,
                "staged_group": fg.staged_group, "staged_singles": fg.staged_singles}

    def reset():
        for c in counters.values():
            c.launches = 0
        ft.fused_trace.launches = fg.fused_bwd.launches = fg.fused_bwd_loss.launches = 0

    def launches():
        return {name: c.launches for name, c in counters.items()}

    span = MLA_N * MLA_PITCH * 0.95
    grid = comp.GridOfRays(span, span).move_x(-1.0)

    # 9. K2 against its plain version --------------------------------------
    phase_start = time.perf_counter()
    config = TraceConfig(generation_limit=MLA_GENERATIONS)
    compares = {}
    sources = (
        ("mla16", lambda: mla_system(comp, pyrayt, MLA_N)[0], grid),
        ("hetero", lambda: hetero_wall(comp, matl),
         comp.GridOfRays(20 * 2.6 * 0.95, 1.0).move_x(-1.5)),
    )
    for label, build, source in sources:
        for dtype in (torch.float64, torch.float32):
            with fresh_ids():
                scene = compile_scene(build(), device=device, dtype=dtype)
            rays = source.generate_rays(N_RAYS, device=device, dtype=dtype)
            inputs = ft.wide_kernel_inputs(scene.spec, scene.params, rays)
            res = wide_compare(torch, ft, fg, scene.spec, config, inputs, dtype)
            res["leaves"] = scene.spec.n_leaves
            compares[f"{label}_{res['dtype']}"] = res
            log(f"wide compare {label}:", json.dumps(res))
            del scene, rays, inputs
            torch.cuda.empty_cache()
    for label, _, _ in sources:
        r64, r32 = compares[f"{label}_float64"], compares[f"{label}_float32"]
        assert r64["mask_agree_share"] >= MASK_SHARE64, r64
        assert r64["win_equal_share"] >= MASK_SHARE64, r64
        assert r64["share_outside_tolerance"] <= 1.0 - MASK_SHARE64, r64
        assert r32["share_outside_tolerance"] <= DIFF_SHARE32, r32
        assert 1.0 - r32["win_equal_share"] <= DIFF_SHARE32, r32
        assert r64["records_finite"] and r32["records_finite"] and r64["tree_hits"] > 0, label
    phase_seconds["wide_compare"] = time.perf_counter() - phase_start

    # 10. the main path: RayTracer.trace() through K2 ------------------------
    phase_start = time.perf_counter()
    with fresh_ids():
        system, detector, focus = mla_system(comp, pyrayt, MLA_N)
    tracer = pyrayt.RayTracer(grid, system, rays_per_source=N_RAYS,
                              generation_limit=MLA_GENERATIONS, device=device, dtype=torch.float32)
    reset()
    start = time.perf_counter()
    frame = tracer.trace()
    main_s = time.perf_counter() - start
    trace_launches = launches()
    assert trace_launches["fused_trace_wide"] > 0, trace_launches
    assert ft.fused_trace.launches == 0
    hits = frame[frame.surface == detector.get_id()]
    y1 = torch.as_tensor(hits["y1"].to_numpy())
    z1 = torch.as_tensor(hits["z1"].to_numpy())
    dy, dz = lenslet_offsets(torch, y1, z1, MLA_N)
    median = float(torch.hypot(dy, dz).median()) if len(hits) else float("nan")
    log(f"wide main: {MLA_N}x{MLA_N} lenslets ({2 * MLA_N * MLA_N + 1} leaves), {N_RAYS} rays; "
        f"focal plane x = {focus:.3f} mm; detector hits: {len(hits)} / {N_RAYS}; median "
        f"|hit - lenslet center|: {median:.4f} mm (cell half-pitch {MLA_PITCH / 2:.2f}); "
        f"RayTracer.trace() {main_s:.3f} s (host clock, first call), {len(frame)} rows; "
        f"launches {json.dumps(trace_launches)}")
    assert np.isfinite(frame.to_numpy()).all(), "non-finite values in the frame"
    assert len(hits) > N_RAYS // 2 and median < MLA_PITCH / 4, (len(hits), median)
    del frame, hits
    phase_seconds["wide_main"] = time.perf_counter() - phase_start

    # 11. gradients against autograd of the plain engine, on a ray subset ----
    phase_start = time.perf_counter()
    grad_config = TraceConfig(generation_limit=MLA_GENERATIONS, fixed_loop=True)
    det_id = float(detector.get_id())
    rms = metrics.RmsSpotRadius(det_id)
    blur = lenslet_blur_loss(torch, metrics, det_id, MLA_N)
    names = ("world", "prim", "glass")
    grad_reports = {}

    def param_grads(scene, value_of):
        params = {k: v.detach().clone().requires_grad_(True) for k, v in scene.params.items()}
        value = value_of(params)
        grads = torch.autograd.grad(value, [params[k] for k in names])
        return float(value.detach()), dict(zip(names, grads))

    for dtype in (torch.float64, torch.float32):
        tag = str(dtype).replace("torch.", "")
        with fresh_ids():
            scene = compile_scene(mla_system(comp, pyrayt, MLA_N)[0], device=device, dtype=dtype)
        rays = subset_rays(torch, RaySet, grid.generate_rays(N_RAYS, device=device, dtype=dtype),
                           MLA_SUBSET)
        spec, materials = scene.spec, scene.materials
        plain_fn = engine.build_trace_fn(spec, materials, grad_config)
        value_fn = fg.build_fused_value_and_grad_fn(spec, materials, grad_config, rms)
        trace_fn = fg.build_fused_vjp_trace_fn(spec, materials, grad_config)
        for loss_name, kernel_value, plain_value in (
            ("rms_loss_mode", lambda p: value_fn(p, rays), lambda p: rms(plain_fn(p, rays))),
            ("blur_generic", lambda p: blur(trace_fn(p, rays)), lambda p: blur(plain_fn(p, rays))),
        ):
            before = launches()
            k_value, k_grads = param_grads(scene, kernel_value)
            ran = {k: launches()[k] - before[k] for k in before}
            assert all(ran.values()), (loss_name, ran)
            # the kernels give an exact tie between two trees to the first
            # one: the plain engine is held to that rule here, its tied rays
            # counted
            with tree_ties(torch, engine, first_tree=True) as ties:
                p_value, p_grads = param_grads(scene, plain_value)
            report = grad_compare(torch, k_grads, p_grads, dtype)
            grad_reports[f"{loss_name}_{tag}"] = report
            log(f"wide gradient {loss_name} {tag} ({rays.n_rays} rays, {ties.count()} of them "
                f"tied between two trees): value {k_value!r} vs plain {p_value!r}; launches "
                f"{json.dumps(ran)}; " + json.dumps(report))
            assert_within(report)
            _, again = param_grads(scene, kernel_value)
            identical = all(torch.equal(again[k], k_grads[k]) for k in names)
            log(f"wide gradient {loss_name} {tag}: two launches bit-identical: {identical}")
            assert identical, loss_name
        del scene, rays
        torch.cuda.empty_cache()

    # d blur / d r of the shared radius through build_objective, float64
    rays = subset_rays(torch, RaySet, grid.generate_rays(N_RAYS, device=device,
                                                         dtype=torch.float64), MLA_SUBSET)
    r_grads = {}
    for label, use_fused in (("kernels", None), ("plain", False)):
        objective = build_objective(
            lambda r: mla_system(comp, pyrayt, MLA_N, r)[0], rays, blur,
            TraceConfig(generation_limit=MLA_GENERATIONS, fixed_loop=True, use_fused=use_fused))
        r = torch.tensor(MLA_R, dtype=torch.float64, device=device, requires_grad=True)
        before = launches()
        with tree_ties(torch, engine, first_tree=True) as ties:
            value = objective(r)
            (r_grads[label],) = torch.autograd.grad(value, r)
        ran = {k: launches()[k] - before[k] for k in before}
        if use_fused is False:
            r_ties = ties.count()
        assert all(ran.values()) if use_fused is None else not any(ran.values()), (label, ran)
        log(f"wide d blur / d r ({label}): blur {float(value.detach())!r} mm^2, "
            f"d/dr {float(r_grads[label])!r}; launches {json.dumps(ran)}")
    report = grad_compare(torch, {"r": r_grads["kernels"]}, {"r": r_grads["plain"]}, torch.float64)
    grad_reports["d_blur_d_r_float64"] = report
    log(f"wide d blur / d r, kernels against plain ({r_ties} rays tied between two trees): "
        + json.dumps(report))
    assert_within(report)
    del rays
    torch.cuda.empty_cache()
    phase_seconds["wide_gradients"] = time.perf_counter() - phase_start

    # 12. training -------------------------------------------------------------
    phase_start = time.perf_counter()
    train_config = TraceConfig(generation_limit=MLA_GENERATIONS, fixed_loop=True)
    witness = train_witnesses(torch, np, pyrayt, comp, metrics, fresh_ids, build_objective,
                              optimize, device, train_config, reset, launches, "staged",
                              compile_scene=compile_scene)
    for key in ("shared", "free"):
        log(f"wide training step breakdown ({TRAIN_N}x{TRAIN_N}, {key}, float32, {TRAIN_RAYS} "
            f"rays; ms per step {witness[key + '_ms_per_step']:.2f}):",
            json.dumps(witness[key + "_breakdown"]))
    for n, label, theta0 in (
            (TRAIN_N, "shared radius", {"r": MLA_R * 1.15}),
            (TRAIN_N, f"{TRAIN_N * TRAIN_N} radii and the detector",
             {"radii": MLA_R * (1.0 + 0.15 * np.random.default_rng(3).standard_normal(
                 TRAIN_N * TRAIN_N)), "det_x": 4.2}),
            (MLA_N, "shared radius", {"r": MLA_R * 1.15}),
            (MLA_N, f"{MLA_N * MLA_N} radii",
             {"r": MLA_R * (1.0 + 0.15 * np.random.default_rng(4).standard_normal(MLA_N**2))})):
        build = ((lambda th: build_free8(comp, th)) if "det_x" in theta0
                 else (lambda th, n=n: mla_system(comp, pyrayt, n, th["r"])[0]))
        rebuild_check(torch, np, compile_scene, fresh_ids, build, theta0, device,
                      f"{n}x{n} {label}")
    assert abs(witness["r"] - MLA_R) <= 0.1, witness
    assert witness["err1"] < 0.12 and witness["err1"] < witness["err0"], witness
    assert all(witness["launches"]["shared"].values()), witness
    r_start = MLA_R * 1.15
    torch.cuda.empty_cache()

    # full width: the 16x16 array at 2**20 rays
    rays16 = grid.generate_rays(N_RAYS, device=device, dtype=torch.float32)
    rays16 = rays16.replace(id=torch.arange(N_RAYS, dtype=torch.float32, device=device))
    objective = build_objective(lambda th: mla_system(comp, pyrayt, MLA_N, th["r"])[0], rays16,
                                blur, train_config)
    objective({"r": torch.tensor(r_start, device=device)})  # warm-up
    torch.cuda.synchronize()
    reset()
    start = time.perf_counter()
    _, history = optimize(objective, {"r": torch.tensor(r_start, device=device)},
                          steps=FULL_STEPS, learning_rate=2e-2)
    torch.cuda.synchronize()
    full_step_ms = (time.perf_counter() - start) / FULL_STEPS * 1e3
    train_launches = launches()
    full_breakdown = step_breakdown(
        torch, compile_scene, fresh_ids, lambda th: mla_system(comp, pyrayt, MLA_N, th["r"])[0],
        objective, {"r": torch.tensor(r_start, device=device, requires_grad=True)}, device, 3)
    log(f"wide training at full width ({MLA_N}x{MLA_N}, {N_RAYS} rays, {FULL_STEPS} steps): "
        f"{full_step_ms:.1f} ms/step (host clock), rebuild {full_breakdown['rebuild_ms']:.1f} ms; "
        f"launches per step "
        f"{json.dumps({k: v / FULL_STEPS for k, v in train_launches.items()})}; blur {history}")
    log(f"wide training step breakdown ({MLA_N}x{MLA_N}, shared, float32, {N_RAYS} rays; ms per "
        f"step {full_step_ms:.2f}):", json.dumps(full_breakdown))
    assert all(v >= FULL_STEPS for v in train_launches.values()), train_launches
    phase_seconds["wide_training"] = time.perf_counter() - phase_start

    # 13. K5, K6 and K7 one by one against their plain versions, then times --
    phase_start = time.perf_counter()
    saved = launches()

    def staged_compares(dtype, rays):
        with fresh_ids():
            scene = compile_scene(mla_system(comp, pyrayt, MLA_N)[0], device=device, dtype=dtype)
        inputs = ft.wide_kernel_inputs(scene.spec, scene.params, rays)
        records, masks, fstate, fold5, win = ft.fused_trace_wide(scene.spec, grad_config, *inputs,
                                                                 save_fold=True)
        plan = fg.loss_plan(rms)
        scal = plan.row(plan.scalars(records, masks), torch.ones((), device=device))
        # the lenslet blur's record cotangent, as autograd hands it to _WideTrace
        rec_var = records.detach().clone().requires_grad_(True)
        (d_records,) = torch.autograd.grad(blur(engine.TraceResult(
            rec_var, masks, ft.rays_from_state(fstate), masks.any(dim=1).sum())), rec_var)
        d_records = d_records.contiguous()
        zero = torch.zeros((11, rays.n_rays), dtype=dtype, device=device)
        modes = {"rms_loss_mode": (lambda g: {"scal": scal, "plan": plan}, zero),
                 "blur_generic": (lambda g: {"d_rec": d_records[g]}, zero)}
        return staged_kernel_compare(torch, ft, fg, scene.spec, grad_config, inputs,
                                     (records, masks, fold5, win), modes, dtype)

    staged_stats = {}
    for dtype in (torch.float64, torch.float32):
        tag = str(dtype).replace("torch.", "")
        rays = rays16 if dtype == torch.float32 else grid.generate_rays(N_RAYS, device=device,
                                                                         dtype=dtype)
        stats = staged_compares(dtype, rays)
        staged_stats[tag] = stats
        log(f"wide staged kernels against their plain versions ({MLA_N}x{MLA_N}, {N_RAYS} rays, "
            f"{tag}, RmsSpotRadius loss mode and lenslet blur generic mode): " + json.dumps(stats))
        assert_held(stats, dtype, torch, tag)
        del rays
        torch.cuda.empty_cache()
    phase_seconds["wide_staged_compare"] = time.perf_counter() - phase_start

    phase_start = time.perf_counter()
    with fresh_ids():
        scene = compile_scene(mla_system(comp, pyrayt, MLA_N)[0], device=device,
                              dtype=torch.float32)
    spec = scene.spec
    inputs = ft.wide_kernel_inputs(spec, scene.params, rays16)
    state0, obj_tx, prim, glass, slots = inputs[:5]
    k2_ms = cuda_ms(torch, lambda: ft.fused_trace_wide(spec, grad_config, *inputs))
    k2_fold_ms = cuda_ms(torch, lambda: ft.fused_trace_wide(spec, grad_config, *inputs,
                                                            save_fold=True))
    k2_plain_ms = cuda_ms(torch, lambda: ft.fused_trace_wide_plain(spec, grad_config, *inputs),
                          repeats=1, warmup=0)
    # float64 on the same grid
    with fresh_ids():
        scene64 = compile_scene(mla_system(comp, pyrayt, MLA_N)[0], device=device,
                                dtype=torch.float64)
    inputs64 = ft.wide_kernel_inputs(scene64.spec, scene64.params,
                                     grid.generate_rays(N_RAYS, device=device, dtype=torch.float64))
    k2_f64_ms = cuda_ms(torch, lambda: ft.fused_trace_wide(scene64.spec, grad_config, *inputs64))
    del scene64, inputs64
    records, masks, _, fold5, win = ft.fused_trace_wide(spec, grad_config, *inputs, save_fold=True)
    plan = fg.loss_plan(rms)
    scal = plan.row(plan.scalars(records, masks), torch.ones((), device=device))
    ran = fg.generations_ran(records, masks)
    n, g_count = N_RAYS, MLA_GENERATIONS
    carry = torch.zeros((11, n), dtype=torch.float32, device=device)
    group_info = [info for kind, _, info in ft.wide_fold_plan(spec) if kind == "group"][0]
    per_gen = []
    for g in range(g_count):
        if not bool(ran[g].any()):
            break
        pmask = masks[g - 1] if g else None
        tail_args = (spec, grad_config, state0, records[g], masks[g], pmask, fold5[g], glass, carry)
        k5 = cuda_ms(torch, lambda: fg.staged_tail(*tail_args, scal=scal, plan=plan))
        buf, _, _ = fg.staged_tail(*tail_args, scal=scal, plan=plan)
        k6 = cuda_ms(torch, lambda: fg.staged_group(spec, 0, buf, win[g], obj_tx, prim, slots))
        k7 = cuda_ms(torch, lambda: fg.staged_singles(spec, buf, win[g], obj_tx, prim, slots))
        codes = win[g]
        in_group = (codes >= group_info["code_base"]) & (codes < group_info["code_base"]
                                                           + group_info["T"])
        group_winners = int(in_group.sum())
        single_winners = int(((codes >= 0) & ~in_group).sum())
        entry = {"generation": g, "ran": int(ran[g].sum()), "k5_ms": k5, "k6_ms": k6, "k7_ms": k7,
                 "group_winners": group_winners, "single_winners": single_winners}
        entry["k5_plain_ms"] = cuda_ms(torch, lambda: fg.staged_tail_plain(
            *tail_args, scal=scal, plan=plan), repeats=1, warmup=0)
        entry["k6_plain_ms"] = cuda_ms(torch, lambda: fg.staged_group_plain(
            spec, 0, buf, win[g], obj_tx, prim, slots), repeats=1, warmup=0)
        entry["k7_plain_ms"] = cuda_ms(torch, lambda: fg.staged_singles_plain(
            spec, buf, win[g], obj_tx, prim), repeats=1, warmup=0)
        per_gen.append(entry)
    bwd_args = (spec, grad_config, state0, obj_tx, prim, glass, slots, records, masks, fold5, win)
    step_bwd_ms = cuda_ms(torch, lambda: fg.staged_bwd(*bwd_args, scal=scal, plan=plan))
    first = fg.staged_bwd(*bwd_args, scal=scal, plan=plan)
    second = fg.staged_bwd(*bwd_args, scal=scal, plan=plan)
    identical = all(torch.equal(a, b) for a, b in zip(first, second))
    assert identical, "two staged backward launches at full width differ"
    for k, v in saved.items():
        counters[k].launches = v
    counts, k2_ray_ops, k2_chunk_ray_ops = fold_ops(torch, ft, fg, spec, inputs, records, masks)
    item = 4
    ran_total = int(ran.sum())
    # K2: every generation's records (zeros where a ray stopped), masks,
    # state in and out, the scene tables; with save_fold fold5 and win
    tables = (item * (22 * spec.n_leaves + 7 * glass.shape[0] + 6 * inputs[6].shape[0])
              + 4 * slots.numel())
    k2_bytes = item * (15 * g_count * n + 2 * 13 * n) + g_count * n + tables
    k2_fold_bytes = k2_bytes + (item * 5 + 4) * g_count * n
    k2_ops = ran_total * k2_ray_ops
    k2_bound = bound(k2_bytes, k2_ops)
    k2_fold_bound = bound(k2_fold_bytes, k2_ops)
    # the bound as counted before the two-level cull (every tree of the
    # chunks a ray enters), for the before-and-after yardstick
    k2_chunk_bound = bound(k2_bytes, ran_total * k2_chunk_ray_ops)
    # K5 per step: per generation, 15 record and 5 fold rows of the rays
    # that ran, the masks, 11 carried rows in, 10 buf and 11 carried rows out
    # (state0's 11 rows at generation 0)
    k5_bytes = sum(item * (20 * e["ran"] + 32 * n) + 2 * n + (item * 11 * n if e["generation"] == 0
                                                               else 0) for e in per_gen)
    k5_ops = sum(e["ran"] for e in per_gen) * TAIL_ADJOINT
    # K6 / K7 per step: win and the 10 buf rows of the winners in, 6 dpv
    # rows out, and the winners' table rows
    k6_bytes = sum(4 * n + item * (10 * e["group_winners"] + 6 * n) for e in per_gen)
    k7_bytes = sum(4 * n + item * (10 * e["single_winners"] + 6 * n) for e in per_gen)
    k6_ops = sum(e["group_winners"] for e in per_gen) * TREE_ADJOINT
    k7_ops = sum(e["single_winners"] for e in per_gen) * TREE_ADJOINT
    step = {"k5_ms": sum(e["k5_ms"] for e in per_gen), "k6_ms": sum(e["k6_ms"] for e in per_gen),
            "k7_ms": sum(e["k7_ms"] for e in per_gen)}
    plain_step = {k: sum(e[f"{k}_plain_ms"] for e in per_gen) for k in ("k5", "k6", "k7")}
    bounds = {"k5": bound(k5_bytes, k5_ops), "k6": bound(k6_bytes, k6_ops),
              "k7": bound(k7_bytes, k7_ops)}
    card = card_line()
    log(f"wide times ({MLA_N}x{MLA_N}, {N_RAYS} rays x {g_count} generations, {ran_total} "
        f"ray-generations run, float32, median): K2 {k2_ms:.4f} ms (float64 "
        f"{k2_f64_ms:.4f}), with save_fold "
        f"{k2_fold_ms:.4f} ms, plain {k2_plain_ms:.2f} ms; group trees per ray and generation "
        f"(of {group_info['T']}): {counts['chunk']:.2f} after the chunk skip, {counts['tree']:.2f} "
        f"after the two-level cull, with {counts['box_tests']:.2f} box tests; staged backward per "
        f"step {step_bwd_ms:.4f} ms (K5 {step['k5_ms']:.4f}, K6 {step['k6_ms']:.4f}, K7 "
        f"{step['k7_ms']:.4f}); plain per step "
        f"{json.dumps(plain_step)}; on {card}")
    log("wide per generation: " + json.dumps(per_gen))
    def bound_entry(n_bytes, ops, bnd):
        return {"bytes": n_bytes, "ops": ops, "ms": bnd[0], "by": bnd[1]}

    log("wide bounds: " + json.dumps({
        "fused_trace_wide": bound_entry(k2_bytes, k2_ops, k2_bound),
        "fused_trace_wide_chunk_level": bound_entry(k2_bytes, ran_total * k2_chunk_ray_ops,
                                                    k2_chunk_bound),
        "fused_trace_wide_save_fold": bound_entry(k2_fold_bytes, k2_ops, k2_fold_bound),
        "staged_tail": bound_entry(k5_bytes, k5_ops, bounds["k5"]),
        "staged_group": bound_entry(k6_bytes, k6_ops, bounds["k6"]),
        "staged_singles": bound_entry(k7_bytes, k7_ops, bounds["k7"]),
    }))
    phase_seconds["wide_times"] = time.perf_counter() - phase_start

    def own_err(kernel):  # the kernel's own float32 error against its plain version
        return max(s["max_abs_err"] for key, s in staged_stats["float32"].items()
                   if key.startswith(kernel + "."))

    def entry(name, source, replaces, n_launches, err, ms, plain, bnd):
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": n_launches, "max_abs_err": err, "ms": ms, "plain_ms": plain,
                "bound_ms": bnd[0], "bound_by": bnd[1], "library_ms": None}

    grad_src = "pyrayt_tpu_torch/csrc/wide_grad.cu"
    return [
        entry("fused_trace_wide", "pyrayt_tpu_torch/csrc/wide_trace.cu",
              "pyrayt_tpu/ops/fused_trace.py:1104", trace_launches["fused_trace_wide"],
              compares["mla16_float32"]["max_abs_err"], k2_ms, k2_plain_ms, k2_bound),
        entry("staged_tail", grad_src, "pyrayt_tpu/ops/fused_grad.py:871",
              train_launches["staged_tail"], own_err("staged_tail"), step["k5_ms"],
              plain_step["k5"], bounds["k5"]),
        entry("staged_group", grad_src, "pyrayt_tpu/ops/fused_grad.py:759",
              train_launches["staged_group"], own_err("staged_group"), step["k6_ms"],
              plain_step["k6"],
              bounds["k6"]),
        entry("staged_singles", grad_src, "pyrayt_tpu/ops/fused_grad.py:971",
              train_launches["staged_singles"], own_err("staged_singles"), step["k7_ms"],
              plain_step["k7"],
              bounds["k7"]),
    ]


# the outputs of the wide backward, K8's and the staged chain's
BWD_NAMES = ("d_objtx", "d_prim", "d_glass", "d_state0")
# the 8x8 training witnesses the fused route must reproduce (the JAX
# example's docstring; the staged route reaches 2.0276 and 0.0657)
WITNESS_R, WITNESS_ERR, WITNESS_TOL = 2.028, 0.066, 0.01


def k8_bytes(spec, inputs, records, masks, ran, generic):
    """Bytes K8 must move on this run's data: 15 record rows per generation
    a ray ran, 3 tilt rows per skip check, masks[0..G-2] (the loss mode
    also the mask of each generation run), 11 state0 rows in and 13
    d_state0 rows out, the scene tables; the generic mode adds 15 d_records
    rows per generation run and 11 d_fstate rows."""
    state0, glass, slots, cull = inputs[0], inputs[3], inputs[4], inputs[6]
    item = state0.element_size()
    g_count, n = masks.shape
    ran_total = int(ran.sum())
    skip_checks = int((masks[:-1] & ~ran[1:]).sum())
    tables = (item * (22 * spec.n_leaves + 7 * glass.shape[0] + 6 * cull.shape[0])
              + 4 * slots.numel())
    loss = item * (15 * ran_total + 3 * skip_checks + 24 * n) + (g_count - 1) * n + ran_total + tables
    return loss - ran_total + item * (15 * ran_total + 11 * n) if generic else loss


def wide_fused_phase(torch, pyrayt, comp, metrics, ft, fg, engine, TraceConfig, fresh_ids,
                     compile_scene, build_objective, optimize, device, phase_seconds, np):
    """Phase 14 (module docstring); returns K8's entry of the kernels line."""
    config = TraceConfig(generation_limit=MLA_GENERATIONS, fixed_loop=True)
    phase_start = time.perf_counter()
    stats, times, bounds = {}, {}, {}
    for n_side in (TRAIN_N, MLA_N):
        span = n_side * MLA_PITCH * 1.05  # bench.py:1258
        grid = comp.GridOfRays(span, span).move_x(-1.0)
        for dtype in (torch.float64, torch.float32):
            tag = f"{n_side}x{n_side}_{str(dtype).replace('torch.', '')}"
            with fresh_ids():
                system, detector, _ = mla_system(comp, pyrayt, n_side)
                scene = compile_scene(system, device=device, dtype=dtype)
            det_id = float(detector.get_id())
            spec = scene.spec
            rays = grid.generate_rays(N_RAYS, device=device, dtype=dtype)
            inputs = ft.wide_kernel_inputs(spec, scene.params, rays)
            state0, obj_tx, prim, glass, slots = inputs[:5]
            records, masks, fstate, fold5, win = ft.fused_trace_wide(spec, config, *inputs,
                                                                     save_fold=True)
            plan = fg.loss_plan(metrics.RmsSpotRadius(det_id))
            scal = plan.row(plan.scalars(records, masks), torch.ones((), device=device))
            # the lenslet blur's record cotangent, as autograd hands it to the Function
            rec_var = records.detach().clone().requires_grad_(True)
            (d_records,) = torch.autograd.grad(lenslet_blur_loss(torch, metrics, det_id, n_side)(
                engine.TraceResult(rec_var, masks, ft.rays_from_state(fstate),
                                   masks.any(dim=1).sum())), rec_var)
            modes = {"rms_loss_mode": dict(scal=scal, plan=plan),
                     "blur_generic": dict(d_records=d_records.contiguous(),
                                          d_fstate=torch.zeros_like(fstate))}
            args = (spec, config, *inputs, records, masks)
            staged_args = (spec, config, state0, obj_tx, prim, glass, slots, records, masks,
                           fold5, win)
            held, identical = {}, True
            for kw in modes.values():
                k8 = fg.fused_bwd_wide(*args, **kw)
                again = fg.fused_bwd_wide(*args, **kw)
                identical = identical and all(torch.equal(a, b) for a, b in zip(k8, again))
                hold(torch, held, "fused_bwd_wide", BWD_NAMES, k8,
                     fg.fused_bwd_wide_plain(*args, **kw), dtype)
                if dtype == torch.float64:
                    hold(torch, held, "against_staged", BWD_NAMES, k8,
                         fg.staged_bwd(*staged_args, **kw), dtype)
            stats[tag] = held
            log(f"wide fused backward against its plain version{' and the staged backward' if dtype == torch.float64 else ''} "
                f"({tag}, {spec.n_leaves} leaves, {N_RAYS} rays, RmsSpotRadius loss mode and "
                f"lenslet blur generic mode): two launches bit-identical: {identical}; "
                + json.dumps(held))
            assert identical, tag
            assert_held(held, dtype, torch, tag)
            if dtype == torch.float32:
                t = {}
                for label, kw in modes.items():
                    t[f"k8_{label}_ms"] = cuda_ms(torch, lambda: fg.fused_bwd_wide(*args, **kw))
                    t[f"staged_{label}_ms"] = cuda_ms(
                        torch, lambda: fg.staged_bwd(*staged_args, **kw))
                    t[f"plain_{label}_ms"] = cuda_ms(
                        torch, lambda: fg.fused_bwd_wide_plain(*args, **kw), repeats=1, warmup=0)
                times[tag] = t
                ran = fg.generations_ran(records, masks)
                counts, ray_ops, chunk_ray_ops = fold_ops(torch, ft, fg, spec, inputs, records,
                                                          masks)
                winners = int((win >= 0).sum())
                bounds[tag] = {}
                for level, per_ray in (("", ray_ops), ("chunk_level_", chunk_ray_ops)):
                    ops = int(ran.sum()) * (per_ray + TAIL_ADJOINT) + winners * TREE_ADJOINT
                    for label, generic in (("rms_loss_mode", False), ("blur_generic", True)):
                        n_bytes = k8_bytes(spec, inputs, records, masks, ran, generic)
                        bnd = bound(n_bytes, ops)
                        bounds[tag][level + label] = {"bytes": n_bytes, "ops": ops, "ms": bnd[0],
                                                      "by": bnd[1]}
                log(f"wide fused times ({tag}, {int(ran.sum())} ray-generations run, {winners} "
                    f"with a hit, group trees per ray and generation {json.dumps(counts)}, "
                    "median): "
                    + json.dumps(t) + "; bounds " + json.dumps(bounds[tag]) + f" on {card_line()}")
            del scene, rays, inputs, records, masks, fstate, fold5, win, d_records, modes
            torch.cuda.empty_cache()
    phase_seconds["wide_fused_compare_and_times"] = time.perf_counter() - phase_start

    # the main path of this slice: training through K2 + K8
    phase_start = time.perf_counter()
    counters = {"fused_trace_wide": ft.fused_trace_wide, "fused_bwd_wide": fg.fused_bwd_wide,
                "staged_tail": fg.staged_tail, "staged_group": fg.staged_group,
                "staged_singles": fg.staged_singles}

    def reset():
        for c in counters.values():
            c.launches = 0

    def launches():
        return {name: c.launches for name, c in counters.items()}

    witness = train_witnesses(
        torch, np, pyrayt, comp, metrics, fresh_ids, build_objective, optimize, device,
        TraceConfig(generation_limit=MLA_GENERATIONS, fixed_loop=True, wide_grad="fused"),
        reset, launches, "fused")
    runs = witness["launches"]
    main_launches = {k: runs["shared"][k] + runs["per_lenslet"][k] for k in counters}
    log("wide fused training: " + json.dumps({k: v for k, v in witness.items()}))
    assert main_launches["fused_trace_wide"] >= 2 * WIDE_TRAIN_STEPS, main_launches
    assert main_launches["fused_bwd_wide"] >= 2 * WIDE_TRAIN_STEPS, main_launches
    assert not any(main_launches[k] for k in ("staged_tail", "staged_group", "staged_singles")), \
        main_launches
    assert abs(witness["r"] - WITNESS_R) <= WITNESS_TOL, witness
    assert abs(witness["err1"] - WITNESS_ERR) <= WITNESS_TOL, witness
    phase_seconds["wide_fused_training"] = time.perf_counter() - phase_start

    full = f"{MLA_N}x{MLA_N}_float32"
    main_bound = bounds[full]["rms_loss_mode"]
    return {"name": "fused_bwd_wide", "route": "cuda",
            "source": "pyrayt_tpu_torch/csrc/wide_fused_grad.cu",
            "replaces": "pyrayt_tpu/ops/fused_grad.py:294",
            "launches": main_launches["fused_bwd_wide"],
            "max_abs_err": max(s["max_abs_err"] for key, s in stats[full].items()
                               if key.startswith("fused_bwd_wide.")),
            "ms": times[full]["k8_rms_loss_mode_ms"],
            "plain_ms": times[full]["plain_rms_loss_mode_ms"],
            "bound_ms": main_bound["ms"], "bound_by": main_bound["by"], "library_ms": None}


def synthetic_key_sets(np, n, seed=0):
    """The reduce's synthetic tables: ``{name: (keys (k,) int64, rows)}``,
    keys in [-1, rows): every key -1; every key one row; uniform over 4096
    rows; a detector-like skew (a third of the entries in one of 513 rows,
    the rest uniform or -1); one entry; a length that is a multiple of
    neither the sort's segment (2048) nor its warp step."""
    rng = np.random.default_rng(seed)
    skew = rng.integers(-1, 512, n)
    skew[rng.random(n) < 1 / 3] = 512
    return {
        "all_minus_one": (np.full(n, -1), 16),
        "one_row": (np.full(n, 5), 16),
        "uniform_4096": (rng.integers(0, 4096, n), 4096),
        "detector_skew": (skew, 513),
        "n_one": (np.array([3]), 16),
        "ragged": (rng.integers(-1, 40, n - 2048 + 333), 40),
    }


def reduce_bound(keys, n_rows, item):
    """(bound ms, by, bytes) of one reduce on this table: every key read
    once, the 18 values of each entry with a row read once, the sums and
    the slots; 18 float64 adds per such entry."""
    valid = int((keys >= 0).sum())
    n_bytes = 4 * keys.numel() + 18 * item * valid + (18 * item + 4) * n_rows
    t_bytes = n_bytes / PEAK_BYTES * 1e3
    t_ops = 18 * valid / PEAK_F64 * 1e3
    return (t_bytes, "bytes", n_bytes) if t_bytes >= t_ops else (t_ops, "operations", n_bytes)


def row_reduce_phase(torch, np, pyrayt, comp, metrics, ft, fg, TraceConfig, fresh_ids,
                     compile_scene, device, phase_seconds):
    """Phase 15 (module docstring): the table reduce alone against its plain
    version, and its times."""
    phase_start = time.perf_counter()
    config = TraceConfig(generation_limit=MLA_GENERATIONS, fixed_loop=True)
    span = MLA_N * MLA_PITCH * 1.05  # bench.py:1258
    grid = comp.GridOfRays(span, span).move_x(-1.0)
    synthetic = synthetic_key_sets(np, N_RAYS)
    rng = np.random.default_rng(1)
    values = rng.standard_normal((N_RAYS, 18))
    stats, times = {}, {}
    make_table = fg._reduce_table
    for dtype in (torch.float64, torch.float32):
        tag = str(dtype).replace("torch.", "")
        with fresh_ids():
            system, detector, _ = mla_system(comp, pyrayt, MLA_N)
            scene = compile_scene(system, device=device, dtype=dtype)
        spec = scene.spec
        rays = grid.generate_rays(N_RAYS, device=device, dtype=dtype)
        inputs = ft.wide_kernel_inputs(spec, scene.params, rays)
        state0, obj_tx, prim, glass, slots = inputs[:5]
        records, masks, _, fold5, win = ft.fused_trace_wide(spec, config, *inputs, save_fold=True)
        plan = fg.loss_plan(metrics.RmsSpotRadius(float(detector.get_id())))
        scal = plan.row(plan.scalars(records, masks), torch.ones((), device=device))
        # the tables the K6 launches of one staged step and one K8 call fill,
        # with what each launch returned
        tables, k6_launches = [], []

        def keep(*args):
            tables.append(make_table(*args))
            return tables[-1]

        def fold_kept(spec, group, *args):
            out = fold_launch(spec, group, *args)
            if group >= 0:  # K6; K7 is group -1
                k6_launches.append((tables[-1], out))
            return out

        fold_launch = fg._fold_launch
        fg._reduce_table, fg._fold_launch = keep, fold_kept
        try:
            fg.staged_bwd(spec, config, state0, obj_tx, prim, glass, slots, records, masks, fold5,
                          win, scal=scal, plan=plan)
            k8 = fg.fused_bwd_wide(spec, config, *inputs, records, masks, scal=scal, plan=plan)
        finally:
            fg._reduce_table, fg._fold_launch = make_table, fold_launch
        k8_table = tables[-1]
        # the K6 launch whose winners carry the most nonzero cotangents
        # back from the detector
        (k6_keys, k6_vals), k6 = max(
            k6_launches, key=lambda t: int(((t[0][0] >= 0)[:, None] & (t[0][1] != 0)).sum()))
        info = [i for kind, _, i in ft.wide_fold_plan(spec) if kind == "group"][0]
        s_count = spec.n_leaves
        cases = {
            "k6_launch": (k6_keys, k6_vals, slots[info["off"]:info["off"] + info["T"] * info["L"]],
                          s_count, k6[:2]),
            "k8_call": (k8_table[0].reshape(-1), k8_table[1].reshape(-1, 18),
                        torch.arange(s_count, dtype=torch.int32, device=device), s_count,
                        (k8[0], k8[1])),
        }
        for name, (keys_np, rows) in synthetic.items():
            vals = values[:keys_np.size].copy()
            vals[keys_np < 0] = np.nan  # no reduce may read them
            cases[name] = (torch.as_tensor(keys_np, dtype=torch.int32, device=device),
                           torch.as_tensor(vals, dtype=dtype, device=device),
                           torch.as_tensor(rng.permutation(rows + 3)[:rows], dtype=torch.int32,
                                           device=device), rows + 3, None)
        held, identical, same_as_kernel = {}, {}, {}
        for name, (keys, vals, reduce_slots, n_slots, kernel_out) in cases.items():
            rows = reduce_slots.numel()
            first = fg.row_reduce(keys, vals, reduce_slots, rows, n_slots)
            again = fg.row_reduce(keys, vals, reduce_slots, rows, n_slots)
            identical[name] = all(torch.equal(a, b) for a, b in zip(first, again))
            hold(torch, held, f"row_reduce.{name}", ("d_objtx", "d_prim"), first,
                 fg.row_reduce_plain(keys, vals, reduce_slots, rows, n_slots), dtype)
            if kernel_out is not None:  # the kernel's own sums, bit for bit
                same_as_kernel[name] = (torch.equal(first[0][:, :12], kernel_out[0][:, :12])
                                        and torch.equal(first[1], kernel_out[1]))
            if dtype == torch.float32:
                bnd = reduce_bound(keys, rows, vals.element_size())
                mapped = torch.where(keys >= 0, keys, rows).long()
                vals64 = vals.double()
                times[name] = {
                    "n": keys.numel(), "rows": rows, "valid": int((keys >= 0).sum()),
                    "ms": cuda_ms(torch, lambda: fg.row_reduce(keys, vals, reduce_slots, rows,
                                                               n_slots)),
                    "plain_ms": cuda_ms(torch, lambda: fg.row_reduce_plain(
                        keys, vals, reduce_slots, rows, n_slots), repeats=3, warmup=1),
                    "library_ms": cuda_ms(torch, lambda: torch.zeros(
                        (rows + 1, 18), dtype=torch.float64, device=device).index_add_(
                        0, mapped, vals64)),
                    "bound_ms": bnd[0], "bound_by": bnd[1], "bytes": bnd[2]}
                del mapped, vals64
        stats[tag] = held
        log(f"row reduce against its plain version ({tag}; the tables of one K6 launch and one K8 "
            f"call on the {MLA_N}x{MLA_N} array at {N_RAYS} rays, and synthetic keys): two "
            f"launches bit-identical {json.dumps(identical)}; the kernels' own sums "
            f"{json.dumps(same_as_kernel)}; " + json.dumps(held))
        assert all(identical.values()), identical
        assert all(same_as_kernel.values()), same_as_kernel
        assert_held(held, dtype, torch, tag)
        del scene, rays, inputs, records, masks, fold5, win, tables, k6_launches, cases, k6, k8
        torch.cuda.empty_cache()
    log("row reduce times (float32, CUDA events, median; library: torch.zeros(R + 1, 18, "
        "float64).index_add_ of the float64 values, keys -1 mapped to R; the replaced scan as "
        f"recorded {json.dumps(OLD_SCAN_MS)} ms): " + json.dumps(times) + f" on {card_line()}")
    phase_seconds["row_reduce"] = time.perf_counter() - phase_start


def doublet_camera(render, parts, resolution):
    """``render.draw``'s xy-view camera over ``parts``: centered on their
    bounding boxes, 1.5 times their span, looking down -z; and its light."""
    import numpy as np

    spans = np.stack([np.asarray(part.bounding_box) for part in parts])
    mins, maxes = spans[..., 0].min(axis=0), spans[..., 1].max(axis=0)
    origin = (maxes + mins) / 2
    origin[2] = 1.5 * maxes[2]
    h_span, v_span = 1.5 * (maxes[:2] - mins[:2])
    camera = render.OrthographicCamera(resolution, h_span, v_span / h_span)
    camera.rotate_y(90).rotate_z(90).move(*origin)
    light = np.append(maxes.astype(float), 1.0)
    light[2] *= 3
    return camera, light


def render_phase(torch, np, comp, matl, ft, fresh_ids, device, phase_seconds):
    """Phase 16 (module docstring): the aberration analyses and the viewport
    renderers of the achromatic doublet on the card against the CPU."""
    import pandas as pd

    from pyrayt_tpu_torch import render
    from pyrayt_tpu_torch.analysis import aberrations

    phase_start = time.perf_counter()
    r0 = doublet_radii_initial(matl)
    with fresh_ids():
        parts = build_doublet(comp, matl, r0)
    analyses = {
        "spherical": lambda **kw: aberrations.spherical_aberration(
            parts, ray_origin=-10.0, max_radius=0.8 * LENS_DIAMETER / 2, sample_points=21, **kw),
        "chromatic": lambda **kw: aberrations.chromatic_aberration(
            parts, ray_origin=-10.0, test_radius=LENS_DIAMETER / 8,
            wavelengths=(0.45, 0.5, 0.55, 0.6, 0.65), **kw),
        "coma": lambda **kw: aberrations.coma(parts, ray_origin=-10.0, max_radius=LENS_DIAMETER / 4,
                                              angle=2.0, **kw),
    }
    report = {}
    for name, run in analyses.items():
        reference = run(device="cpu", dtype=torch.float64)
        for dtype in (torch.float64, torch.float32):
            tag = f"{name}_{str(dtype).replace('torch.', '')}"
            before = ft.fused_trace.launches
            start = time.perf_counter()
            card = run(device=device, dtype=dtype)
            seconds = time.perf_counter() - start
            launched = ft.fused_trace.launches - before
            if isinstance(card, pd.DataFrame):
                assert list(card.columns) == list(reference.columns) and len(card) == len(reference)
                err = float(np.abs(card.to_numpy() - reference.to_numpy()).max())
                scale = float(np.abs(reference.to_numpy()).max())
                finite = bool(np.isfinite(card.to_numpy()).all())
            else:
                err, scale, finite = abs(card - reference), abs(reference), bool(np.isfinite(card))
            report[tag] = {"max_abs_err": err, "scale": scale, "rows": len(card)
                           if isinstance(card, pd.DataFrame) else 1, "finite": finite,
                           "fused_trace_launches": launched, "host_s": seconds}
            assert finite and launched > 0, (tag, report[tag])
            # float64: the kernel against the plain engine within RTOL64;
            # float32 is reported, not held (PERF.md: at 50 mm the push-off
            # is below float32 resolution)
            report[tag]["within_float64_bound"] = err <= RTOL64 * scale + ATOL64
            assert report[tag]["within_float64_bound"] or dtype == torch.float32, (tag, report)
    log("aberrations of the doublet on the card against the CPU (float64 reference): "
        + json.dumps(report))

    # the viewport renderers: one nearest-hit pass over the pixel grid
    camera, light = doublet_camera(render, parts, 1024)
    images, times = {}, {}
    for label, dev, dtype in (("cpu_float64", "cpu", torch.float64),
                              ("card_float64", device, torch.float64),
                              ("card_float32", device, torch.float32)):
        for kind, make in (("edges", lambda: render.EdgeRender(camera, parts, device=dev,
                                                               dtype=dtype)),
                           ("shaded", lambda: render.ShadedRenderer(
                               camera, parts, light_position=light, device=dev, dtype=dtype))):
            renderer = make()
            start = time.perf_counter()
            images[f"{kind}_{label}"] = renderer.render()
            times[f"{kind}_{label}_s"] = time.perf_counter() - start
    pixels = int(np.prod(camera.get_resolution()))
    agree = {}
    for label in ("card_float64", "card_float32"):
        for kind in ("edges", "shaded"):
            card, ref = images[f"{kind}_{label}"], images[f"{kind}_cpu_float64"]
            assert card.shape == ref.shape and np.isfinite(card).all(), (kind, label)
            same = np.all(np.abs(card - ref) <= 1e-6, axis=-1)
            agree[f"{kind}_{label}"] = float(same.mean())
    log(f"renderers of the doublet ({camera.get_resolution()} = {pixels} pixel rays, host clock "
        f"{json.dumps(times)}): share of pixels equal to the CPU's float64 image "
        f"{json.dumps(agree)}; edge pixels {int(images['edges_card_float32'][..., 3].sum())}")
    assert agree["edges_card_float64"] >= 0.999 and agree["shaded_card_float64"] >= 0.999, agree
    assert agree["edges_card_float32"] >= 0.99 and agree["shaded_card_float32"] >= 0.99, agree
    assert 0 < images["edges_card_float32"][..., 3].sum() < pixels
    phase_seconds["render_and_aberrations"] = time.perf_counter() - phase_start


# ---------------------------------------------------------------------------
# 17. parallel: ranks of torch.distributed worlds on the card
# ---------------------------------------------------------------------------

# two ranks share the one card over gloo (NCCL takes one device per rank);
# a 1-rank NCCL world exercises the NCCL path
PARALLEL_RANKS = 2
PARALLEL_TIMEOUT_S = 420
# (d): the plain fold's (trees x rays) arrays at 2**20 rays would be 256
# times a ray row per array, so the tree axis runs at 2**16 rays
TREE_RAYS = 1 << 16
SPHERE_SIDE = 32  # (d): a 32 x 32 sphere grid, 1024 leaves
PARALLEL_LR = 1e-2
# the kernels a rank may launch, by the name of the kernels line
RANK_KERNELS = ("fused_trace", "fused_bwd_loss", "fused_bwd", "fused_trace_wide", "staged_tail",
                "staged_group", "staged_singles", "fused_bwd_wide")


def rank_counters(ft, fg):
    return {name: getattr(ft if hasattr(ft, name) else fg, name) for name in RANK_KERNELS}


def random_grid_rays(np, interop, torch, n, span, device, dtype, seed=17):
    """``n`` +X rays from x = -1 at uniform random points of a span x span
    square (no ray meets two lenslets at one distance: at such a tie the
    sharded combine splits the cotangent, the one-process engine does
    not)."""
    rng = np.random.default_rng(seed)
    pos = np.zeros((4, n))
    pos[0], pos[3] = -1.0, 1.0
    pos[1:3] = (rng.random((2, n)) - 0.5) * span
    dirs = np.zeros((4, n))
    dirs[0] = 1.0
    meta = np.stack((np.zeros(n), np.full(n, 100.0), np.full(n, 0.633), np.ones(n),
                     np.arange(n, dtype=float)))
    return interop.rays_from_numpy(pos, dirs, meta, device=device, dtype=dtype)


def sphere_grid_inputs(np, torch, side, n, device):
    """(world (S, 4, 4), params (S, 6), rays (2, 4, n)) of a side x side
    grid of unit spheres at x = 5 (pitch 3) and a fan of rays from the
    origin (tests/test_parallel/test_surface_sharding.py's scene, wider)."""
    ys, zs = np.meshgrid((np.arange(side) - (side - 1) / 2) * 3.0,
                         (np.arange(side) - (side - 1) / 2) * 3.0)
    world = np.tile(np.eye(4), (side * side, 1, 1))
    world[:, 0, 3], world[:, 1, 3], world[:, 2, 3] = 5.0, ys.ravel(), zs.ravel()
    params = np.zeros((side * side, 6))
    params[:, 0] = 1.0
    rng = np.random.default_rng(0)
    d = rng.normal(size=(3, n))
    d[0] = np.abs(d[0]) * 0.1 + 0.3
    d /= np.linalg.norm(d, axis=0)
    rays = np.zeros((2, 4, n))
    rays[0, 3] = 1.0
    rays[1, :3] = d
    return tuple(torch.as_tensor(x, dtype=torch.float64, device=device)
                 for x in (world, params, rays))


def timed(torch, fn, repeats=3):
    """(result of the last call, median host ms, median CUDA-event ms) of
    ``repeats`` synchronized calls after one warm-up."""
    out = fn()
    host, events = [], []
    for _ in range(repeats):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        out = fn()
        end.record()
        torch.cuda.synchronize()
        host.append((time.perf_counter() - t0) * 1e3)
        events.append(start.elapsed_time(end))
    return out, statistics.median(host), statistics.median(events)


def rank_ray_and_tree(workdir):
    """One rank of phase 17's 2-rank gloo world (a)-(d), (f): returns what
    it measured; the parent holds it against its one-process runs."""
    import numpy as np
    import torch
    import torch.distributed as dist

    import pyrayt_tpu_torch as pyrayt
    from pyrayt_tpu_torch import components as comp
    from pyrayt_tpu_torch import interop
    from pyrayt_tpu_torch import materials as matl
    from pyrayt_tpu_torch.analysis import metrics
    from pyrayt_tpu_torch.config import TraceConfig
    from pyrayt_tpu_torch.core import primitives as prim
    from pyrayt_tpu_torch.ops import fused_grad as fg
    from pyrayt_tpu_torch.ops import fused_trace as ft
    from pyrayt_tpu_torch.parallel import (
        build_surface_sharded_nearest_hit,
        build_train_step,
        build_wide_sharded_trace_fn,
        default_mesh,
        shard_rayset,
        sharded_trace,
    )
    from pyrayt_tpu_torch.parallel import surfaces
    from pyrayt_tpu_torch.parallel.mesh import Mesh
    from pyrayt_tpu_torch.parallel.trace import gather_result
    from pyrayt_tpu_torch.scene import fresh_ids
    from pyrayt_tpu_torch.scene.compile import compile_scene
    from pyrayt_tpu_torch.tracer import engine

    device = torch.device("cuda", 0)
    mesh = default_mesh(device=device)
    counters = rank_counters(ft, fg)
    plain_calls = {"n": 0}

    def counting(fn):
        def wrapped(*args, **kwargs):
            plain_calls["n"] += 1
            return fn(*args, **kwargs)
        return wrapped

    # the plain paths (engine steps and the kernels' plain versions) count
    # their calls: the sharded trace and step must make none
    engine.generation_step = counting(engine.generation_step)
    ft.fused_trace_plain = counting(ft.fused_trace_plain)
    ft.fused_trace_wide_plain = counting(ft.fused_trace_wide_plain)

    def zero():
        for c in counters.values():
            c.launches = 0
        plain_calls["n"] = 0

    def read():
        return {name: c.launches for name, c in counters.items()}, plain_calls["n"]

    def rank_kernel_times(fn, names):
        """``kernel_times`` of one kernel on this rank's block: with both
        ranks timing at once (time-sliced on the card), then rank by rank
        while the other waits at a barrier."""
        dist.barrier()
        times = {"together": kernel_times(torch, fn, names)}
        for r in range(mesh.size):
            dist.barrier()
            if r == mesh.rank:
                times["alone"] = kernel_times(torch, fn, names)
        dist.barrier()
        return times

    def same(a, b):
        return bool(torch.equal(a.record_mask, b.record_mask) and torch.equal(a.records, b.records)
                    and torch.equal(a.final_rays.positions, b.final_rays.positions)
                    and torch.equal(a.final_rays.directions, b.final_rays.directions)
                    and int(a.generations_run) == int(b.generations_run))

    out = {"rank": mesh.rank, "size": mesh.size, "backend": dist.get_backend(),
           "launches": {name: 0 for name in RANK_KERNELS}}

    def path(label, fn):
        """Run one path with the counts at 0; add its launches."""
        zero()
        result = fn()
        torch.cuda.synchronize()
        launched, plain = read()
        out[label + "_launches"], out[label + "_plain_calls"] = launched, plain
        for k, v in launched.items():
            out["launches"][k] += v
        return result

    # (a) the condenser, ray axis, K1 per rank --------------------------------
    config = TraceConfig(generation_limit=GENERATIONS)
    for dtype in (torch.float32, torch.float64):
        tag = str(dtype)[6:]
        with fresh_ids():
            source, parts = condenser(comp, matl)
            scene = compile_scene(parts, device=device, dtype=dtype)
        rays = source.generate_rays(N_RAYS, device=device, dtype=dtype)
        local = path(f"a_{tag}", lambda: sharded_trace(scene, rays, config, mesh))
        glob = gather_result(local, mesh)
        one = engine.trace_rays(scene, rays, config)  # one K1 launch over every ray
        out[f"a_{tag}_equal"] = same(glob, one)
        out[f"a_{tag}_records"] = int(one.record_mask.sum())
        if dtype == torch.float32:
            _, out["trace_host_ms"], out["trace_event_ms"] = timed(
                torch, lambda: sharded_trace(scene, rays, config, mesh))
            _, out["gather_host_ms"], out["gather_event_ms"] = timed(
                torch, lambda: mesh.gather(local.records))
            out["gather_bytes"] = local.records.numel() * local.records.element_size() * mesh.size
            k1_inputs = ft.kernel_inputs(scene.params, shard_rayset(rays, mesh))
            out["k1_rank"] = rank_kernel_times(
                lambda: ft.fused_trace(scene.spec, config, *k1_inputs), K1_NAMES)
            del k1_inputs
        del local, glob, one
        torch.cuda.empty_cache()

    # (b) the condenser train step, K1 + K4 per rank --------------------------
    for dtype in (torch.float64, torch.float32):
        tag = str(dtype)[6:]
        with fresh_ids():
            source, parts = condenser(comp, matl)
            scene = compile_scene(parts, device=device, dtype=dtype)
        local_rays = shard_rayset(source.generate_rays(N_RAYS, device=device, dtype=dtype), mesh)
        keep, kept = grad_keeper()
        step = build_train_step(scene, config, mesh, metrics.rms_spot_radius,
                                learning_rate=PARALLEL_LR, param_filter=keep)
        params, loss = path(f"b_{tag}", lambda: step(scene.params, local_rays))
        out[f"b_{tag}"] = {"params": {k: v.cpu() for k, v in params.items()},
                           "grads": dict(kept), "loss": float(loss)}
        again, loss_again = step(scene.params, local_rays)
        out[f"b_{tag}_repeat_identical"] = bool(
            all(torch.equal(params[k], again[k]) for k in params) and float(loss) == float(
                loss_again))
        if dtype == torch.float32:
            _, out["step_host_ms"], out["step_event_ms"] = timed(
                torch, lambda: step(scene.params, local_rays))
            grads = [p.detach() for p in scene.params.values()]
            _, out["grad_sum_host_ms"], out["grad_sum_event_ms"] = timed(
                torch, lambda: mesh.ordered_sum(grads))
        del step, local_rays
        torch.cuda.empty_cache()

    # (c) the 16x16 array at full width: K2; K2 + K5/K6/K7; K2 + K8 ------------
    span = MLA_N * MLA_PITCH * 0.95
    with fresh_ids():
        parts, detector, _ = mla_system(comp, pyrayt, MLA_N)
        scene = compile_scene(parts, device=device, dtype=torch.float32)
        det_id = float(detector.get_id())
    rays = comp.GridOfRays(span, span).move_x(-1.0).generate_rays(N_RAYS, device=device,
                                                                  dtype=torch.float32)
    config = TraceConfig(generation_limit=MLA_GENERATIONS)
    local = path("c_trace", lambda: sharded_trace(scene, rays, config, mesh))
    one = engine.trace_rays(scene, rays, config)
    out["c_trace_equal"] = same(gather_result(local, mesh), one)
    out["c_trace_records"] = int(one.record_mask.sum())
    _, out["wide_trace_host_ms"], out["wide_trace_event_ms"] = timed(
        torch, lambda: sharded_trace(scene, rays, config, mesh))
    del local, one
    local_rays = shard_rayset(rays, mesh)
    k2_inputs = ft.wide_kernel_inputs(scene.spec, scene.params, local_rays)
    out["k2_rank"] = rank_kernel_times(
        lambda: ft.fused_trace_wide(scene.spec, config, *k2_inputs), K2_NAMES)
    del k2_inputs
    for route in ("staged", "fused"):
        cfg = TraceConfig(generation_limit=MLA_GENERATIONS,
                          wide_grad="fused" if route == "fused" else None)
        keep, kept = grad_keeper()
        step = build_train_step(scene, cfg, mesh, lambda r: metrics.rms_spot_radius(r, det_id),
                                learning_rate=PARALLEL_LR, param_filter=keep)
        params, loss = path(f"c_{route}", lambda: step(scene.params, local_rays))
        out[f"c_{route}"] = {"params": {k: v.cpu() for k, v in params.items()},
                             "grads": dict(kept), "loss": float(loss)}
        _, out[f"wide_step_{route}_host_ms"], _ = timed(
            torch, lambda: step(scene.params, local_rays), repeats=2)
        del step
        torch.cuda.empty_cache()

    # (d) the tree axis: 256 trees over the ranks, the plain engine, f64 -----
    smesh = Mesh({"surfaces": mesh.size}, device)
    with fresh_ids():
        scene = compile_scene(mla_system(comp, pyrayt, MLA_N)[0], device=device,
                              dtype=torch.float64)
    rays = random_grid_rays(np, interop, torch, TREE_RAYS, span, device, torch.float64)
    fn = build_wide_sharded_trace_fn(scene, TraceConfig(generation_limit=MLA_GENERATIONS,
                                                        fixed_loop=True), smesh)
    params = {k: v.detach().requires_grad_(True) for k, v in scene.params.items()}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    result = fn(params, rays)
    loss = metrics.rms_spot_radius(result, det_id)
    loss.backward()
    torch.cuda.synchronize()
    out["tree_value_and_grad_host_ms"] = (time.perf_counter() - t0) * 1e3
    out["d_tree"] = {"records": result.records.detach().cpu(), "mask": result.record_mask.cpu(),
                     "loss": float(loss), **{k: v.grad.cpu() for k, v in params.items()}}
    d = torch.rand(TREE_RAYS, dtype=torch.float64, device=device)
    leaf = torch.randint(0, 100, (TREE_RAYS,), dtype=torch.int32, device=device)
    _, out["min_fold_host_ms"], out["min_fold_event_ms"] = timed(
        torch, lambda: surfaces._min_combine(smesh, d, leaf))
    del result, loss, params, fn
    torch.cuda.empty_cache()

    world, sparams, srays = sphere_grid_inputs(np, torch, SPHERE_SIDE, TREE_RAYS, device)
    fold = build_surface_sharded_nearest_hit(prim.SPHERE, smesh)
    s_dist, s_leaf = fold(world, sparams, srays)
    r_dist, r_leaf = surfaces.replicated_nearest_hit(prim.SPHERE, world, sparams, srays)
    hit = r_leaf >= 0
    out["d_spheres"] = {
        "leaf_equal": bool(torch.equal(s_leaf, r_leaf)),
        "dist_max_rel_err": float(((s_dist - r_dist).abs() / r_dist.abs())[hit].max()),
        "miss_equal": bool(torch.equal(torch.isinf(s_dist), torch.isinf(r_dist))),
        "hits": int(hit.sum()), "distinct_leaves": int(torch.unique(r_leaf[hit]).numel())}
    _, out["sphere_fold_host_ms"], _ = timed(torch, lambda: fold(world, sparams, srays))
    return out


def rank_nccl(workdir):
    """Phase 17 (e): one condenser train step (float64) in a 1-rank NCCL
    world; its collectives run on NCCL."""
    import torch
    import torch.distributed as dist

    from pyrayt_tpu_torch import components as comp
    from pyrayt_tpu_torch import materials as matl
    from pyrayt_tpu_torch.analysis import metrics
    from pyrayt_tpu_torch.config import TraceConfig
    from pyrayt_tpu_torch.ops import fused_grad as fg
    from pyrayt_tpu_torch.ops import fused_trace as ft
    from pyrayt_tpu_torch.parallel import build_train_step, default_mesh, shard_rayset
    from pyrayt_tpu_torch.scene import fresh_ids
    from pyrayt_tpu_torch.scene.compile import compile_scene

    device = torch.device("cuda", 0)
    mesh = default_mesh(device=device)
    counters = rank_counters(ft, fg)
    with fresh_ids():
        source, parts = condenser(comp, matl)
        scene = compile_scene(parts, device=device, dtype=torch.float64)
    rays = shard_rayset(source.generate_rays(N_RAYS, device=device, dtype=torch.float64), mesh)
    step = build_train_step(scene, TraceConfig(generation_limit=GENERATIONS), mesh,
                            metrics.rms_spot_radius, learning_rate=PARALLEL_LR)
    for c in counters.values():
        c.launches = 0
    params, loss = step(scene.params, rays)
    torch.cuda.synchronize()
    return {"backend": dist.get_backend(), "size": mesh.size, "joined": mesh.joined,
            "launches": {name: c.launches for name, c in counters.items()},
            "params": {k: v.cpu() for k, v in params.items()}, "loss": float(loss)}


RANK_TASKS = {"ray_and_tree": rank_ray_and_tree, "nccl": rank_nccl}


def rank_main(argv) -> int:
    """``chip_smoke.py --rank R --world W --workdir DIR --backend B --task
    T``: one rank of a phase-17 world."""
    import argparse

    parser = argparse.ArgumentParser()
    for name in ("--rank", "--world"):
        parser.add_argument(name, type=int, required=True)
    for name in ("--workdir", "--backend", "--task"):
        parser.add_argument(name, required=True)
    args = parser.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    torch.cuda.set_device(0)
    from pyrayt_tpu_torch.parallel import initialize_distributed

    store = os.path.join(args.workdir, args.task + ".store")
    initialize_distributed(f"file://{store}", args.world, args.rank, initialization_timeout=180,
                           backend=args.backend)
    out = RANK_TASKS[args.task](args.workdir)
    if "jax" in sys.modules or "pyrayt_tpu" in sys.modules:
        raise RuntimeError("a rank imported jax or pyrayt_tpu")
    torch.save(out, os.path.join(args.workdir, f"{args.task}.rank{args.rank}.pt"))
    torch.distributed.destroy_process_group()
    return 0


def spawn_ranks(torch, task, world, backend, workdir):
    """Start ``world`` rank processes of ``task`` and wait for them within
    PARALLEL_TIMEOUT_S (every rank killed past it); returns each rank's
    dict.  Any rank's failure raises with its log."""
    procs, logs = [], []
    for rank in range(world):
        log_file = open(os.path.join(workdir, f"{task}.rank{rank}.log"), "w")
        logs.append(log_file)
        procs.append(subprocess.Popen(
            [sys.executable, os.path.join(HERE, "chip_smoke.py"), "--rank", str(rank), "--world",
             str(world), "--workdir", workdir, "--backend", backend, "--task", task],
            stdout=log_file, stderr=subprocess.STDOUT, cwd=HERE))
    deadline = time.monotonic() + PARALLEL_TIMEOUT_S
    try:
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 0.1))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log_file in logs:
            log_file.close()
    for rank, p in enumerate(procs):
        with open(os.path.join(workdir, f"{task}.rank{rank}.log")) as f:
            text = f.read()
        if p.returncode != 0:
            raise RuntimeError(f"phase 17: rank {rank} of {task!r} exited {p.returncode}:\n"
                               + text[-4000:])
    return [torch.load(os.path.join(workdir, f"{task}.rank{r}.pt"), weights_only=False)
            for r in range(world)]


def grad_keeper():
    """A ``param_filter`` that keeps a copy of the summed gradients it is
    given (on the host) and passes them on unchanged."""
    kept = {}

    def keep(grads):
        kept.update({k: v.detach().cpu() for k, v in grads.items()})
        return grads

    return keep, kept


def parallel_phase(torch, np, pyrayt, comp, matl, metrics, TraceConfig, fresh_ids, compile_scene,
                   device, phase_seconds):
    """Phase 17 (module docstring): returns the launches the ranks made per
    kernel."""
    from pyrayt_tpu_torch.parallel import build_train_step, default_mesh
    from pyrayt_tpu_torch.tracer import engine

    phase_start = time.perf_counter()
    workdir = os.path.join(HERE, "build", "parallel_phase")
    shutil.rmtree(workdir, ignore_errors=True)
    os.makedirs(workdir)
    torch.cuda.empty_cache()
    ranks = spawn_ranks(torch, "ray_and_tree", PARALLEL_RANKS, "gloo", workdir)
    rank_s = time.perf_counter() - phase_start
    card = card_line()
    for out in ranks:
        brief = {k: v for k, v in out.items()
                 if not isinstance(v, dict) or k.endswith("launches") or k == "d_spheres"}
        log(f"parallel rank {out['rank']} of {out['size']} ({out['backend']}, on {card}): "
            + json.dumps(brief))
        assert out["backend"] == "gloo" and out["size"] == PARALLEL_RANKS
        # (a), (c): the gathered traces equal one launch over every ray
        for key in ("a_float32_equal", "a_float64_equal", "c_trace_equal"):
            assert out[key], (out["rank"], key)
        for label, kernels in (("a_float32", ("fused_trace",)), ("a_float64", ("fused_trace",)),
                               ("b_float64", ("fused_trace", "fused_bwd")),
                               ("b_float32", ("fused_trace", "fused_bwd")),
                               ("c_trace", ("fused_trace_wide",)),
                               ("c_staged", ("fused_trace_wide", "staged_tail", "staged_group",
                                             "staged_singles")),
                               ("c_fused", ("fused_trace_wide", "fused_bwd_wide"))):
            launched = out[label + "_launches"]
            assert all(launched[k] > 0 for k in kernels), (out["rank"], label, launched)
            assert out[label + "_plain_calls"] == 0, (out["rank"], label)
            others = set(RANK_KERNELS) - set(kernels)
            assert all(launched[k] == 0 for k in others), (out["rank"], label, launched)
        assert out["b_float64_repeat_identical"] and out["b_float32_repeat_identical"]
        s = out["d_spheres"]
        assert s["leaf_equal"] and s["miss_equal"] and s["dist_max_rel_err"] <= 1e-12, s
        assert s["distinct_leaves"] > 100, s
    first = ranks[0]
    for out in ranks[1:]:  # every rank holds the same step and the same tree-axis result
        for key in ("b_float64", "b_float32", "c_staged", "c_fused"):
            assert out[key]["loss"] == first[key]["loss"], key
            assert all(torch.equal(out[key]["params"][k], first[key]["params"][k])
                       for k in first[key]["params"]), key
        for k, v in first["d_tree"].items():
            assert (v == out["d_tree"][k]) if isinstance(v, float) else torch.equal(
                v, out["d_tree"][k]), k

    # the parent's one-process runs, without a group ----------------------
    mesh1 = default_mesh(device=device)
    reports = {}
    for dtype in (torch.float64, torch.float32):
        tag = str(dtype)[6:]
        with fresh_ids():
            source, parts = condenser(comp, matl)
            scene = compile_scene(parts, device=device, dtype=dtype)
        rays = source.generate_rays(N_RAYS, device=device, dtype=dtype)
        keep, kept = grad_keeper()
        step = build_train_step(scene, TraceConfig(generation_limit=GENERATIONS), mesh1,
                                metrics.rms_spot_radius, learning_rate=PARALLEL_LR,
                                param_filter=keep)
        ref, ref_loss = step(scene.params, rays)
        report = grad_compare(torch, first[f"b_{tag}"]["grads"], kept, dtype)
        reports[f"b_{tag}"] = {"grads": report, "loss": first[f"b_{tag}"]["loss"],
                               "one_process_loss": float(ref_loss)}
        assert_within(report)
        if dtype == torch.float64:
            condenser_ref = {k: v.cpu() for k, v in ref.items()}
        del step, rays
    span = MLA_N * MLA_PITCH * 0.95
    with fresh_ids():
        parts, detector, _ = mla_system(comp, pyrayt, MLA_N)
        scene = compile_scene(parts, device=device, dtype=torch.float32)
        det_id = float(detector.get_id())
    rays = comp.GridOfRays(span, span).move_x(-1.0).generate_rays(N_RAYS, device=device,
                                                                  dtype=torch.float32)
    for route in ("staged", "fused"):
        cfg = TraceConfig(generation_limit=MLA_GENERATIONS,
                          wide_grad="fused" if route == "fused" else None)
        keep, kept = grad_keeper()
        step = build_train_step(scene, cfg, mesh1, lambda r: metrics.rms_spot_radius(r, det_id),
                                learning_rate=PARALLEL_LR, param_filter=keep)
        ref, ref_loss = step(scene.params, rays)
        report = grad_compare(torch, first[f"c_{route}"]["grads"], kept, torch.float32)
        reports[f"c_{route}"] = {"grads": report, "loss": first[f"c_{route}"]["loss"],
                                 "one_process_loss": float(ref_loss)}
        assert_within(report)
        del step
    del rays
    torch.cuda.empty_cache()

    with fresh_ids():
        scene = compile_scene(mla_system(comp, pyrayt, MLA_N)[0], device=device,
                              dtype=torch.float64)
    from pyrayt_tpu_torch import interop

    rays = random_grid_rays(np, interop, torch, TREE_RAYS, span, device, torch.float64)
    params = {k: v.detach().requires_grad_(True) for k, v in scene.params.items()}
    # both split an exact tie between two trees (the MIN combine between
    # ranks, amin within one): the tied rays are counted, not held apart
    with tree_ties(torch, engine) as ties:
        result = engine.build_trace_fn(scene.spec, scene.materials, TraceConfig(
            generation_limit=MLA_GENERATIONS, fixed_loop=True, remat=True))(params, rays)
        loss = metrics.rms_spot_radius(result, det_id)
        loss.backward()
    tree = first["d_tree"]
    tree_equal = bool(torch.equal(tree["mask"], result.record_mask.cpu())
                      and torch.equal(tree["records"], result.records.detach().cpu()))
    report = grad_compare(torch, {k: tree[k] for k in params},
                          {k: v.grad.cpu() for k, v in params.items()}, torch.float64)
    reports["d_tree"] = {"grads": report, "records_equal": tree_equal, "loss": tree["loss"],
                         "one_process_loss": loss.item(), "records": int(result.record_mask.sum()),
                         "tied_rays": ties.count()}
    assert tree_equal, "the tree-axis trace differs from the one-process plain engine"
    assert_within(report)
    del result, loss, params, rays, scene
    torch.cuda.empty_cache()
    log("parallel against one process (summed gradients, loss; on " + card + "): "
        + json.dumps(reports))

    # (e) a 1-rank NCCL world ----------------------------------------------
    (nccl,) = spawn_ranks(torch, "nccl", 1, "nccl", workdir)
    nccl_identical = all(torch.equal(nccl["params"][k], condenser_ref[k]) for k in condenser_ref)
    log(f"parallel NCCL world: backend {nccl['backend']}, size {nccl['size']}, launches "
        f"{json.dumps(nccl['launches'])}, loss {nccl['loss']!r} vs "
        f"{reports['b_float64']['one_process_loss']!r}, params bit-identical to the step "
        f"without a group: {nccl_identical}")
    assert nccl["backend"] == "nccl" and nccl["size"] == 1 and nccl["joined"]
    assert nccl["launches"]["fused_trace"] > 0 and nccl["launches"]["fused_bwd"] > 0
    assert nccl_identical and nccl["loss"] == reports["b_float64"]["one_process_loss"]

    # (f) times per rank ----------------------------------------------------
    times = {f"rank{out['rank']}": {k: out[k] for k in out if k.endswith("_ms")} for out in ranks}
    for out in ranks:
        for key in ("k1_rank", "k2_rank"):
            times[f"rank{out['rank']}"][key] = {
                how: {k: t[k] for k in ("device_ms", "burst_ms", "event_ms", "host_ms")}
                for how, t in out[key].items()}
    log(f"parallel times (ms, median; {PARALLEL_RANKS} gloo ranks time-sliced on one card; "
        f"the condenser gather moves {first['gather_bytes']} bytes per rank; on {card}): "
        + json.dumps(times))
    launches = {name: sum(out["launches"][name] for out in ranks) + nccl["launches"][name]
                for name in RANK_KERNELS}
    log("parallel rank launches: " + json.dumps(launches))
    phase_seconds["parallel"] = time.perf_counter() - phase_start
    phase_seconds["parallel_ranks"] = rank_s
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import numpy as np

    import pyrayt_tpu_torch as pyrayt
    from pyrayt_tpu_torch import components as comp
    from pyrayt_tpu_torch import interop
    from pyrayt_tpu_torch import materials as matl
    from pyrayt_tpu_torch.analysis import build_objective, metrics, optimize
    from pyrayt_tpu_torch.config import TraceConfig
    from pyrayt_tpu_torch.ops import fused_grad as fg
    from pyrayt_tpu_torch.ops import fused_trace as ft
    from pyrayt_tpu_torch.scene import fresh_ids
    from pyrayt_tpu_torch.scene.compile import compile_scene
    from pyrayt_tpu_torch.tracer import engine
    from pyrayt_tpu_torch.tracer.frame import records_to_dataframe

    package_dir = os.path.dirname(os.path.abspath(pyrayt.__file__))
    if os.path.dirname(package_dir) != HERE:
        print(f"chip_smoke: pyrayt_tpu_torch found at {package_dir}, not in {HERE}",
              file=sys.stderr)
        return 2
    if "jax" in sys.modules:
        print("chip_smoke: jax was imported", file=sys.stderr)
        return 2

    device = torch.device("cuda", 0)
    log("device:", torch.cuda.get_device_name(0), "| torch", torch.__version__,
        "| cuda", torch.version.cuda)

    # 1. build -------------------------------------------------------------
    phase_start = time.perf_counter()
    for stem, (lib_path, build_s, build_log) in ft.build_kernels().items():
        log(f"build {stem}: {build_s:.2f} s -> {os.path.relpath(lib_path, HERE)}")
        for line in build_log.splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                log("  ptxas:", line.strip())
    phase_seconds = {"build": time.perf_counter() - phase_start}

    # 1b. every kernel's device time, before anything else runs ------------
    phase_start = time.perf_counter()
    device_times = kernel_device_times(torch, pyrayt, comp, matl, metrics, TraceConfig, fg, ft,
                                       fresh_ids, compile_scene, device)
    for name, t in device_times.items():
        log(f"device times {name} (float32, 2**20 rays; ms per call, a staged kernel's per "
            f"step): " + json.dumps(t))
    reduce_share = sum(v for k, v in device_times["fused_bwd_wide"]["device_by_kernel"].items()
                       if any(name in k for name in REDUCE_KERNELS))
    log(f"K8's table reduce: {reduce_share:.4f} of its "
        f"{device_times['fused_bwd_wide']['device_ms']:.4f} ms of device time; on {card_line()}")
    phase_seconds["device_times"] = time.perf_counter() - phase_start

    # 2. kernel vs plain on the condenser -----------------------------------
    phase_start = time.perf_counter()
    config = TraceConfig(generation_limit=GENERATIONS)
    results = {}
    for dtype in (torch.float64, torch.float32):
        with fresh_ids():
            source, parts = condenser(comp, matl)
            scene = compile_scene(parts, device=device, dtype=dtype)
            rays = source.generate_rays(N_RAYS, device=device, dtype=dtype)
        inputs = ft.kernel_inputs(scene.params, rays)
        res = compare(torch, ft, scene.spec, config, inputs, dtype)
        results[res["dtype"]] = res
        log("compare:", json.dumps(res))
    r64, r32 = results["float64"], results["float32"]
    assert r64["mask_agree_share"] >= MASK_SHARE64, r64
    assert r64["share_outside_tolerance"] <= 1.0 - MASK_SHARE64, r64
    assert r32["share_outside_tolerance"] <= DIFF_SHARE32, r32
    assert r64["records_finite"] and r32["records_finite"], results
    phase_seconds["compare"] = time.perf_counter() - phase_start

    # 3. the main path: RayTracer.trace() at float32 ---------------------
    phase_start = time.perf_counter()
    with fresh_ids():
        source, parts = condenser(comp, matl)
    tracer = pyrayt.RayTracer(
        source, parts, rays_per_source=N_RAYS, generation_limit=GENERATIONS,
        device=device, dtype=torch.float32,
    )
    ft.fused_trace.launches = fg.fused_bwd_loss.launches = fg.fused_bwd.launches = 0
    start = time.perf_counter()
    frame = tracer.trace()
    main_s = time.perf_counter() - start
    launches = ft.fused_trace.launches
    assert launches > 0, "the main path did not launch the kernel"
    plain_tracer = pyrayt.RayTracer(
        source, parts, rays_per_source=N_RAYS, generation_limit=GENERATIONS,
        config=TraceConfig(use_fused=False), device=device, dtype=torch.float32,
    )
    plain_frame = plain_tracer.trace()
    assert list(frame.columns) == list(plain_frame.columns) and frame.shape[1] == 15
    assert np.isfinite(frame.to_numpy()).all(), "non-finite values in the frame"
    log(f"main: RayTracer.trace() {main_s:.3f} s (host clock, first call), "
        f"{len(frame)} rows x {frame.shape[1]} cols; plain engine {len(plain_frame)} rows; "
        f"kernel launches {launches}")
    assert len(frame) == len(plain_frame), (len(frame), len(plain_frame))

    # where a warm call's time goes (host clock, synchronized per stage)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    scene = compile_scene(parts, device=device, dtype=torch.float32)
    rays = source.generate_rays(N_RAYS, device=device, dtype=torch.float32)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    result = engine.trace_rays(scene, rays, tracer.get_config())
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    warm_frame = records_to_dataframe(result.records, result.record_mask)
    t3 = time.perf_counter()
    stages = {"scene_and_rays_s": t1 - t0, "trace_s": t2 - t1, "frame_s": t3 - t2,
              "frame_rows": len(warm_frame)}
    log("main stages (warm, host clock):", json.dumps(stages))
    phase_seconds["main"] = time.perf_counter() - phase_start

    # 4. the tutorial collimator through the kernel ----------------------
    phase_start = time.perf_counter()
    before = ft.fused_trace.launches
    lens = comp.biconvex_lens(2, 2, 0.25, aperture=1)
    focus = pyrayt.lensmakers_equation(2, -2, 1.5, 0.25)
    cone = comp.ConeOfRays(cone_angle=6).move_x(-focus)
    baffle = comp.baffle((1, 1)).move_x(1)
    tut = pyrayt.RayTracer(cone, [lens, baffle], rays_per_source=50, generation_limit=100,
                           device=device, dtype=torch.float32).trace()
    assert ft.fused_trace.launches > before, "the tutorial did not launch the kernel"
    assert len(tut) == 150, len(tut)
    assert np.allclose(tut[tut.generation == 2]["x1"], 1.0), "generation 2 not at x = 1"
    log(f"tutorial: {len(tut)} rows, generation-2 x1 == 1")
    phase_seconds["tutorial"] = time.perf_counter() - phase_start

    # 5. times -----------------------------------------------------------
    phase_start = time.perf_counter()
    with fresh_ids():
        source, parts = condenser(comp, matl)
        scene = compile_scene(parts, device=device, dtype=torch.float32)
        rays = source.generate_rays(N_RAYS, device=device, dtype=torch.float32)
    inputs = ft.kernel_inputs(scene.params, rays)
    saved = ft.fused_trace.launches
    ms = cuda_ms(torch, lambda: ft.fused_trace(scene.spec, config, *inputs))
    plain_ms = cuda_ms(torch, lambda: ft.fused_trace_plain(scene.spec, config, *inputs))
    ft.fused_trace.launches = saved
    card = card_line()
    log(f"times: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms "
        f"({N_RAYS} rays x {GENERATIONS} generations, float32, median of 10) on {card}")
    phase_seconds["times"] = time.perf_counter() - phase_start

    # 6. gradients against autograd of the plain forward -------------------
    phase_start = time.perf_counter()
    grad_config = TraceConfig(generation_limit=GENERATIONS, fixed_loop=True, remat=True)
    names = ("world", "prim", "glass")

    def condenser_scene(dtype):
        with fresh_ids():
            source, parts = condenser(comp, matl)
            scene = compile_scene(parts, device=device, dtype=dtype)
            rays = source.generate_rays(N_RAYS, device=device, dtype=dtype)
        return scene, rays, float(scene.spec.leaf_ids[-1])  # the detector

    def param_grads(scene, value_of):
        params = {k: v.detach().clone().requires_grad_(True) for k, v in scene.params.items()}
        value = value_of(params)
        grads = torch.autograd.grad(value, [params[k] for k in names])
        return float(value.detach()), dict(zip(names, grads))

    def plain_result(scene, params, rays):
        records, masks, fstate = ft.fused_trace_plain(
            scene.spec, grad_config, *ft.kernel_inputs(params, rays))
        return engine.TraceResult(records, masks, ft.rays_from_state(fstate),
                                  masks.any(dim=1).sum())

    def generic_loss(result):
        m = result.record_mask.to(result.records.dtype)
        hits = (result.records[:, 9] ** 2 + result.records[:, 10] ** 2) * m
        return hits.sum() / N_RAYS + result.final_rays.positions[1].sum() / N_RAYS

    grad_reports = {}
    for dtype in (torch.float64, torch.float32):
        tag = str(dtype).replace("torch.", "")
        scene, rays, sid = condenser_scene(dtype)
        loss = metrics.RmsSpotRadius(sid)
        value_fn = fg.build_fused_value_and_grad_fn(scene.spec, scene.materials, grad_config, loss)
        k_value, k_grads = param_grads(scene, lambda p: value_fn(p, rays))
        p_value, p_grads = param_grads(scene, lambda p: loss(plain_result(scene, p, rays)))
        report = grad_compare(torch, k_grads, p_grads, dtype)
        grad_reports[f"k3_rms_{tag}"] = report
        log(f"gradient (a) K3 RmsSpotRadius {tag}: value {k_value!r} vs plain {p_value!r}; "
            + json.dumps(report))
        assert_within(report)
        if dtype == torch.float64:
            _, again = param_grads(scene, lambda p: value_fn(p, rays))
            identical = all(torch.equal(again[k], k_grads[k]) for k in names)
            log(f"gradient (a) two K3 launches bit-identical: {identical}")
            assert identical, "two K3 launches differ"
        trace_fn = fg.build_fused_vjp_trace_fn(scene.spec, scene.materials, grad_config)
        k_value, k_grads = param_grads(scene, lambda p: generic_loss(trace_fn(p, rays)))
        p_value, p_grads = param_grads(scene, lambda p: generic_loss(plain_result(scene, p, rays)))
        report = grad_compare(torch, k_grads, p_grads, dtype)
        grad_reports[f"k4_generic_{tag}"] = report
        log(f"gradient (b) K4 masked records + final positions {tag}: value {k_value!r} vs "
            f"plain {p_value!r}; " + json.dumps(report))
        assert_within(report)
        del scene, rays, value_fn, trace_fn, k_grads, p_grads
        torch.cuda.empty_cache()

    # (c) the achromatic doublet of examples/lens_design.py, float64
    rays = design_rays(comp, torch, device, torch.float64, n_radii=DOUBLET_RADII)
    r0 = doublet_radii_initial(matl)
    signs = torch.as_tensor(np.sign(r0), device=device, dtype=torch.float64)

    def build_doublet_theta(log_mags):
        return build_doublet(comp, matl, signs * torch.exp(log_mags))

    with fresh_ids():
        imager_id = float(build_doublet(comp, matl, r0)[-1].get_id())
    soft = metrics.SoftFocusError(
        DOUBLET_FOCUS, imager_id, half_widths=(LENS_DIAMETER / 2, LENS_DIAMETER / 2),
        ramp=LENS_DIAMETER / 20)
    theta_grads = {}
    for label, use_fused in (("k3", None), ("plain", False)):
        objective = build_objective(
            build_doublet_theta, rays, soft,
            TraceConfig(generation_limit=8, fixed_loop=True, remat=True, use_fused=use_fused))
        theta = torch.log(torch.abs(torch.as_tensor(r0, device=device))).requires_grad_(True)
        before = fg.fused_bwd_loss.launches
        value = objective(theta)
        (theta_grads[label],) = torch.autograd.grad(value, theta)
        launched = fg.fused_bwd_loss.launches - before
        assert launched == (1 if use_fused is None else 0), (label, launched)
        log(f"gradient (c) doublet {label}: value {float(value.detach())!r}, "
            f"d theta {theta_grads[label].tolist()}")
    report = grad_compare(torch, {"theta": theta_grads["k3"]}, {"theta": theta_grads["plain"]},
                          torch.float64)
    grad_reports["k3_doublet_float64"] = report
    log(f"gradient (c) doublet, {rays.n_rays} rays, 8 generations: " + json.dumps(report))
    assert_within(report)
    del rays
    torch.cuda.empty_cache()
    phase_seconds["gradients"] = time.perf_counter() - phase_start

    # 7. training: build_objective + optimize through K1 + K3, then K4 ----
    phase_start = time.perf_counter()
    singlet_rays = comp.LineOfRays(0.4).move_x(-1.0).generate_rays(
        N_RAYS, device=device, dtype=torch.float32)
    with fresh_ids():
        detector_id = float(compile_scene(build_singlet({"r1": 3.0}, comp, matl),
                                            device=device).spec.leaf_ids[-1])
    singlet_config = TraceConfig(generation_limit=4, fixed_loop=True)
    objective = build_objective(lambda th: build_singlet(th, comp, matl), singlet_rays,
                                metrics.RmsSpotRadius(detector_id), singlet_config)
    theta0 = {"r1": torch.tensor(3.0, device=device, dtype=torch.float32)}
    loss0 = float(objective(theta0))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ft.fused_trace.launches = fg.fused_bwd_loss.launches = fg.fused_bwd.launches = 0
    start = time.perf_counter()
    theta_opt, history = optimize(objective, theta0, steps=TRAIN_STEPS, learning_rate=5e-2)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - start
    train_launches = {"fused_trace": ft.fused_trace.launches,
                      "fused_bwd_loss": fg.fused_bwd_loss.launches,
                      "fused_bwd": fg.fused_bwd.launches}
    train_peak = torch.cuda.max_memory_allocated()
    loss_opt = float(objective(theta_opt))
    r1 = float(theta_opt["r1"])
    log(f"training: {TRAIN_STEPS} Adam steps, {N_RAYS} rays, float32: loss {loss0!r} -> "
        f"{loss_opt!r}, r1 3.0 -> {r1!r}; {train_s / TRAIN_STEPS * 1e3:.2f} ms/step "
        f"(host clock); launches {json.dumps(train_launches)}; peak memory "
        f"{train_peak / 2**30:.3f} GiB")
    assert loss_opt < loss0 / 5, (loss0, loss_opt)
    assert history[-1] < history[0], history
    assert 1.5 < r1 < 2.5, r1
    assert train_launches["fused_trace"] >= TRAIN_STEPS, train_launches
    assert train_launches["fused_bwd_loss"] >= TRAIN_STEPS, train_launches

    def rms_on_detector(result):  # no descriptor: the generic K4 backward
        return metrics.rms_spot_radius(result, detector_id)

    generic_objective = build_objective(lambda th: build_singlet(th, comp, matl), singlet_rays,
                                        rms_on_detector, singlet_config)
    ft.fused_trace.launches = fg.fused_bwd_loss.launches = fg.fused_bwd.launches = 0
    _, generic_history = optimize(generic_objective, theta0, steps=GENERIC_STEPS,
                                  learning_rate=5e-2)
    torch.cuda.synchronize()
    generic_launches = {"fused_trace": ft.fused_trace.launches,
                        "fused_bwd_loss": fg.fused_bwd_loss.launches,
                        "fused_bwd": fg.fused_bwd.launches}
    log(f"training, generic loss: {GENERIC_STEPS} steps, losses {generic_history} vs K3 "
        f"{history[:GENERIC_STEPS]}; launches {json.dumps(generic_launches)}")
    assert generic_launches["fused_bwd"] >= GENERIC_STEPS, generic_launches
    assert generic_launches["fused_trace"] >= GENERIC_STEPS, generic_launches
    np.testing.assert_allclose(generic_history, history[:GENERIC_STEPS], rtol=1e-3)

    # where a training step's time goes: host clock (synchronized) for the
    # rebuild alone, the objective's value, and value plus gradient; then
    # torch.profiler's device time over a few value-plus-gradient calls
    theta_t = {"r1": torch.tensor(2.0, device=device, requires_grad=True)}

    def rebuild():
        with fresh_ids():
            compile_scene(build_singlet(theta_t, comp, matl), device=device,
                          dtype=torch.float32)

    def value_and_grad():
        return torch.autograd.grad(objective(theta_t), [theta_t["r1"]])

    breakdown = {
        "rebuild_ms": host_ms(torch, rebuild),
        "value_ms": host_ms(torch, lambda: objective(theta_t)),
        "value_and_grad_ms": host_ms(torch, value_and_grad),
    }
    from torch.profiler import ProfilerActivity, profile

    value_and_grad()
    torch.cuda.synchronize()
    start = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILED_STEPS):
            value_and_grad()
        torch.cuda.synchronize()
    wall_us = (time.perf_counter() - start) * 1e6
    # device-side events only: a CPU op's self device time repeats the
    # kernels it launched
    kernels = sorted(
        ((e.key, device_us(e)) for e in prof.key_averages()
         if e.device_type == torch.autograd.DeviceType.CUDA and device_us(e) > 0),
        key=lambda item: -item[1])
    busy_ms = sum(us for _, us in kernels) / PROFILED_STEPS / 1e3
    breakdown["profiled_device_ms_per_step"] = busy_ms
    breakdown["device_busy_share_of_step"] = busy_ms / breakdown["value_and_grad_ms"]
    breakdown["profiled_wall_ms_per_step"] = wall_us / PROFILED_STEPS / 1e3
    breakdown["top_device_kernels_ms_per_step"] = {
        name[:60]: us / PROFILED_STEPS / 1e3 for name, us in kernels[:6]}
    breakdown["ms_per_step"] = train_s / TRAIN_STEPS * 1e3
    log("training step breakdown (float32, 2**20 rays):", json.dumps(breakdown))
    rebuild_check(torch, np, compile_scene, fresh_ids, lambda th: build_singlet(th, comp, matl),
                  {"r1": 2.0}, device, "singlet")
    phase_seconds["training"] = time.perf_counter() - phase_start

    # 8. backward times on the condenser and the hetero row, float32 -------
    phase_start = time.perf_counter()
    saved = (ft.fused_trace.launches, fg.fused_bwd_loss.launches, fg.fused_bwd.launches)
    item = 4
    n, g = N_RAYS, GENERATIONS

    def narrow_bwd_case(scene, rays, sid, config, label):
        """K3's and K4's times, bounds and repeats on one scene; the inputs
        of the K1 trace they differentiate."""
        spec = scene.spec
        inputs = ft.kernel_inputs(scene.params, rays)
        records, masks, _ = ft.fused_trace(spec, config, *inputs)
        plan = fg.loss_plan(metrics.RmsSpotRadius(sid))
        scal = plan.row(plan.scalars(records, masks), torch.ones((), device=device))
        gen = torch.Generator(device=device).manual_seed(0)
        d_records = torch.randn(records.shape, generator=gen, device=device) * masks[:, None]
        d_fstate = torch.randn(inputs[0].shape, generator=gen, device=device)
        bwd_args = (spec, config, *inputs, records, masks)
        repeats = {}
        for name, fn in (("k3", lambda: fg.fused_bwd_loss(*bwd_args, scal, plan)),
                         ("k4", lambda: fg.fused_bwd(*bwd_args, d_records, d_fstate))):
            first, second = fn(), fn()
            repeats[name] = all(torch.equal(a, b) for a, b in zip(first, second))
        torch.cuda.reset_peak_memory_stats()
        out = {
            "k3_ms": cuda_ms(torch, lambda: fg.fused_bwd_loss(*bwd_args, scal, plan)),
            "k4_ms": cuda_ms(torch, lambda: fg.fused_bwd(*bwd_args, d_records, d_fstate)),
            "kernel_peak": torch.cuda.max_memory_allocated(),
            "k3_plain_ms": cuda_ms(torch, lambda: fg.fused_bwd_loss_plain(*bwd_args, scal, plan),
                                   repeats=3, warmup=1),
            "k4_plain_ms": cuda_ms(torch, lambda: fg.fused_bwd_plain(*bwd_args, d_records,
                                                                     d_fstate),
                                   repeats=3, warmup=1),
            "repeats_bit_identical": repeats,
        }
        run = fg.generations_ran(records, masks)  # (G, n): the generations each ray ran
        k3_bytes, k4_bytes, ran, skip_checks = narrow_bwd_bytes(
            records, masks, run, spec.n_leaves, inputs[3].shape[0], item)
        flops = ran * flops_per_ray_generation(spec, backward=True)
        out.update(bytes={"k3": k3_bytes, "k4": k4_bytes}, ran=ran, skip_checks=skip_checks,
                   k3_bound=bound(k3_bytes, flops), k4_bound=bound(k4_bytes, flops))
        log(f"backward times, {label} ({rays.n_rays} rays x {config.generation_limit} "
            f"generations, {ran} ray-generations run, {skip_checks} skip checks, float32, "
            f"median): K3 {out['k3_ms']:.4f} ms, K4 {out['k4_ms']:.4f} ms; plain K3 "
            f"{out['k3_plain_ms']:.2f} ms, plain K4 {out['k4_plain_ms']:.2f} ms; bounds K3 "
            f"{out['k3_bound'][0]:.4f} ms ({out['k3_bound'][1]}), K4 {out['k4_bound'][0]:.4f} ms "
            f"({out['k4_bound'][1]}); two launches bit-identical {json.dumps(repeats)}; kernel "
            f"peak memory {out['kernel_peak'] / 2**30:.3f} GiB on {card}")
        assert all(repeats.values()), (label, repeats)
        return out, (spec, records, masks, run, ran)

    scene, rays, sid = condenser_scene(torch.float32)
    cond, (spec, records, masks, run, ran) = narrow_bwd_case(scene, rays, sid, grad_config,
                                                             "condenser")
    k3_ms, k4_ms = cond["k3_ms"], cond["k4_ms"]
    k3_plain_ms, k4_plain_ms = cond["k3_plain_ms"], cond["k4_plain_ms"]
    k3_bound, k4_bound = cond["k3_bound"], cond["k4_bound"]
    params = {k: v.detach().clone().requires_grad_(True) for k, v in scene.params.items()}
    plain_value = metrics.RmsSpotRadius(sid)(plain_result(scene, params, rays))
    autograd_ms = cuda_ms(torch, lambda: torch.autograd.grad(
        plain_value, list(params.values()), retain_graph=True), repeats=3, warmup=1)
    log(f"plain autograd backward of fused_trace_plain on the condenser {autograd_ms:.2f} ms")
    # K1 writes every generation's records (zeros where a ray stopped)
    table_bytes = item * (22 * spec.n_leaves + 7 * len(spec.mat_kinds)) * 2
    k1_bytes = item * (15 * g * n + 2 * 13 * n) + g * n + table_bytes
    k1_bound = bound(k1_bytes, ran * flops_per_ray_generation(spec, backward=False))
    del scene, rays, params, plain_value, records, masks, run
    torch.cuda.empty_cache()

    with fresh_ids():
        row_parts = hetero_wall(comp, matl, n_elements=HETERO_ROW)
        row_scene = compile_scene(row_parts, device=device, dtype=torch.float32)
    assert ft.supports_fused(row_scene.spec) and row_scene.spec.n_leaves == 3 * HETERO_ROW + 1
    row_rays = hetero_row_rays(interop, device, torch.float32, N_RAYS)
    row, _ = narrow_bwd_case(
        row_scene, row_rays, float(row_scene.spec.leaf_ids[-1]),
        TraceConfig(generation_limit=HETERO_ROW_GENERATIONS, fixed_loop=True), "hetero row")
    ft.fused_trace.launches, fg.fused_bwd_loss.launches, fg.fused_bwd.launches = saved
    bwd_usage = ptxas_usage(ft.build_kernels()["fused_grad"][2], "fused_bwd_kernel")
    log("backward build (ptxas): " + json.dumps(bwd_usage))
    log("bounds: " + json.dumps({
        "fused_trace": {"bytes": k1_bytes, "ms": k1_bound[0], "by": k1_bound[1]},
        "fused_bwd_loss": {"bytes": cond["bytes"]["k3"], "ms": k3_bound[0], "by": k3_bound[1]},
        "fused_bwd": {"bytes": cond["bytes"]["k4"], "ms": k4_bound[0], "by": k4_bound[1]},
        "hetero_row": {"k3_bytes": row["bytes"]["k3"], "k3_ms": row["k3_bound"][0],
                       "k3_by": row["k3_bound"][1], "k4_bytes": row["bytes"]["k4"],
                       "k4_ms": row["k4_bound"][0], "k4_by": row["k4_bound"][1]},
        "flops_per_ray_generation": {"forward": flops_per_ray_generation(spec, False),
                                     "backward": flops_per_ray_generation(spec, True)},
    }))
    phase_seconds["backward_times"] = time.perf_counter() - phase_start
    del row_scene, row_rays
    torch.cuda.empty_cache()

    wide_kernels = wide_phases(torch, np, pyrayt, comp, matl, metrics, ft, fg, engine, TraceConfig,
                               fresh_ids, compile_scene, build_objective, optimize, device,
                               phase_seconds)
    wide_kernels.append(wide_fused_phase(
        torch, pyrayt, comp, metrics, ft, fg, engine, TraceConfig, fresh_ids, compile_scene,
        build_objective, optimize, device, phase_seconds, np))
    row_reduce_phase(torch, np, pyrayt, comp, metrics, ft, fg, TraceConfig, fresh_ids,
                     compile_scene, device, phase_seconds)
    render_phase(torch, np, comp, matl, ft, fresh_ids, device, phase_seconds)
    rank_launches = parallel_phase(torch, np, pyrayt, comp, matl, metrics, TraceConfig, fresh_ids,
                                   compile_scene, device, phase_seconds)
    log("phase seconds:", json.dumps(phase_seconds))

    def k_err(key):
        return max(r["max_abs_err"] for r in grad_reports[key].values())

    kernel_line = [
        {
            "name": "fused_trace",
            "route": "cuda",
            "source": "pyrayt_tpu_torch/csrc/fused_trace.cu",
            "replaces": "pyrayt_tpu/ops/fused_trace.py:343",
            "launches": launches,
            "max_abs_err": r32["max_abs_err"],
            "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": k1_bound[0],
            "bound_by": k1_bound[1],
            "library_ms": None,
        },
        {
            "name": "fused_bwd_loss",
            "route": "cuda",
            "source": "pyrayt_tpu_torch/csrc/fused_grad.cu",
            "replaces": "pyrayt_tpu/ops/fused_grad.py:127",
            "launches": train_launches["fused_bwd_loss"],
            "max_abs_err": k_err("k3_rms_float32"),
            "ms": k3_ms,
            "plain_ms": k3_plain_ms,
            "bound_ms": k3_bound[0],
            "bound_by": k3_bound[1],
            "library_ms": None,
        },
        {
            "name": "fused_bwd",
            "route": "cuda",
            "source": "pyrayt_tpu_torch/csrc/fused_grad.cu",
            "replaces": "pyrayt_tpu/ops/fused_grad.py:127",
            "launches": generic_launches["fused_bwd"],
            "max_abs_err": k_err("k4_generic_float32"),
            "ms": k4_ms,
            "plain_ms": k4_plain_ms,
            "bound_ms": k4_bound[0],
            "bound_by": k4_bound[1],
            "library_ms": None,
        },
    ] + wide_kernels
    for entry in kernel_line:  # the kernel's own time is its device time (phase 1b)
        t = device_times[entry["name"]]
        entry.update(ms=t["device_ms"], event_ms=t["event_ms"], host_ms=t["host_ms"])
        # phase 17's ranks, each path's counts read from 0 in its rank
        entry["rank_launches"] = rank_launches[entry["name"]]
        entry["launches"] += rank_launches[entry["name"]]
    log(json.dumps({"kernels": kernel_line}))
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": 1,
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(rank_main(sys.argv[1:]) if sys.argv[1:2] == ["--rank"] else main())

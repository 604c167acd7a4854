"""The backward kernels on CUDA, their wrappers, their plain PyTorch
versions and the autograd Functions around them: the narrow K3 (loss-fused)
and K4 (generic), the staged wide backward K5 (tail), K6 (group) and K7
(singles), and the monolithic wide backward K8.

The kernels (``csrc/fused_grad.cu``) replace the Pallas kernel built by
``pyrayt_tpu/ops/fused_grad.py:_make_bwd_kernel`` in its two modes and run
by ``_run_bwd``.  On a narrow scene the forward of both autograd Functions
(loss and trace mode) is the forward kernel K1 (ops/fused_trace.py): the
record buffer it writes holds every generation's input state, so the
backward saves nothing else.

* K4 (:func:`fused_bwd`) takes the cotangents of the records (G, 15, n)
  and of the final state (13, n) as buffers: any loss on the trace result
  can use it (:func:`build_fused_vjp_trace_fn`).
* K3 (:func:`fused_bwd_loss`) takes one row of loss scalars instead and
  builds each record cotangent per ray from the recognized loss's plan
  (:func:`loss_plan`: ``RmsSpotRadius``, ``FocusError``,
  ``SoftFocusError``); the final-state cotangent is zero
  (:func:`build_fused_value_and_grad_fn`).

Both return ``(d_objtx (S, 16), d_prim (S, 6), d_glass (M, 7), d_state0
(13, n))``: the cotangents of the kernel's inputs.  ``obj_tx`` is the
inverse of ``params["world"]``; the Functions chain ``d_objtx`` back to
``d_world`` through ``affine_inverse`` with autograd, outside the kernel.

Gradient contract (the JAX kernel's; tests/test_torch/test_torch_grad.py):

* exact, up to rounding, on every loss that reads only masked record rows
  (every metric), against autograd of the plain engine and ``jax.grad``
  of the JAX engine;
* a generation a ray did not run (K1 writes its records as zero) passes
  the state cotangent through unchanged: the stopped ray keeps its state;
* the homogeneous w rows of ``d_state0`` are zero (the JAX engine gives
  them a value; the JAX kernel gives zero);
* ``record_mask`` and ``generations_run`` are not differentiable.

On CPU tensors the wrappers run their plain versions, which rebuild every
generation's input state exactly as the kernel does and apply
``torch.autograd.grad`` to the plain engine's generation step.

Wide scenes (``ops.fused_trace.supports_fused_wide``) take the staged
backward (:func:`staged_bwd`, ``csrc/wide_grad.cu``), the counterpart of the
JAX package's ``_run_bwd_staged``.  The forward is the wide kernel K2 with
``save_fold``; per generation that ran, last first, K5 maps the carried and
record cotangents through the step after the fold, and K6 (per group) and
K7 (the single trees) map the hit distance's and normal's cotangents into
each ray's winning tree.  The JAX package's 256-leaf chunks and 8-tree
subchunks worked around the TPU compiler's limits and have no counterpart.

``TraceConfig(wide_grad="fused")`` takes the monolithic wide backward
instead (:func:`fused_bwd_wide`, ``csrc/wide_fused_grad.cu``), the
counterpart of the JAX package's ``_make_bwd_kernel_wide``: K2 without
``save_fold`` forward, then one launch that recomputes each generation's
fold per ray and runs the tail's and the winning tree's adjoints in one
thread.  It gives the staged backward's gradients up to rounding.  The wide
routes keep the contract above.
"""

from __future__ import annotations

import dataclasses
from functools import lru_cache
from typing import Callable, Tuple

import torch

from pyrayt_tpu_torch import materials as matl
from pyrayt_tpu_torch import tracing
from pyrayt_tpu_torch.analysis import metrics as _m
from pyrayt_tpu_torch.config import TraceConfig
from pyrayt_tpu_torch.core import primitives as prim_mod
from pyrayt_tpu_torch.core.intervals import eval_tree_intervals
from pyrayt_tpu_torch.core.operations import INF, _sum_rows, affine_inverse
from pyrayt_tpu_torch.ops import _cuda
from pyrayt_tpu_torch.ops import fused_trace as ft
from pyrayt_tpu_torch.scene.compile import SceneSpec
from pyrayt_tpu_torch.tracer import engine

__all__ = [
    "LossPlan",
    "loss_plan",
    "wide_grad_mode",
    "reduce_takes",
    "pick_fused_grad",
    "generations_ran",
    "fused_bwd",
    "fused_bwd_plain",
    "fused_bwd_loss",
    "fused_bwd_loss_plain",
    "fused_bwd_wide",
    "fused_bwd_wide_plain",
    "row_reduce",
    "row_reduce_plain",
    "build_fused_value_and_grad_fn",
    "build_fused_vjp_trace_fn",
    "fused_plan_value",
]

# record rows (engine record layout)
_R_SURF, _R_X0, _R_Y0 = 5, 6, 7
_R_Y1, _R_Z1 = 10, 11
_R_XT, _R_YT = 12, 13

# plan codes; keep equal to the Plan enum in csrc/adjoint_common.cuh
PLAN_RMS, PLAN_FOCUS, PLAN_SOFT_FOCUS = range(3)
# capacity of the kernel's scalar row; keep equal to kMaxScal
MAX_SCALARS = 16
# values per entry of the wide table reduce; keep equal to kGeo
GEO_VALUES = 18


# ---------------------------------------------------------------------------
# loss plans
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class LossPlan:
    """A recognized loss: ``scalars(records, masks) -> (K,)`` reduces the
    trace; ``value(scal)`` is the loss; the kernel's scalar row is
    ``scal ++ [g] ++ tail`` (``g`` the upstream cotangent, ``tail`` the
    descriptor's constants); ``drec(rec (15, n), mask (n,), row)`` is the
    record cotangent of one generation, the formulas the kernel runs.

    The same scalars over rays held apart (the ranks of a sharded
    objective): ``partials`` are rounds of float64 sums over rays, each
    ``fn(records, masks, sums) -> (P,)`` given ``sums``, the totals of the
    earlier rounds; sums of the same round add over any split of the rays.
    ``finish(sums)`` turns every round's totals into ``scalars``' values
    (float64)."""

    kind: int
    scalars: Callable
    value: Callable
    drec: Callable
    tail: Tuple[float, ...]
    partials: Tuple[Callable, ...]
    finish: Callable

    def row(self, scal, g):
        """The kernel's scalar row for upstream cotangent ``g``."""
        tail = torch.as_tensor(self.tail, dtype=scal.dtype, device=scal.device)
        return torch.cat((scal, g.reshape(1).to(scal.dtype), tail)).contiguous()


def _sum64(x):
    return torch.sum(x, dtype=torch.float64).reshape(1)


def _rows(rec, filled):
    out = torch.zeros_like(rec)
    for i, value in filled.items():
        out[i] = value
    return out


def _rms_plan(loss) -> LossPlan:
    sid = float(loss.surface_id)

    def scalars(records, masks):
        w = (masks & (records[:, _R_SURF, :] == sid)).to(records.dtype)
        W = torch.clamp(torch.sum(w), min=1.0)
        y = records[:, _R_Y1, :]
        z = records[:, _R_Z1, :]
        cy = torch.sum(y * w) / W
        cz = torch.sum(z * w) / W
        r2 = (y - cy) ** 2 + (z - cz) ** 2
        L = torch.sqrt(torch.sum(r2 * w) / W)
        return torch.stack([cy, cz, W, L])

    def drec(rec, mask, row):
        # dL/dy1_i = m_i (y1_i - cy) / (W L); the centroid terms cancel
        # (sum of m (y - cy) = 0).  L == 0 (all hits coincident) gives a
        # zero gradient where autograd's sqrt would give NaN.
        m = mask & (rec[_R_SURF] == row[5])
        L = row[3]
        safe = torch.where(L > 0, row[2] * L, 1.0)
        coef = torch.where(m & (L > 0), row[4] / safe, 0.0)
        return _rows(
            rec, {_R_Y1: coef * (rec[_R_Y1] - row[0]), _R_Z1: coef * (rec[_R_Z1] - row[1])}
        )

    # the centroid first, then the squares about it: one round of
    # [sum w, sum w y, sum w z, sum w (y^2 + z^2)] would cancel in float32
    def centroid_sums(records, masks, sums):
        del sums
        w = (masks & (records[:, _R_SURF, :] == sid)).to(records.dtype)
        return torch.cat((_sum64(w), _sum64(records[:, _R_Y1, :] * w),
                          _sum64(records[:, _R_Z1, :] * w)))

    def centroid(sums, dtype):
        W = torch.clamp(sums[0], min=1.0)
        return W, (sums[1] / W).to(dtype), (sums[2] / W).to(dtype)

    def square_sums(records, masks, sums):
        w = (masks & (records[:, _R_SURF, :] == sid)).to(records.dtype)
        _, cy, cz = centroid(sums, records.dtype)
        r2 = (records[:, _R_Y1, :] - cy) ** 2 + (records[:, _R_Z1, :] - cz) ** 2
        return _sum64(r2 * w)

    def finish(sums):
        W, cy, cz = centroid(sums, sums.dtype)
        return torch.stack([cy, cz, W, torch.sqrt(sums[3] / W)])

    # row: [cy, cz, W, L, g, surface_id]
    return LossPlan(PLAN_RMS, scalars, lambda scal: scal[3], drec, (sid,),
                    (centroid_sums, square_sums), finish)


def _focus_plan(loss) -> LossPlan:
    sid = float(loss.surface_id)
    target = float(loss.target_focus)
    min_tilt = float(loss.min_tilt)

    def terms(records, masks):
        """Each ray's weight and squared focus error."""
        yt = records[:, _R_YT, :]
        tilted = torch.abs(yt) > min_tilt
        w = (masks & (records[:, _R_SURF, :] == sid) & tilted).to(records.dtype)
        safe_yt = torch.where(tilted, yt, 1.0)
        t = records[:, _R_X0, :] - records[:, _R_XT, :] * records[:, _R_Y0, :] / safe_yt
        return w, (t - target) ** 2

    def scalars(records, masks):
        w, e2 = terms(records, masks)
        W = torch.clamp(torch.sum(w), min=1.0)
        return torch.stack([W, torch.sum(w * e2) / W])

    def sums(records, masks, done):
        del done
        w, e2 = terms(records, masks)
        return torch.cat((_sum64(w), _sum64(w * e2)))

    def drec(rec, mask, row):
        yt = rec[_R_YT]
        tilted = torch.abs(yt) > row[4]
        m = mask & (rec[_R_SURF] == row[3]) & tilted
        safe_yt = torch.where(tilted, yt, 1.0)
        t = rec[_R_X0] - rec[_R_XT] * rec[_R_Y0] / safe_yt
        base = torch.where(m, 2.0 * (t - row[5]) * row[2] / row[0], 0.0)
        return _rows(
            rec,
            {
                _R_X0: base,
                _R_XT: base * (-rec[_R_Y0] / safe_yt),
                _R_Y0: base * (-rec[_R_XT] / safe_yt),
                _R_YT: base * (rec[_R_XT] * rec[_R_Y0] / (safe_yt * safe_yt)),
            },
        )

    # row: [W, value, g, surface_id, min_tilt, target]
    return LossPlan(PLAN_FOCUS, scalars, lambda scal: scal[1], drec, (sid, min_tilt, target),
                    (sums,), lambda s: _mean_finish(s, 1.0))


def _mean_finish(sums, floor):
    """[W, sum w e^2 / W] from [sum w, sum w e^2], W floored."""
    W = torch.clamp(sums[0], min=floor)
    return torch.stack([W, sums[1] / W])


def _sprime(u):
    return torch.where((u > 0) & (u < 1), 6.0 * u * (1.0 - u), 0.0)


def _soft_focus_plan(loss) -> LossPlan:
    """soft_focus_error's cotangent: the t-chain terms of the focus plan
    plus the weight-derivative terms (w depends on y1, z1 and y_tilt
    through C1 windows; d/dw_i of a weighted mean is (e_i^2 - L) / W)."""
    sid = float(loss.surface_id)
    target = float(loss.target_focus)
    hy, hz = (float(v) for v in loss.half_widths)
    ramp = float(loss.ramp)
    t0, t1 = (float(v) for v in loss.tilt_ramp)

    def weights(surf, mask, y1, z1, yt):
        m = mask & (surf == sid)
        wy = _m.smoothstep((hy - torch.abs(y1)) / ramp)
        wz = _m.smoothstep((hz - torch.abs(z1)) / ramp)
        wt = _m.smoothstep((torch.abs(yt) - t0) / (t1 - t0))
        return m, wy, wz, wt, torch.where(m, wy * wz, 0.0) * wt

    def terms(records, masks):
        """Each ray's weight and squared focus error."""
        yt = records[:, _R_YT, :]
        surf, y1, z1 = records[:, _R_SURF, :], records[:, _R_Y1, :], records[:, _R_Z1, :]
        w = weights(surf, masks, y1, z1, yt)[4]
        safe_yt = torch.where(torch.abs(yt) > t0, yt, t0)
        t = records[:, _R_X0, :] - records[:, _R_XT, :] * records[:, _R_Y0, :] / safe_yt
        return w, (t - target) ** 2

    def scalars(records, masks):
        w, e2 = terms(records, masks)
        W = torch.clamp(torch.sum(w), min=1e-12)
        return torch.stack([W, torch.sum(w * e2) / W])

    def sums(records, masks, done):
        del done
        w, e2 = terms(records, masks)
        return torch.cat((_sum64(w), _sum64(w * e2)))

    def drec(rec, mask, row):
        W, L, g = row[0], row[1], row[2]
        y1, z1, yt = rec[_R_Y1], rec[_R_Z1], rec[_R_YT]
        m, wy, wz, wt, w = weights(rec[_R_SURF], mask, y1, z1, yt)
        tilted = torch.abs(yt) > t0
        safe_yt = torch.where(tilted, yt, t0)
        t = rec[_R_X0] - rec[_R_XT] * rec[_R_Y0] / safe_yt
        e = t - target
        base = 2.0 * e * w / W * g  # t-chain coefficient
        dE = (e * e - L) / W * g  # d loss / d w_i
        dwy = _sprime((hy - torch.abs(y1)) / ramp) * (-torch.sign(y1) / ramp)
        dwz = _sprime((hz - torch.abs(z1)) / ramp) * (-torch.sign(z1) / ramp)
        dwt = _sprime((torch.abs(yt) - t0) / (t1 - t0)) * (torch.sign(yt) / (t1 - t0))
        mf = m.to(rec.dtype)
        # dt/dyt is zero where safe_yt is the clamped constant
        t_yt = torch.where(tilted, base * rec[_R_XT] * rec[_R_Y0] / (safe_yt * safe_yt), 0.0)
        return _rows(
            rec,
            {
                _R_X0: base,
                _R_XT: base * (-rec[_R_Y0] / safe_yt),
                _R_Y0: base * (-rec[_R_XT] / safe_yt),
                _R_YT: t_yt + mf * wy * wz * dwt * dE,
                _R_Y1: mf * dwy * wz * wt * dE,
                _R_Z1: mf * wy * dwz * wt * dE,
            },
        )

    # row: [W, value, g, surface_id, target, hy, hz, ramp, t0, t1]
    tail = (sid, target, hy, hz, ramp, t0, t1)
    return LossPlan(PLAN_SOFT_FOCUS, scalars, lambda scal: scal[1], drec, tail, (sums,),
                    lambda s: _mean_finish(s, 1e-12))


def loss_plan(loss):
    """The loss-fused plan of a recognized loss descriptor, or None.

    Recognized: :class:`~pyrayt_tpu_torch.analysis.metrics.RmsSpotRadius`,
    :class:`~.FocusError` and :class:`~.SoftFocusError` with a detector
    ``surface_id``.  Any other loss takes the generic K4 path."""
    if isinstance(loss, _m.RmsSpotRadius) and loss.surface_id is not None:
        return _rms_plan(loss)
    if isinstance(loss, _m.FocusError) and loss.surface_id is not None:
        return _focus_plan(loss)
    if isinstance(loss, _m.SoftFocusError) and loss.surface_id is not None:
        return _soft_focus_plan(loss)
    return None


def wide_grad_mode(spec: SceneSpec, config: TraceConfig) -> str:
    """Backward-path selection: ``"narrow"`` (K3/K4) for scenes of at most
    32 leaves; for wide scenes ``"staged"`` (K5-K7) with ``wide_grad`` None
    or ``"staged"``, as in the JAX package, and ``"fused"`` (K8) with
    ``wide_grad="fused"``.  Unknown modes raise ValueError.

    The JAX package caps ``"fused"`` at 300 leaves, where its monolithic
    kernel crashed the TPU compiler.  K8 has no cap of its own: like K2 it
    keeps only the program, the single trees' tables (at most 32 leaves,
    :func:`~pyrayt_tpu_torch.ops.fused_trace.supports_fused_wide`) and the
    glass rows in shared memory, plus 7.8 KB of staging, and reads the
    groups' tables from global memory.  What grows is device memory, 18
    values per ray and generation for its table sums, whose counting-sort
    reduce does work in proportion to generations x rays + leaves (at most
    51,200 leaves and 2**31 - 1 entries, ``csrc/row_reduce.cuh``;
    :func:`reduce_takes`)."""
    if ft.supports_fused(spec):
        return "narrow"
    mode = config.wide_grad
    if mode is None or mode == "staged":
        return "staged"
    if mode == "fused":
        return "fused"
    raise ValueError(f"unknown wide_grad mode {mode!r}")


# the table reduce's limits (csrc/row_reduce.cuh: kMaxReduceRows, int32
# entry indices)
MAX_REDUCE_ROWS = 51200
MAX_REDUCE_ENTRIES = 2**31 - 1


def reduce_takes(spec: SceneSpec, config: TraceConfig, n_rays: int) -> bool:
    """Whether the table reduce of the scene's wide backward takes a trace
    of ``n_rays`` rays and ``config.generation_limit`` generations on the
    route :func:`wide_grad_mode` picks: the staged route sums each group's
    leaves (T x L rows) and the singles' over ``n_rays`` entries per
    launch, K8 every leaf over generations x rays entries in one launch;
    the reduce takes at most ``MAX_REDUCE_ROWS`` rows and
    ``MAX_REDUCE_ENTRIES`` entries.  A narrow scene has no reduce (True).
    Reads the spec's plan only, so it decides before anything is built."""
    mode = wide_grad_mode(spec, config)
    if mode == "narrow":
        return True
    if mode == "fused":
        rows, entries = spec.n_leaves, config.generation_limit * n_rays
    else:
        plan = ft.wide_fold_plan(spec)
        rows = max([info["T"] * info["L"] for kind, _, info in plan if kind == "group"]
                   + [sum(len(info["slots"]) for kind, _, info in plan if kind == "single")])
        entries = n_rays
    return rows <= MAX_REDUCE_ROWS and entries <= MAX_REDUCE_ENTRIES


def pick_fused_grad(spec: SceneSpec, config: TraceConfig, device, n_rays: int) -> bool:
    """The gradient's dispatch rule (``analysis.build_objective``):
    ``ops.fused_trace.pick_fused``, and for a wide scene also
    :func:`reduce_takes`: a scene past the reduce's limits differentiates
    the plain engine, as the JAX package routes scenes past its kernels'
    cap to its XLA engine.  ``use_fused=True`` raises there."""
    if not ft.pick_fused(spec, config, device):
        return False
    if reduce_takes(spec, config, n_rays):
        return True
    if config.use_fused is True:
        raise ValueError(
            f"use_fused=True, but the backward's table reduce takes at most {MAX_REDUCE_ROWS} "
            f"rows and {MAX_REDUCE_ENTRIES} entries")
    return False


# ---------------------------------------------------------------------------
# the plain versions
# ---------------------------------------------------------------------------


def generations_ran(records, masks):
    """(G, n) bool: which generations each ray ran.  Every ray runs
    generation 0; generation g > 0 ran iff mask[g - 1] is set and the
    record's tilt rows (the input direction of g, zero for a generation the
    ray did not run) are nonzero -- the forward kernel's own rule."""
    ran = torch.zeros_like(masks)
    if masks.shape[0]:
        ran[0] = True
    tilt_set = (records[1:, 12:15] != 0).any(dim=1)
    ran[1:] = masks[:-1] & tilt_set
    return ran


def _input_state(g, state0, records, idx):
    """The input state (13, k) of generation g for rays ``idx``: the true
    initial state at g = 0, else the record's rows."""
    if g == 0:
        return state0[:, idx]
    rec = records[g][:, idx]
    ones = torch.ones_like(rec[:1])
    return torch.cat((rec[6:9], ones, rec[12:15], 0 * ones, rec[0:5]))


def _sweep(spec, config, state0, obj_tx, prim, glass, records, masks, d_records, d_fstate):
    """The reverse sweep of the plain versions: autograd of the plain
    engine's generation step, generation by generation, last first."""
    s = spec.n_leaves
    tables = {
        "obj_tx": obj_tx.detach().reshape(s, 4, 4).requires_grad_(True),
        "prim": prim.detach().requires_grad_(True),
        "glass": glass.detach().requires_grad_(True),
    }
    leaves = list(tables.values())
    d_params = [torch.zeros_like(t) for t in leaves]
    bar = d_fstate.clone()
    bar[3] = 0.0
    bar[7] = 0.0
    ran = generations_ran(records, masks)
    for g in reversed(range(records.shape[0])):
        idx = ran[g].nonzero().squeeze(1)
        if idx.numel() == 0:
            continue
        x = _input_state(g, state0, records, idx).detach().requires_grad_(True)
        with torch.enable_grad():
            alive = torch.ones(idx.numel(), dtype=torch.bool, device=x.device)
            (nxt, _), record, _ = engine.generation_step(
                spec, None, config, tables, (ft.rays_from_state(x), alive)
            )
            out = torch.cat((nxt.positions, nxt.directions, nxt.metadata))
            grads = torch.autograd.grad(
                (out, record),
                [x] + leaves,
                (bar[:, idx], d_records[g][:, idx]),
                allow_unused=True,
            )
        d_x = grads[0]
        d_x[3] = 0.0  # the w rows are constants (the kernel contract)
        d_x[7] = 0.0
        bar[:, idx] = d_x
        for acc, grad in zip(d_params, grads[1:]):
            if grad is not None:
                acc += grad
    d_objtx, d_prim, d_glass = d_params
    return d_objtx.reshape(s, 16), d_prim, d_glass, bar


def fused_bwd_plain(spec, config, state0, obj_tx, prim, glass, records, masks, d_records, d_fstate):
    """Plain PyTorch version of :func:`fused_bwd` (same signature and
    outputs): the reverse sweep with autograd of the plain engine's step."""
    _check(spec, config, state0, obj_tx, prim, glass, records, masks, d_records, d_fstate)
    return _sweep(spec, config, state0, obj_tx, prim, glass, records, masks, d_records, d_fstate)


def fused_bwd_loss_plain(spec, config, state0, obj_tx, prim, glass, records, masks, scal, plan):
    """Plain PyTorch version of :func:`fused_bwd_loss`: the plan's record
    cotangent per generation, then the sweep of :func:`fused_bwd_plain`
    with a zero final-state cotangent."""
    _check(spec, config, state0, obj_tx, prim, glass, records, masks, scal=scal)
    d_records = torch.stack(
        [plan.drec(records[g], masks[g], scal) for g in range(records.shape[0])]
    )
    d_fstate = torch.zeros_like(state0)
    return _sweep(spec, config, state0, obj_tx, prim, glass, records, masks, d_records, d_fstate)


# ---------------------------------------------------------------------------
# the wrappers
# ---------------------------------------------------------------------------


def _check(spec, config, state0, obj_tx, prim, glass, records, masks, d_records=None,
           d_fstate=None, scal=None):
    ft.check_inputs(spec, state0, obj_tx, prim, glass)
    n, g = state0.shape[1], config.generation_limit
    expected = [(records, (g, engine.N_RECORD_COLS, n), state0.dtype), (masks, (g, n), torch.bool)]
    if d_records is not None:
        expected += [(d_records, (g, engine.N_RECORD_COLS, n), state0.dtype),
                     (d_fstate, (13, n), state0.dtype)]
    if scal is not None:
        if scal.ndim != 1 or scal.shape[0] > MAX_SCALARS:
            raise ValueError(f"the scalar row must be 1-D with at most {MAX_SCALARS} values")
        expected.append((scal, tuple(scal.shape), state0.dtype))
    for t, shape, dtype in expected:
        if tuple(t.shape) != shape:
            raise ValueError(f"expected shape {shape}, got {tuple(t.shape)}")
        if t.dtype != dtype or t.device != state0.device:
            raise ValueError(f"expected {dtype} on {state0.device}, got {t.dtype} on {t.device}")
        if not t.is_contiguous():
            raise ValueError("the backward's inputs must be contiguous")


def _launch(spec, config, state0, obj_tx, prim, glass, records, masks, d_records, d_fstate,
            plan, scal):
    """Launch K3 (``plan`` given) or K4 and return its four outputs."""
    device, dtype = state0.device, state0.dtype
    n, s, m = state0.shape[1], spec.n_leaves, glass.shape[0]
    d_state0 = torch.empty_like(state0)
    d_objtx = torch.empty((s, 16), dtype=dtype, device=device)
    d_prim = torch.empty((s, 6), dtype=dtype, device=device)
    d_glass = torch.empty((m, matl.N_GLASS_COEFFS), dtype=dtype, device=device)
    if n == 0:
        return d_objtx.zero_(), d_prim.zero_(), d_glass.zero_(), d_state0
    blocks = -(-n // _cuda.library("fused_grad").pyrayt_bwd_block_threads())  # the kernel's grid
    n_entries = 22 * s + matl.N_GLASS_COEFFS * m
    partials = torch.empty((n_entries, blocks), dtype=torch.float64, device=device)
    program = ft.device_program(spec, device)
    if plan is None:
        export, plan_kind, n_scal = "pyrayt_fused_bwd", -1, 0
        scal = records  # unused by K4
    else:
        export, plan_kind, n_scal = "pyrayt_fused_bwd_loss", plan.kind, scal.shape[0]
        d_records = d_fstate = records  # unused by K3
    _cuda.call("fused_grad", export, dtype, device,
               state0, n, config.generation_limit, obj_tx, prim, glass, program, program.numel(),
               s, m, records, masks, d_records, d_fstate, plan_kind, scal, n_scal,
               config.ray_offset, config.world_index, config.intensity_threshold,
               int(config.apply_intensity_threshold),
               d_state0, partials, d_objtx, d_prim, d_glass)
    return d_objtx, d_prim, d_glass, d_state0


def _device_check(state0):
    if state0.device.type != "cuda":
        raise ValueError(f"the kernel runs on CUDA tensors, got {state0.device}")


def fused_bwd(spec, config, state0, obj_tx, prim, glass, records, masks, d_records, d_fstate):
    """K4: the cotangents ``(d_objtx (S, 16), d_prim (S, 6), d_glass (M, 7),
    d_state0 (13, n))`` of a forward trace (``records``, ``masks`` from
    :func:`~pyrayt_tpu_torch.ops.fused_trace.fused_trace` on the same
    inputs), given the cotangents of its records (G, 15, n) and final state
    (13, n).  CUDA tensors launch the kernel (counted in
    ``fused_bwd.launches``); CPU tensors run :func:`fused_bwd_plain`."""
    with tracing.span("ops.fused_bwd"):
        if state0.device.type == "cpu":
            return fused_bwd_plain(
                spec, config, state0, obj_tx, prim, glass, records, masks, d_records, d_fstate
            )
        _device_check(state0)
        _check(spec, config, state0, obj_tx, prim, glass, records, masks, d_records, d_fstate)
        out = _launch(spec, config, state0, obj_tx, prim, glass, records, masks, d_records,
                      d_fstate, None, None)
        fused_bwd.launches += 1
        return out


fused_bwd.launches = 0


def fused_bwd_loss(spec, config, state0, obj_tx, prim, glass, records, masks, scal, plan):
    """K3: as :func:`fused_bwd`, with the record cotangents built per ray
    from ``plan`` (:func:`loss_plan`) and its scalar row ``scal``
    (``plan.row``), and a zero final-state cotangent.  CUDA tensors launch
    the kernel (counted in ``fused_bwd_loss.launches``); CPU tensors run
    :func:`fused_bwd_loss_plain`."""
    with tracing.span("ops.fused_bwd_loss"):
        if state0.device.type == "cpu":
            return fused_bwd_loss_plain(
                spec, config, state0, obj_tx, prim, glass, records, masks, scal, plan
            )
        _device_check(state0)
        _check(spec, config, state0, obj_tx, prim, glass, records, masks, scal=scal)
        out = _launch(spec, config, state0, obj_tx, prim, glass, records, masks, None, None,
                      plan, scal)
        fused_bwd_loss.launches += 1
        return out


fused_bwd_loss.launches = 0


# ---------------------------------------------------------------------------
# the staged wide backward (K5 tail, K6 group, K7 singles)
# ---------------------------------------------------------------------------


def _carry_rows(x):
    """The 11 carried rows of a 13-row state: p3, v3, gen, inten, wav,
    index, id (the homogeneous w rows are constants)."""
    return torch.cat((x[0:3], x[4:7], x[8:13]))


def _wide_input_state(state0, rec, pmask):
    """Generation g's input state (13, n) and which rays ran it: the true
    initial state at g = 0 (``pmask`` None), else the record's rows, run
    where ``pmask`` (mask[g-1]) is set and the tilt rows are nonzero."""
    if pmask is None:
        return state0, torch.ones(state0.shape[1], dtype=torch.bool, device=state0.device)
    ones = torch.ones_like(rec[:1])
    x = torch.cat((rec[6:9], ones, rec[12:15], 0 * ones, rec[0:5]))
    return x, pmask & (rec[12:15] != 0).any(dim=0)


def staged_tail_plain(spec, config, state0, rec, mask, pmask, fold5, glass, carry_bar,
                      d_rec=None, scal=None, plan=None):
    """Plain PyTorch version of :func:`staged_tail`: autograd of
    ``ops.fused_trace.wide_tail`` on the rays that ran the generation; the
    others pass ``carry_bar`` through."""
    x, ran = _wide_input_state(state0, rec, pmask)
    drec = d_rec if plan is None else plan.drec(rec, mask, scal)
    n = rec.shape[1]
    buf = torch.zeros((10, n), dtype=rec.dtype, device=rec.device)
    buf[0:3], buf[3:6] = x[0:3], x[4:7]
    dcarry = carry_bar.clone()
    d_glass = torch.zeros_like(glass)
    idx = ran.nonzero().squeeze(1)
    if idx.numel() == 0:
        return buf, dcarry, d_glass
    xi = x[:, idx].detach().requires_grad_(True)
    bd = fold5[0, idx].detach().requires_grad_(True)
    bn = fold5[1:4, idx].detach().requires_grad_(True)
    gl = glass.detach().requires_grad_(True)
    with torch.enable_grad():
        alive = torch.ones(idx.numel(), dtype=torch.bool, device=rec.device)
        normals = torch.cat((bn, torch.zeros_like(bn[:1])))
        nxt, record, _ = ft.wide_tail(spec, config, gl, bd, normals, fold5[4, idx], rec[5, idx],
                                      xi, alive)
        grads = torch.autograd.grad(
            (_carry_rows(nxt), record), [bd, bn, gl, xi],
            (carry_bar[:, idx], drec[:, idx]), allow_unused=True,
        )
    zero = torch.zeros_like
    d_bd, d_bn, d_gl, d_x = (z if gr is None else gr for gr, z in zip(
        grads, (zero(bd), zero(bn), zero(gl), zero(xi))))
    buf[6, idx] = d_bd
    buf[7:10, idx] = d_bn
    dcarry[:, idx] = _carry_rows(d_x)
    return buf, dcarry, d_gl


def _tree_eval(template, fast, types_pos, needs_pos, mats, prims, scales, p3, v3):
    """One tree's nearest positive hit and its winner's world normal (the
    JAX package's ``_wide_tree_eval``): ``(d_t (k,), n3 (3, k))``.
    ``mats[j]`` / ``prims[j]`` / ``scales[j]`` are leaf position j's
    object transform (4, 4) or (k, 4, 4), params (P,) or (k, P) and normal
    scale; differentiable in all of them and in ``p3``, ``v3``."""
    lo3s, ld3s, hits, params = [], [], [], []
    for j, type_code in enumerate(types_pos):
        m = mats[j]
        lo3 = [m[..., i, 0] * p3[0] + m[..., i, 1] * p3[1] + m[..., i, 2] * p3[2] + m[..., i, 3]
               for i in range(3)]
        ld3 = [m[..., i, 0] * v3[0] + m[..., i, 1] * v3[1] + m[..., i, 2] * v3[2]
               for i in range(3)]
        pr = [prims[j][..., i] for i in range(prims[j].shape[-1])]
        local = torch.stack((torch.stack(lo3), torch.stack(ld3)))
        pair = prim_mod.leaf_intersect(type_code, local, pr)
        hits.append(torch.stack((torch.minimum(pair[0], pair[1]), torch.maximum(pair[0], pair[1]))))
        lo3s.append(lo3)
        ld3s.append(ld3)
        params.append(pr)
    k = p3.shape[1]
    if fast:
        intervals = []
        for j, h in enumerate(hits):
            ids = torch.full((k,), j, dtype=torch.int32, device=p3.device)
            intervals.append((h[0], h[1], ids, ids))
        cands = []
        for lo, hi, lo_id, hi_id in eval_tree_intervals(template, intervals):
            cands += [(lo, lo_id), (hi, hi_id)]
    else:
        shape_hits, shape_ids = engine._eval_tree(template, hits)
        cands = [(shape_hits[r], shape_ids[r]) for r in range(shape_hits.shape[0])]
    d_t = torch.full((k,), INF, dtype=p3.dtype, device=p3.device)
    pos_t = torch.full((k,), -1, dtype=torch.int32, device=p3.device)
    for cand, pos in cands:
        cand = torch.where(cand > 0, cand, INF)
        new_min = cand < d_t
        d_t, pos_t = torch.where(new_min, cand, d_t), torch.where(new_min, pos, pos_t)
    d_safe = torch.where(torch.isinf(d_t), 0.0, d_t)
    n3 = torch.zeros((3, k), dtype=p3.dtype, device=p3.device)
    for j, type_code in enumerate(types_pos):
        if not needs_pos[j]:
            continue
        m = mats[j]
        local_hit = [o + d_safe * d for o, d in zip(lo3s[j], ld3s[j])]
        ln3 = prim_mod.leaf_normal_raw3(type_code, local_hit, params[j])
        wn = torch.stack([m[..., 0, i] * ln3[0] + m[..., 1, i] * ln3[1] + m[..., 2, i] * ln3[2]
                          for i in range(3)])
        sq = _sum_rows(wn * wn)
        zero = sq == 0
        wn = torch.where(zero, wn, wn / torch.sqrt(torch.where(zero, 1.0, sq)))
        n3 = torch.where(pos_t == j, wn * scales[j], n3)
    return d_t, n3


def _fold_bwd_plain(spec, entries, buf, obj_tx, prim):
    """Autograd of :func:`_tree_eval` of each ray's winning tree among
    ``entries`` [(indices (k,) of the rays it won, their slot rows or None,
    tables_fn(m44, prim, rows) -> (mats, prims, scales), template, fast,
    types_pos, needs_pos)]: ``(d_objtx (S, 16), d_prim (S, 6), dpv (6,
    n))``."""
    s_count = spec.n_leaves
    ot = obj_tx.detach().requires_grad_(True)
    pt = prim.detach().requires_grad_(True)
    d_obj, d_prim = torch.zeros_like(obj_tx), torch.zeros_like(prim)
    dpv = torch.zeros((6, buf.shape[1]), dtype=buf.dtype, device=buf.device)
    for idx, rows, tables_fn, template, fast, types_pos, needs_pos in entries:
        if idx.numel() == 0:
            continue
        p3 = buf[0:3, idx].detach().requires_grad_(True)
        v3 = buf[3:6, idx].detach().requires_grad_(True)
        with torch.enable_grad():
            mats, prims, scales = tables_fn(ot.reshape(s_count, 4, 4), pt, rows)
            d_t, n3 = _tree_eval(template, fast, types_pos, needs_pos, mats, prims, scales, p3, v3)
            # an absorber-only tree's normal is a constant zero
            outs = [(d_t, buf[6, idx])] + ([(n3, buf[7:10, idx])] if n3.requires_grad else [])
            grads = torch.autograd.grad([o for o, _ in outs], [ot, pt, p3, v3],
                                        [c for _, c in outs], allow_unused=True)
        for acc, gr in zip((d_obj, d_prim), grads[:2]):
            if gr is not None:
                acc += gr
        dpv[0:3, idx] = grads[2] if grads[2] is not None else 0.0
        dpv[3:6, idx] = grads[3] if grads[3] is not None else 0.0
    return d_obj, d_prim, dpv


def _group_entry(spec, group_index):
    for kind, idx, info in ft.wide_fold_plan(spec):
        if kind == "group" and idx == group_index:
            return info
    raise ValueError(f"the scene has no group {group_index}")


def staged_group_plain(spec, group_index, buf, win, obj_tx, prim, slots):
    """Plain PyTorch version of :func:`staged_group`: per ray whose win code
    lies in the group's range, autograd of the winning tree's evaluation
    (its leaves read through the sorted slot vector)."""
    info = _group_entry(spec, group_index)
    t_count, l_count, off = info["T"], info["L"], info["off"]
    t = win.long() - info["code_base"]
    idx = ((t >= 0) & (t < t_count)).nonzero().squeeze(1)
    rows = slots[off:off + t_count * l_count].long().reshape(t_count, l_count)[t[idx]]
    scale = torch.as_tensor(spec.leaf_normal_scale, dtype=buf.dtype, device=buf.device)

    def tables(m44, pr, rows):
        return ([m44[rows[:, j]] for j in range(l_count)], [pr[rows[:, j]] for j in range(l_count)],
                [scale[rows[:, j]] for j in range(l_count)])

    entry = (idx, rows, tables, info["template"], True, info["types_pos"], info["needs_pos"])
    return _fold_bwd_plain(spec, [entry], buf, obj_tx, prim)


def staged_singles_plain(spec, buf, win, obj_tx, prim):
    """Plain PyTorch version of :func:`staged_singles`: as
    :func:`staged_group_plain` for the trees outside the groups, whose
    codes and slots are static."""
    entries = []
    for kind, _, info in ft.wide_fold_plan(spec):
        if kind != "single":
            continue
        slots_j = info["slots"]

        def tables(m44, pr, rows, slots_j=slots_j, info=info):
            return ([m44[s] for s in slots_j], [pr[s] for s in slots_j],
                    list(info["scale_pos"]))

        entries.append(((win == info["code"]).nonzero().squeeze(1), None, tables, info["template"],
                        info["fast"], info["types_pos"], info["needs_pos"]))
    return _fold_bwd_plain(spec, entries, buf, obj_tx, prim)


def _check_rows(tensors, like):
    for name, t, rows in tensors:
        if t is None:
            continue
        if t.device != like.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {like.device}")
        if t.dtype != (torch.bool if name in ("mask", "pmask") else like.dtype):
            raise ValueError(f"{name} has dtype {t.dtype}")
        shape = (rows, like.shape[-1]) if rows else (like.shape[-1],)
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: expected shape {shape}, got {tuple(t.shape)}")


def staged_tail(spec, config, state0, rec, mask, pmask, fold5, glass, carry_bar,
                d_rec=None, scal=None, plan=None):
    """K5: one generation's adjoint of the wide tail
    (``ops.fused_trace.wide_tail``).  ``rec`` (15, n), ``mask`` (n,) and
    ``fold5`` (5, n) are generation g's records, mask and fold; ``pmask``
    is mask[g-1] (None at g = 0, where the input state is ``state0``);
    ``carry_bar`` (11, n) is the cotangent of the generation's output
    state (p3, v3, gen, inten, wav, index, id).  The record cotangent is
    ``d_rec`` (15, n), or ``plan.drec`` of the loss plan's scalar row
    ``scal``.

    Returns ``(buf (10, n), dcarry (11, n), d_glass (M, 7))``: ``buf`` =
    [p3, v3, d_best_d, d_best_n] (the input of K6/K7), ``dcarry`` the
    cotangent of the input state's carried rows.  A ray that did not run
    generation g (``generations_ran``) passes ``carry_bar`` through.  CUDA
    tensors launch the kernel (``staged_tail.launches``); CPU tensors run
    :func:`staged_tail_plain`."""
    with tracing.span("ops.staged_tail"):
        if state0.device.type == "cpu":
            return staged_tail_plain(spec, config, state0, rec, mask, pmask, fold5, glass,
                                     carry_bar, d_rec, scal, plan)
        _device_check(state0)
        _check_rows([("rec", rec, 15), ("mask", mask, 0), ("pmask", pmask, 0), ("fold5", fold5, 5),
                     ("carry_bar", carry_bar, 11), ("d_rec", d_rec, 15)], state0)
        if plan is not None and (scal.ndim != 1 or scal.shape[0] > MAX_SCALARS):
            raise ValueError(f"the scalar row must be 1-D with at most {MAX_SCALARS} values")
        n, m = state0.shape[1], glass.shape[0]
        kw = dict(dtype=state0.dtype, device=state0.device)
        buf = torch.empty((10, n), **kw)
        dcarry = torch.empty((11, n), **kw)
        d_glass = torch.empty((m, matl.N_GLASS_COEFFS), **kw)
        blocks = -(-n // _cuda.library("wide_grad").pyrayt_staged_block_threads())
        partials = torch.empty((max(1, m * matl.N_GLASS_COEFFS), blocks), dtype=torch.float64,
                               device=state0.device)
        program = ft.device_wide_program(spec, state0.device)
        _cuda.call("wide_grad", "pyrayt_staged_tail", state0.dtype, state0.device,
                   state0, n, rec, mask, pmask, fold5, glass, program, program.numel(), m,
                   d_rec if plan is None else None, -1 if plan is None else plan.kind,
                   scal if plan is not None else None, 0 if plan is None else scal.shape[0],
                   carry_bar, config.ray_offset, config.world_index, config.intensity_threshold,
                   int(config.apply_intensity_threshold), buf, dcarry, partials, d_glass)
        staged_tail.launches += 1
        return buf, dcarry, d_glass


staged_tail.launches = 0


def _reduce_table(shape, dtype, device):
    """The reduce table the wide backward kernels fill: ``keys`` (shape)
    int32, one reduce row per entry or -1, and ``vals`` (shape + (18,)),
    each entry's 18 values contiguous (rows 0-2 of its leaf's transform,
    its 6 params), written only where the key is a row."""
    return (torch.empty(shape, dtype=torch.int32, device=device),
            torch.empty(tuple(shape) + (GEO_VALUES,), dtype=dtype, device=device))


def _reduce_scratch(scratch_bytes, n, rows, device):
    """The reduce's scratch for ``n`` entries and ``rows`` rows, sized by
    the library's helper (``scratch_bytes``, -1 past the reduce's limits)."""
    size = scratch_bytes(n, rows)
    if size < 0:
        raise ValueError(f"the table reduce takes at most {MAX_REDUCE_ROWS} rows (kMaxReduceRows) "
                         f"and 2**31 - 1 entries, got {rows} rows and {n} entries")
    return torch.empty((size,), dtype=torch.uint8, device=device)


def _fold_launch(spec, group, buf, win, obj_tx, prim, slots, reduce_slots):
    _check_rows([("buf", buf, 10)], buf)
    if win.dtype != torch.int32 or win.device != buf.device or tuple(win.shape) != (buf.shape[1],):
        raise ValueError("win must be (n,) int32 on the buffer's device")
    n, s_count = buf.shape[1], spec.n_leaves
    kw = dict(dtype=buf.dtype, device=buf.device)
    dpv = torch.empty((6, n), **kw)
    keys, vals = _reduce_table((n,), buf.dtype, buf.device)
    d_obj = torch.zeros((s_count, 16), **kw)
    d_prim = torch.zeros((s_count, 6), **kw)
    rows = reduce_slots.numel()
    scratch = _reduce_scratch(_cuda.library("wide_grad").pyrayt_staged_reduce_scratch, n, rows,
                              buf.device)
    program = ft.device_wide_program(spec, buf.device)
    _cuda.call("wide_grad", "pyrayt_staged_fold", buf.dtype, buf.device,
               n, buf, win, obj_tx, prim, program, *ft.wide_program_sizes(spec), slots, group,
               dpv, keys, vals, d_obj, d_prim, reduce_slots, rows, scratch)
    return d_obj, d_prim, dpv


def staged_group(spec, group_index, buf, win, obj_tx, prim, slots):
    """K6: the winner-masked adjoint of one group's tree evaluation.  Each
    ray whose win code (``win``, (n,) int32) lies in group
    ``group_index``'s range differentiates its winning tree (read through
    the sorted slot vector ``slots``) with the cotangents ``buf[6:10]`` of
    its hit distance and normal.  Returns ``(d_objtx (S, 16), d_prim (S,
    6), dpv (6, n))``: the table cotangents summed over rays (only the
    group's slots are nonzero) and the cotangents of ``buf[0:6]`` (p3,
    v3).  CUDA tensors launch the kernel (``staged_group.launches``); CPU
    tensors run :func:`staged_group_plain`."""
    with tracing.span("ops.staged_group"):
        if buf.device.type == "cpu":
            return staged_group_plain(spec, group_index, buf, win, obj_tx, prim, slots)
        _device_check(buf)
        info = _group_entry(spec, group_index)
        reduce_slots = slots[info["off"]:info["off"] + info["T"] * info["L"]]
        out = _fold_launch(spec, group_index, buf, win, obj_tx, prim, slots, reduce_slots)
        staged_group.launches += 1
        return out


staged_group.launches = 0


@lru_cache(maxsize=64)
def _single_slots(spec, device):
    slots = [s for kind, _, info in ft.wide_fold_plan(spec) if kind == "single"
             for s in info["slots"]]
    return torch.as_tensor(slots, dtype=torch.int32, device=device)


def staged_singles(spec, buf, win, obj_tx, prim, slots):
    """K7: as :func:`staged_group` for the trees outside the groups (static
    codes and slots; at most 32 leaves).  CUDA tensors launch the kernel
    (``staged_singles.launches``); CPU tensors run
    :func:`staged_singles_plain`."""
    with tracing.span("ops.staged_singles"):
        if buf.device.type == "cpu":
            return staged_singles_plain(spec, buf, win, obj_tx, prim)
        _device_check(buf)
        out = _fold_launch(spec, -1, buf, win, obj_tx, prim, slots, _single_slots(spec, buf.device))
        staged_singles.launches += 1
        return out


staged_singles.launches = 0


def _check_reduce(keys, vals, reduce_slots, n_rows, n_slots):
    n = keys.shape[0] if keys.ndim == 1 else -1
    if keys.dtype != torch.int32 or n < 0 or not keys.is_contiguous():
        raise ValueError("keys must be a contiguous (n,) int32 tensor")
    if tuple(vals.shape) != (n, GEO_VALUES) or not vals.is_contiguous():
        raise ValueError(f"vals: expected contiguous ({n}, {GEO_VALUES}), got {tuple(vals.shape)}")
    if vals.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"vals must be float32 or float64, got {vals.dtype}")
    if (reduce_slots.dtype != torch.int32 or tuple(reduce_slots.shape) != (n_rows,)
            or not reduce_slots.is_contiguous()):
        raise ValueError(f"reduce_slots must be a contiguous ({n_rows},) int32 tensor")
    if keys.device != vals.device or reduce_slots.device != vals.device:
        raise ValueError("keys, vals and reduce_slots must lie on one device")
    if n_slots < 0:
        raise ValueError("n_slots must be >= 0")


def row_reduce_plain(keys, vals, reduce_slots, n_rows, n_slots=None):
    """Plain PyTorch version of :func:`row_reduce`: the float64 sum of each
    row's entries (``index_add_``, in entry order on CPU tensors), cast to
    the values' dtype."""
    n_slots = n_rows if n_slots is None else n_slots
    _check_reduce(keys, vals, reduce_slots, n_rows, n_slots)
    if bool(((keys < -1) | (keys >= n_rows)).any()):
        raise ValueError(f"keys must lie in [-1, {n_rows})")
    if bool(((reduce_slots < 0) | (reduce_slots >= n_slots)).any()):
        raise ValueError(f"reduce_slots must lie in [0, {n_slots})")
    idx = (keys >= 0).nonzero().squeeze(1)
    sums = torch.zeros((n_rows, GEO_VALUES), dtype=torch.float64, device=vals.device)
    sums.index_add_(0, keys[idx].long(), vals[idx].to(torch.float64))
    d_obj = torch.zeros((n_slots, 16), dtype=vals.dtype, device=vals.device)
    d_prim = torch.zeros((n_slots, 6), dtype=vals.dtype, device=vals.device)
    slots = reduce_slots.long()
    d_obj[slots, :12] = sums[:, :12].to(vals.dtype)
    d_prim[slots] = sums[:, 12:].to(vals.dtype)
    return d_obj, d_prim


def row_reduce(keys, vals, reduce_slots, n_rows, n_slots=None):
    """The wide backward's table reduce alone (``csrc/row_reduce.cuh``, the
    sum K6, K7 and K8 end with): entry i of ``keys`` (n,) int32 names a
    reduce row in [0, n_rows) or -1 (no row); its values are ``vals[i]``
    (n, 18), rows 0-2 of a leaf's transform then its 6 params.  Returns
    ``(d_objtx (n_slots, 16), d_prim (n_slots, 6))``: zero but for each row
    r's float64 sums, cast to the values' dtype, in rows 0-2 of
    ``d_objtx[reduce_slots[r]]`` and in ``d_prim[reduce_slots[r]]``
    (``n_slots`` defaults to ``n_rows``; every slot must lie below it).
    Two launches on the same inputs give bit-identical sums.  CUDA tensors
    launch the kernels (counted in ``row_reduce.launches``); CPU tensors
    run :func:`row_reduce_plain`.  The main path reaches the kernels
    through K6, K7 and K8, not through this wrapper."""
    with tracing.span("ops.row_reduce"):
        if vals.device.type == "cpu":
            return row_reduce_plain(keys, vals, reduce_slots, n_rows, n_slots)
        _device_check(vals)
        n_slots = n_rows if n_slots is None else n_slots
        _check_reduce(keys, vals, reduce_slots, n_rows, n_slots)
        if vals.data_ptr() % (2 * vals.element_size()):
            raise ValueError("vals must be aligned to two of its elements")
        out = _row_reduce_launch(keys, vals, reduce_slots, n_rows, n_slots)
        row_reduce.launches += 1
        return out


row_reduce.launches = 0


def _row_reduce_launch(keys, vals, reduce_slots, n_rows, n_slots):
    n = keys.shape[0]
    d_obj = torch.zeros((n_slots, 16), dtype=vals.dtype, device=vals.device)
    d_prim = torch.zeros((n_slots, 6), dtype=vals.dtype, device=vals.device)
    scratch = _reduce_scratch(_cuda.library("wide_grad").pyrayt_staged_reduce_scratch, n, n_rows,
                              vals.device)
    _cuda.call("wide_grad", "pyrayt_row_reduce", vals.dtype, vals.device,
               keys, vals, n, n_rows, reduce_slots, scratch, d_obj, d_prim)
    return d_obj, d_prim


def _reverse_chain(spec, config, state0, obj_tx, prim, glass, slots, records, masks, fold_of,
                   kernels, d_records, d_fstate, scal, plan):
    """The wide backward's reverse sweep over the generations any ray ran,
    last first: ``tail`` (K5's signature) maps the carried and record
    cotangents through the step after the fold, whose ``(fold5, win)`` of
    generation g is ``fold_of(g)``; ``group`` (K6's) per group and
    ``singles`` (K7's) map the hit distance's and normal's cotangents into
    the winning trees; the carried cotangent of generation g is
    ``dcarry[0:6] + sum(dpv), dcarry[6:11]``."""
    tail, group, singles = kernels
    n, g_limit = state0.shape[1], config.generation_limit
    d_obj = torch.zeros_like(obj_tx)
    d_prim = torch.zeros_like(prim)
    d_glass = torch.zeros_like(glass)
    if plan is None:
        carry = _carry_rows(d_fstate)
    else:
        carry = torch.zeros((11, n), dtype=state0.dtype, device=state0.device)
    plan_groups = [idx for kind, idx, _ in ft.wide_fold_plan(spec) if kind == "group"]
    has_singles = any(kind == "single" for kind, _, _ in ft.wide_fold_plan(spec))
    # a generation no ray ran passes every cotangent through: skip it
    ran_any = generations_ran(records, masks).any(dim=1).tolist()
    for g in reversed(range(g_limit)):
        if not ran_any[g]:
            continue
        fold5, win = fold_of(g)
        buf, dcarry, dgl = tail(
            spec, config, state0, records[g], masks[g], masks[g - 1] if g else None, fold5,
            glass, carry, None if plan is not None else d_records[g], scal, plan)
        d_glass += dgl
        dpv = dcarry[0:6]
        calls = [lambda gi=gi: group(spec, gi, buf, win, obj_tx, prim, slots)
                 for gi in plan_groups]
        if has_singles:
            calls.append(lambda: singles(spec, buf, win, obj_tx, prim, slots))
        for call in calls:
            do, dp, dv = call()
            d_obj += do
            d_prim += dp
            dpv = dpv + dv
        carry = torch.cat((dpv, dcarry[6:11]))
    zero = torch.zeros_like(carry[:1])
    d_state0 = torch.cat((carry[0:3], zero, carry[3:6], zero, carry[6:11]))
    return d_obj, d_prim, d_glass, d_state0


def staged_bwd(spec, config, state0, obj_tx, prim, glass, slots, records, masks, fold5, win,
               d_records=None, d_fstate=None, scal=None, plan=None):
    """The staged wide backward: ``(d_objtx (S, 16), d_prim (S, 6), d_glass
    (M, 7), d_state0 (13, n))`` of a K2 trace (``records``, ``masks``,
    ``fold5``, ``win`` from :func:`~pyrayt_tpu_torch.ops.fused_trace.fused_trace_wide`
    with ``save_fold``), given the record and final-state cotangents
    (``d_records``, ``d_fstate``) or a loss plan and its scalar row.

    Per generation that any ray ran, last first: K5 maps the carried cotangent and
    the record cotangent through the tail; K6 per group and K7 for the
    singles map the hit distance's and normal's cotangents into the
    winning trees' tables and the input rays; the carried cotangent of
    generation g is ``dcarry[0:6] + sum(dpv), dcarry[6:11]``."""
    return _reverse_chain(spec, config, state0, obj_tx, prim, glass, slots, records, masks,
                          lambda g: (fold5[g], win[g]), (staged_tail, staged_group, staged_singles),
                          d_records, d_fstate, scal, plan)


# ---------------------------------------------------------------------------
# the monolithic wide backward (K8)
# ---------------------------------------------------------------------------


def _recomputed_fold(spec, state0, records, masks, obj_tx, prim, slots, aabb, g):
    """Generation g's ``(fold5 (5, n), win (n,))`` recomputed from its input
    state, as K2 with ``save_fold`` writes them: zero and -1 for the rays
    that did not run it."""
    x, ran = _wide_input_state(state0, records[g], masks[g - 1] if g else None)
    n = x.shape[1]
    fold5 = torch.zeros((5, n), dtype=x.dtype, device=x.device)
    win = torch.full((n,), -1, dtype=torch.int32, device=x.device)
    idx = ran.nonzero().squeeze(1)
    if idx.numel():
        xi = x[:, idx]
        best, best_n, best_mat, _, win_i, _ = ft.wide_fold_plain(
            spec, obj_tx.reshape(-1, 4, 4), prim, slots, aabb, xi[0:4], xi[4:8])
        fold5[:, idx] = torch.cat((best[None], best_n[:3], best_mat[None]))
        win[idx] = win_i
    return fold5, win


def fused_bwd_wide_plain(spec, config, state0, obj_tx, prim, glass, slots, aabb, cull, records,
                         masks, d_records=None, d_fstate=None, scal=None, plan=None):
    """Plain PyTorch version of :func:`fused_bwd_wide` (same signature and
    outputs): the staged chain's plain versions (:func:`staged_tail_plain`,
    :func:`staged_group_plain`, :func:`staged_singles_plain`) on a fold
    recomputed per generation (:func:`~pyrayt_tpu_torch.ops.fused_trace.wide_fold_plain`,
    which culls by ``aabb``; ``cull`` is checked and not read) instead of
    one saved by the forward."""
    _check_wide_fused(spec, config, state0, obj_tx, prim, glass, slots, aabb, cull, records, masks,
                      d_records, d_fstate, scal, plan)

    def singles(spec, buf, win, obj_tx, prim, slots):
        return staged_singles_plain(spec, buf, win, obj_tx, prim)

    return _reverse_chain(
        spec, config, state0, obj_tx, prim, glass, slots, records, masks,
        lambda g: _recomputed_fold(spec, state0, records, masks, obj_tx, prim, slots, aabb, g),
        (staged_tail_plain, staged_group_plain, singles), d_records, d_fstate, scal, plan)


def _check_wide_fused(spec, config, state0, obj_tx, prim, glass, slots, aabb, cull, records, masks,
                      d_records, d_fstate, scal, plan):
    if not ft.supports_fused_wide(spec):
        raise ValueError(
            "scene has non-packed materials or no batchable tree groups; use the plain engine")
    if cull is None:
        raise ValueError("K8 needs the cull table of wide_cull_tables")
    ft._check_wide(spec, state0, obj_tx, prim, glass, slots, aabb, cull)
    if (plan is None) == (d_records is None) or (d_records is None) != (d_fstate is None):
        raise ValueError("give d_records and d_fstate (generic mode) or scal and plan (loss mode)")
    _check(spec, config, state0, obj_tx, prim, glass, records, masks, d_records, d_fstate,
           scal if plan is not None else None)


@lru_cache(maxsize=64)
def _all_slots(n_leaves, device):
    return torch.arange(n_leaves, dtype=torch.int32, device=device)


def _wide_fused_launch(spec, config, state0, obj_tx, prim, glass, slots, cull, records, masks,
                       d_records, d_fstate, scal, plan):
    """Launch K8 and its reduces; returns its four outputs."""
    lib = _cuda.library("wide_fused_grad")
    device, dtype = state0.device, state0.dtype
    n, g, s_count, m = state0.shape[1], config.generation_limit, spec.n_leaves, glass.shape[0]
    kw = dict(dtype=dtype, device=device)
    d_state0 = torch.empty_like(state0)
    # the reduce writes rows 0-2 of every leaf's d_objtx and all of d_prim,
    # reduce_partials all of d_glass: only row 3 needs the zero fill
    d_obj = torch.zeros((s_count, 16), **kw)
    d_prim = torch.empty((s_count, 6), **kw)
    d_glass = torch.empty((m, matl.N_GLASS_COEFFS), **kw)
    if n == 0:
        return d_obj, d_prim.zero_(), d_glass.zero_(), d_state0
    keys, vals = _reduce_table((g, n), dtype, device)
    blocks = -(-n // lib.pyrayt_wide_fused_block_threads())
    glass_partials = torch.empty((max(1, m * matl.N_GLASS_COEFFS * g * blocks),),
                                 dtype=torch.float64, device=device)
    scratch = _reduce_scratch(lib.pyrayt_wide_fused_reduce_scratch, g * n, s_count, device)
    program = ft.device_wide_program(spec, device)
    _cuda.call("wide_fused_grad", "pyrayt_wide_fused_bwd", dtype, device,
               state0, n, g, obj_tx, prim, glass, program, *ft.wide_program_sizes(spec), m, slots,
               cull, records, masks, d_records if plan is None else None,
               d_fstate if plan is None else None, -1 if plan is None else plan.kind,
               scal if plan is not None else None, 0 if plan is None else scal.shape[0],
               config.ray_offset, config.world_index, config.intensity_threshold,
               int(config.apply_intensity_threshold), d_state0, keys, vals, glass_partials,
               _all_slots(s_count, device), s_count, scratch, d_obj, d_prim, d_glass)
    return d_obj, d_prim, d_glass, d_state0


def fused_bwd_wide(spec, config, state0, obj_tx, prim, glass, slots, aabb, cull, records, masks,
                   d_records=None, d_fstate=None, scal=None, plan=None):
    """K8, the monolithic wide backward: ``(d_objtx (S, 16), d_prim (S, 6),
    d_glass (M, 7), d_state0 (13, n))`` of a K2 trace (``records``,
    ``masks`` from :func:`~pyrayt_tpu_torch.ops.fused_trace.fused_trace_wide`
    on the same inputs, ``slots``, ``aabb`` and ``cull`` its tables from
    :func:`~pyrayt_tpu_torch.ops.fused_trace.wide_cull_tables`), given
    the record and final-state cotangents (``d_records`` (G, 15, n),
    ``d_fstate`` (13, n)) or a loss plan and its scalar row (``plan``,
    ``scal``).  It needs no saved fold: per generation each ray recomputes
    it.  The same gradients as :func:`staged_bwd`, up to rounding.  CUDA
    tensors launch the kernel (counted in ``fused_bwd_wide.launches``); CPU
    tensors run :func:`fused_bwd_wide_plain`."""
    with tracing.span("ops.fused_bwd_wide"):
        if state0.device.type == "cpu":
            return fused_bwd_wide_plain(spec, config, state0, obj_tx, prim, glass, slots, aabb,
                                        cull, records, masks, d_records, d_fstate, scal, plan)
        _device_check(state0)
        _check_wide_fused(spec, config, state0, obj_tx, prim, glass, slots, aabb, cull, records,
                          masks, d_records, d_fstate, scal, plan)
        out = _wide_fused_launch(spec, config, state0, obj_tx, prim, glass, slots, cull, records,
                                 masks, d_records, d_fstate, scal, plan)
        fused_bwd_wide.launches += 1
        return out


fused_bwd_wide.launches = 0


# ---------------------------------------------------------------------------
# autograd Functions
# ---------------------------------------------------------------------------


def _d_world(world, d_objtx):
    """Chain ``d_objtx`` through ``obj_tx = affine_inverse(world)``."""
    with torch.enable_grad():
        w = world.detach().requires_grad_(True)
        obj_tx = affine_inverse(w).reshape(d_objtx.shape)
        (d_world,) = torch.autograd.grad(obj_tx, w, d_objtx)
    return d_world


def _obj_tx(world, n_leaves):
    with tracing.span("ops.tables"):
        return affine_inverse(world).reshape(n_leaves, 16).contiguous()


def _route_forward(route, spec, config, world, prim, glass, state0, obj_tx):
    """The forward of ``route`` (:func:`_check_scene`): ``(records, masks,
    final state, saved)``, where ``saved`` are the tensors its backward
    reads besides the inputs and the records: narrow, K1 (nothing); staged,
    K2 with ``save_fold`` (``slots``, ``fold5``, ``win``); fused, K2 (its
    tables ``slots``, ``aabb``, ``cull``)."""
    if route == "narrow":
        return (*ft.fused_trace(spec, config, state0, obj_tx, prim, glass), ())
    slots, aabb, cull = ft.wide_cull_tables(spec, {"world": world, "prim": prim}, state0.dtype)
    if route == "staged":
        records, masks, fstate, fold5, win = ft.fused_trace_wide(
            spec, config, state0, obj_tx, prim, glass, slots, aabb, cull, save_fold=True)
        return records, masks, fstate, (slots, fold5, win)
    return (*ft.fused_trace_wide(spec, config, state0, obj_tx, prim, glass, slots, aabb, cull),
            (slots, aabb, cull))


def _route_backward(route, spec, config, state0, obj_tx, prim, glass, records, masks, saved,
                    d_records=None, d_fstate=None, scal=None, plan=None):
    """The backward of ``route`` given the record and final-state cotangents
    or a loss plan and its scalar row: narrow, K4 or K3; staged,
    :func:`staged_bwd`; fused, K8.  Returns ``(d_objtx, d_prim, d_glass,
    d_state0)``."""
    inputs = (spec, config, state0, obj_tx, prim, glass)
    if route == "staged":
        slots, fold5, win = saved
        return staged_bwd(*inputs, slots, records, masks, fold5, win, d_records=d_records,
                          d_fstate=d_fstate, scal=scal, plan=plan)
    if route == "fused":
        return fused_bwd_wide(*inputs, *saved, records, masks, d_records=d_records,
                              d_fstate=d_fstate, scal=scal, plan=plan)
    if plan is None:
        return fused_bwd(*inputs, records, masks, d_records, d_fstate)
    return fused_bwd_loss(*inputs, records, masks, scal, plan)


class _KernelLoss(torch.autograd.Function):
    """loss = plan.value(plan.scalars(trace)) through the route's forward;
    backward through its backward in loss mode."""

    @staticmethod
    def forward(ctx, world, prim, glass, state0, spec, config, route, plan):
        obj_tx = _obj_tx(world, spec.n_leaves)
        records, masks, _, saved = _route_forward(route, spec, config, world, prim, glass, state0,
                                                  obj_tx)
        scal = plan.scalars(records, masks)
        ctx.save_for_backward(world, prim, glass, state0, obj_tx, records, masks, scal, *saved)
        ctx.args = (spec, config, route, plan)
        return plan.value(scal).clone()

    @staticmethod
    def backward(ctx, g):
        world, prim, glass, state0, obj_tx, records, masks, scal, *saved = ctx.saved_tensors
        spec, config, route, plan = ctx.args
        d_objtx, d_prim, d_glass, d_state0 = _route_backward(
            route, spec, config, state0, obj_tx, prim, glass, records, masks, saved,
            scal=plan.row(scal, g), plan=plan)
        return _d_world(world, d_objtx), d_prim, d_glass, d_state0, None, None, None, None


class _KernelTrace(torch.autograd.Function):
    """(records, masks, final state) of the route's forward; backward
    through its backward in generic mode."""

    @staticmethod
    def forward(ctx, world, prim, glass, state0, spec, config, route):
        obj_tx = _obj_tx(world, spec.n_leaves)
        records, masks, fstate, saved = _route_forward(route, spec, config, world, prim, glass,
                                                       state0, obj_tx)
        ctx.save_for_backward(world, prim, glass, state0, obj_tx, records, masks, *saved)
        ctx.args = (spec, config, route)
        ctx.mark_non_differentiable(masks)
        return records, masks, fstate

    @staticmethod
    def backward(ctx, d_records, d_masks, d_fstate):
        del d_masks
        world, prim, glass, state0, obj_tx, records, masks, *saved = ctx.saved_tensors
        spec, config, route = ctx.args
        d_objtx, d_prim, d_glass, d_state0 = _route_backward(
            route, spec, config, state0, obj_tx, prim, glass, records, masks, saved,
            d_records=d_records.contiguous(), d_fstate=d_fstate.contiguous())
        return _d_world(world, d_objtx), d_prim, d_glass, d_state0, None, None, None


def _function_inputs(params, rays):
    with tracing.span("ops.tables"):
        dtype = rays.dtype
        state0 = torch.cat((rays.positions, rays.directions, rays.metadata)).contiguous()
        return (
            params["world"].to(dtype),
            params["prim"].to(dtype).contiguous(),
            params["glass"].to(dtype).contiguous(),
            state0,
        )


def _check_scene(spec: SceneSpec, config: TraceConfig) -> str:
    """The scene's route through the kernels (:func:`wide_grad_mode`):
    ``"narrow"``, ``"staged"`` or ``"fused"``, read by :func:`_route_forward`
    and :func:`_route_backward`; raises for a scene no kernel covers."""
    if not (ft.supports_fused(spec) or ft.supports_fused_wide(spec)):
        raise ValueError(
            "scene has non-packed materials, no leaves, or no batchable tree groups; "
            "use the plain engine"
        )
    return wide_grad_mode(spec, config)


@lru_cache(maxsize=64)
def build_fused_value_and_grad_fn(spec: SceneSpec, materials, config: TraceConfig, loss):
    """``fn(params, rays) -> scalar`` for a recognized loss descriptor:
    forward through K1, the loss from plain torch reductions of the records
    and masks, reverse mode through K3 (``loss.backward()`` or
    ``torch.autograd.grad``); a wide scene runs K2 with ``save_fold``
    forward and the staged backward with K5 in its loss mode, or with
    ``wide_grad="fused"`` K2 and K8 in its loss mode.  Raises
    ValueError for a loss without a plan (use
    :func:`build_fused_vjp_trace_fn`).  ``materials`` is accepted for the
    JAX package's signature."""
    del materials  # packed kinds are read from the spec and the glass rows
    plan = loss_plan(loss)
    if plan is None:
        raise ValueError(f"loss {loss!r} has no fused plan")
    route = _check_scene(spec, config)

    def value(params, rays):
        return _KernelLoss.apply(*_function_inputs(params, rays), spec, config, route, plan)

    return value


def fused_plan_value(spec: SceneSpec, config: TraceConfig, plan: LossPlan, params, rays):
    """The loss of ``plan`` on ``rays`` through the scene's kernels, as the
    function of :func:`build_fused_value_and_grad_fn` computes it, for a
    plan the caller made: a sharded objective's, whose ``scalars`` reduce
    over every rank (``parallel.build_sharded_objective``)."""
    return _KernelLoss.apply(*_function_inputs(params, rays), spec, config,
                             _check_scene(spec, config), plan)


@lru_cache(maxsize=64)
def build_fused_vjp_trace_fn(spec: SceneSpec, materials, config: TraceConfig):
    """``fn(params, rays) -> TraceResult`` through K1, reverse-mode
    differentiable through K4 (a wide scene: K2, then the staged backward
    with K5 in its generic mode, or K8 in its generic mode with
    ``wide_grad="fused"``): autograd of any function of ``records``
    and ``final_rays`` runs the backward kernels.  Same contract as
    ``ops.fused_trace.build_fused_trace_fn``."""
    del materials
    route = _check_scene(spec, config)

    def trace(params, rays) -> engine.TraceResult:
        records, masks, fstate = _KernelTrace.apply(*_function_inputs(params, rays), spec, config,
                                                    route)
        return engine.TraceResult(
            records=records,
            record_mask=masks,
            final_rays=ft.rays_from_state(fstate),
            generations_run=masks.any(dim=1).sum(),
        )

    return trace

"""The narrow backward kernels (K3 loss-fused, K4 generic) on CUDA, their
wrappers, their plain PyTorch versions and the autograd Functions around
them.

The kernels (``csrc/fused_grad.cu``) replace the Pallas kernel built by
``pyrayt_tpu/ops/fused_grad.py:_make_bwd_kernel`` in its two modes and run
by ``_run_bwd``.  The forward of both Functions is the forward kernel K1
(ops/fused_trace.py): the record buffer it writes holds every generation's
input state, so the backward saves nothing else.

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
"""

from __future__ import annotations

import ctypes
import dataclasses
from functools import lru_cache
from typing import Callable, Tuple

import torch

from pyrayt_tpu_torch import materials as matl
from pyrayt_tpu_torch.analysis import metrics as _m
from pyrayt_tpu_torch.config import TraceConfig
from pyrayt_tpu_torch.core.operations import affine_inverse
from pyrayt_tpu_torch.ops import fused_trace as ft
from pyrayt_tpu_torch.scene.compile import SceneSpec
from pyrayt_tpu_torch.tracer import engine

__all__ = [
    "LossPlan",
    "loss_plan",
    "wide_grad_mode",
    "generations_ran",
    "fused_bwd",
    "fused_bwd_plain",
    "fused_bwd_loss",
    "fused_bwd_loss_plain",
    "build_fused_value_and_grad_fn",
    "build_fused_vjp_trace_fn",
]

# record rows (engine record layout)
_R_SURF, _R_X0, _R_Y0 = 5, 6, 7
_R_Y1, _R_Z1 = 10, 11
_R_XT, _R_YT = 12, 13

# plan codes; keep equal to the Plan enum in csrc/fused_grad.cu
PLAN_RMS, PLAN_FOCUS, PLAN_SOFT_FOCUS = range(3)
# capacity of the kernel's scalar row; keep equal to kMaxScal
MAX_SCALARS = 16


# ---------------------------------------------------------------------------
# loss plans
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class LossPlan:
    """A recognized loss: ``scalars(records, masks) -> (K,)`` reduces the
    trace; ``value(scal)`` is the loss; the kernel's scalar row is
    ``scal ++ [g] ++ tail`` (``g`` the upstream cotangent, ``tail`` the
    descriptor's constants); ``drec(rec (15, n), mask (n,), row)`` is the
    record cotangent of one generation, the formulas the kernel runs."""

    kind: int
    scalars: Callable
    value: Callable
    drec: Callable
    tail: Tuple[float, ...]

    def row(self, scal, g):
        """The kernel's scalar row for upstream cotangent ``g``."""
        tail = torch.as_tensor(self.tail, dtype=scal.dtype, device=scal.device)
        return torch.cat((scal, g.reshape(1).to(scal.dtype), tail)).contiguous()


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

    # row: [cy, cz, W, L, g, surface_id]
    return LossPlan(PLAN_RMS, scalars, lambda scal: scal[3], drec, (sid,))


def _focus_plan(loss) -> LossPlan:
    sid = float(loss.surface_id)
    target = float(loss.target_focus)
    min_tilt = float(loss.min_tilt)

    def scalars(records, masks):
        yt = records[:, _R_YT, :]
        tilted = torch.abs(yt) > min_tilt
        w = (masks & (records[:, _R_SURF, :] == sid) & tilted).to(records.dtype)
        W = torch.clamp(torch.sum(w), min=1.0)
        safe_yt = torch.where(tilted, yt, 1.0)
        t = records[:, _R_X0, :] - records[:, _R_XT, :] * records[:, _R_Y0, :] / safe_yt
        return torch.stack([W, torch.sum(w * (t - target) ** 2) / W])

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
    return LossPlan(PLAN_FOCUS, scalars, lambda scal: scal[1], drec, (sid, min_tilt, target))


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

    def scalars(records, masks):
        yt = records[:, _R_YT, :]
        surf, y1, z1 = records[:, _R_SURF, :], records[:, _R_Y1, :], records[:, _R_Z1, :]
        w = weights(surf, masks, y1, z1, yt)[4]
        W = torch.clamp(torch.sum(w), min=1e-12)
        safe_yt = torch.where(torch.abs(yt) > t0, yt, t0)
        t = records[:, _R_X0, :] - records[:, _R_XT, :] * records[:, _R_Y0, :] / safe_yt
        return torch.stack([W, torch.sum(w * (t - target) ** 2) / W])

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
    return LossPlan(PLAN_SOFT_FOCUS, scalars, lambda scal: scal[1], drec, tail)


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
    """Backward-path selection: ``"narrow"`` for scenes of at most 32
    leaves; wider scenes raise NotImplementedError (the wide engine and its
    backward kernels K5-K8 are not ported yet)."""
    del config  # ``wide_grad`` selects among wide backwards, none ported yet
    engine.check_narrow(spec)
    return "narrow"


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


@lru_cache(maxsize=None)
def _library():
    lib = ctypes.CDLL(ft.build_kernels()["fused_grad"][0])
    p, i, d = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    args = (
        [p, ctypes.c_longlong, i]  # state0, n, generations
        + [p] * 4  # obj_tx, prim, glass, program
        + [i] * 3  # program_len, n_leaves, n_glass
        + [p] * 4  # records, masks, d_records, d_fstate
        + [i, p, i]  # plan, scal, n_scal
        + [d] * 3  # ray_offset, world_index, intensity_threshold
        + [i]  # apply_threshold
        + [p] * 6  # d_state0, partials, d_objtx, d_prim, d_glass, stream
    )
    for name in ("pyrayt_fused_bwd_f32", "pyrayt_fused_bwd_f64",
                 "pyrayt_fused_bwd_loss_f32", "pyrayt_fused_bwd_loss_f64"):
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = ctypes.c_int
    lib.pyrayt_bwd_block_threads.argtypes = []
    lib.pyrayt_bwd_block_threads.restype = ctypes.c_int
    lib.pyrayt_bwd_error_string.argtypes = [ctypes.c_int]
    lib.pyrayt_bwd_error_string.restype = ctypes.c_char_p
    return lib


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
    lib = _library()
    blocks = -(-n // lib.pyrayt_bwd_block_threads())  # the kernel's grid
    n_entries = 22 * s + matl.N_GLASS_COEFFS * m
    partials = torch.empty((n_entries, blocks), dtype=torch.float64, device=device)
    program = ft.device_program(spec, device)
    f32 = dtype == torch.float32
    if plan is None:
        fn = lib.pyrayt_fused_bwd_f32 if f32 else lib.pyrayt_fused_bwd_f64
        scal = records  # unused by K4
        plan_kind, n_scal = -1, 0
    else:
        fn = lib.pyrayt_fused_bwd_loss_f32 if f32 else lib.pyrayt_fused_bwd_loss_f64
        d_records = d_fstate = records  # unused by K3
        plan_kind, n_scal = plan.kind, scal.shape[0]
    with torch.cuda.device(device):
        err = fn(
            state0.data_ptr(), n, config.generation_limit,
            obj_tx.data_ptr(), prim.data_ptr(), glass.data_ptr(), program.data_ptr(),
            program.numel(), s, m,
            records.data_ptr(), masks.data_ptr(), d_records.data_ptr(), d_fstate.data_ptr(),
            plan_kind, scal.data_ptr(), n_scal,
            config.ray_offset, config.world_index, config.intensity_threshold,
            int(config.apply_intensity_threshold),
            d_state0.data_ptr(), partials.data_ptr(),
            d_objtx.data_ptr(), d_prim.data_ptr(), d_glass.data_ptr(),
            torch.cuda.current_stream(device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(
            f"fused backward kernel launch failed: {lib.pyrayt_bwd_error_string(err).decode()}"
        )
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
    return affine_inverse(world).reshape(n_leaves, 16).contiguous()


class _FusedLoss(torch.autograd.Function):
    """loss = plan.value(plan.scalars(K1 trace)); backward through K3."""

    @staticmethod
    def forward(ctx, world, prim, glass, state0, spec, config, plan):
        obj_tx = _obj_tx(world, spec.n_leaves)
        records, masks, _ = ft.fused_trace(spec, config, state0, obj_tx, prim, glass)
        scal = plan.scalars(records, masks)
        ctx.save_for_backward(world, prim, glass, state0, obj_tx, records, masks, scal)
        ctx.args = (spec, config, plan)
        return plan.value(scal).clone()

    @staticmethod
    def backward(ctx, g):
        world, prim, glass, state0, obj_tx, records, masks, scal = ctx.saved_tensors
        spec, config, plan = ctx.args
        d_objtx, d_prim, d_glass, d_state0 = fused_bwd_loss(
            spec, config, state0, obj_tx, prim, glass, records, masks, plan.row(scal, g), plan
        )
        return _d_world(world, d_objtx), d_prim, d_glass, d_state0, None, None, None


class _FusedTrace(torch.autograd.Function):
    """(records, masks, final state) of K1; backward through K4."""

    @staticmethod
    def forward(ctx, world, prim, glass, state0, spec, config):
        obj_tx = _obj_tx(world, spec.n_leaves)
        records, masks, fstate = ft.fused_trace(spec, config, state0, obj_tx, prim, glass)
        ctx.save_for_backward(world, prim, glass, state0, obj_tx, records, masks)
        ctx.args = (spec, config)
        ctx.mark_non_differentiable(masks)
        return records, masks, fstate

    @staticmethod
    def backward(ctx, d_records, d_masks, d_fstate):
        del d_masks
        world, prim, glass, state0, obj_tx, records, masks = ctx.saved_tensors
        spec, config = ctx.args
        d_objtx, d_prim, d_glass, d_state0 = fused_bwd(
            spec, config, state0, obj_tx, prim, glass, records, masks,
            d_records.contiguous(), d_fstate.contiguous(),
        )
        return _d_world(world, d_objtx), d_prim, d_glass, d_state0, None, None


def _function_inputs(params, rays):
    dtype = rays.dtype
    state0 = torch.cat((rays.positions, rays.directions, rays.metadata)).contiguous()
    return (
        params["world"].to(dtype),
        params["prim"].to(dtype).contiguous(),
        params["glass"].to(dtype).contiguous(),
        state0,
    )


def _check_scene(spec: SceneSpec, config: TraceConfig):
    wide_grad_mode(spec, config)
    if not ft.supports_fused(spec):
        raise ValueError("scene has non-packed materials or no leaves; use the plain engine")


@lru_cache(maxsize=64)
def build_fused_value_and_grad_fn(spec: SceneSpec, materials, config: TraceConfig, loss):
    """``fn(params, rays) -> scalar`` for a recognized loss descriptor:
    forward through K1, the loss from plain torch reductions of the records
    and masks, reverse mode through K3 (``loss.backward()`` or
    ``torch.autograd.grad``).  Raises ValueError for a loss without a plan
    (use :func:`build_fused_vjp_trace_fn`).  ``materials`` is accepted for
    the JAX package's signature."""
    del materials  # packed kinds are read from the spec and the glass rows
    plan = loss_plan(loss)
    if plan is None:
        raise ValueError(f"loss {loss!r} has no fused plan")
    _check_scene(spec, config)

    def value(params, rays):
        return _FusedLoss.apply(*_function_inputs(params, rays), spec, config, plan)

    return value


@lru_cache(maxsize=64)
def build_fused_vjp_trace_fn(spec: SceneSpec, materials, config: TraceConfig):
    """``fn(params, rays) -> TraceResult`` through K1, reverse-mode
    differentiable through K4: autograd of any function of ``records`` and
    ``final_rays`` runs the backward kernel.  Same contract as
    ``ops.fused_trace.build_fused_trace_fn``."""
    del materials
    _check_scene(spec, config)

    def trace(params, rays) -> engine.TraceResult:
        records, masks, fstate = _FusedTrace.apply(*_function_inputs(params, rays), spec, config)
        return engine.TraceResult(
            records=records,
            record_mask=masks,
            final_rays=ft.rays_from_state(fstate),
            generations_run=masks.any(dim=1).sum(),
        )

    return trace

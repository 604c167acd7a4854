"""The CUDA kernel against its plain version on the card.

Skips without a CUDA device.  It imports no JAX, so a machine with only
PyTorch runs it (the ``--noconftest`` keeps the suite's JAX setup out):

    python -m pytest --noconftest -m cuda tests/test_torch/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from pyrayt_tpu_torch import interop
from pyrayt_tpu_torch.config import TraceConfig
from pyrayt_tpu_torch.ops import fused_trace as ft
from torch_parity_scenes import SCENES, TORCH_NS, numpy_rays

# The kernel contracts multiply-adds into FMAs; eager PyTorch does not.  At
# float64 that changes nothing the tests can see.  At float32 a grazing
# reflection is ill-conditioned (the "union" scene's 20 deg cone grazes its
# sphere, whose silhouette is at asin(1/3) = 19.47 deg): the 1e-6 push-off's
# normal component falls below float32 resolution, so rounding decides
# whether the ray re-hits the surface it left.  Measured on an H100: 2 of
# the union scene's 64 rays, none elsewhere.
MIN_AGREE32 = 0.9


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("the CUDA kernel needs an NVIDIA GPU")
    return torch.device("cuda")


def kernel_inputs(name, device, dtype, threshold_rays=False):
    build, origin, angle, n, gens = SCENES[name]
    with TORCH_NS.fresh_ids():
        scene = TORCH_NS.compile(build(TORCH_NS), device=device, dtype=torch.float64)
    pos, dirs, meta = numpy_rays(origin, angle, n)
    if threshold_rays:
        meta[1, ::2] = 0.05  # below the 0.1 intensity threshold
    rays = interop.rays_from_numpy(pos, dirs, meta, device=device, dtype=torch.float64)
    return scene.spec, gens, ft.kernel_inputs(scene.params, rays.to(dtype=dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("name", sorted(SCENES))
def test_kernel_matches_plain(cuda, name, dtype):
    spec, gens, inputs = kernel_inputs(name, cuda, dtype)
    config = TraceConfig(generation_limit=gens)
    before = ft.fused_trace.launches
    k_rec, k_mask, k_fin = ft.fused_trace(spec, config, *inputs)
    assert ft.fused_trace.launches == before + 1
    p_rec, p_mask, p_fin = ft.fused_trace_plain(spec, config, *inputs)
    torch.cuda.synchronize()
    assert k_mask.dtype == torch.bool
    if dtype == torch.float64:
        assert torch.equal(k_mask, p_mask)
        torch.testing.assert_close(k_rec, p_rec, rtol=1e-9, atol=1e-9)
        torch.testing.assert_close(k_fin, p_fin, rtol=1e-9, atol=1e-9)
        return
    agree = (k_mask == p_mask).all(dim=0)
    assert agree.float().mean() >= MIN_AGREE32
    torch.testing.assert_close(k_rec[..., agree], p_rec[..., agree], rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(k_fin[:, agree], p_fin[:, agree], rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_kernel_intensity_threshold_matches_plain(cuda):
    spec, gens, inputs = kernel_inputs("condenser", cuda, torch.float64, threshold_rays=True)
    config = TraceConfig(generation_limit=gens, apply_intensity_threshold=True)
    k_rec, k_mask, k_fin = ft.fused_trace(spec, config, *inputs)
    p_rec, p_mask, p_fin = ft.fused_trace_plain(spec, config, *inputs)
    assert torch.equal(k_mask, p_mask) and not k_mask[0, ::2].any()
    torch.testing.assert_close(k_rec, p_rec, rtol=1e-9, atol=1e-9)
    torch.testing.assert_close(k_fin, p_fin, rtol=1e-9, atol=1e-9)


@pytest.mark.cuda
def test_wrapper_rejects_bad_inputs(cuda):
    spec, gens, (state, obj_tx, prim, glass) = kernel_inputs("condenser", cuda, torch.float32)
    config = TraceConfig(generation_limit=gens)
    with pytest.raises(ValueError, match="contiguous"):
        ft.fused_trace(spec, config, state.t().contiguous().t(), obj_tx, prim, glass)
    with pytest.raises(ValueError, match="float32"):
        ft.fused_trace(spec, config, state, obj_tx.double(), prim, glass)
    with pytest.raises(ValueError, match="shape"):
        ft.fused_trace(spec, config, state, obj_tx[:2].contiguous(), prim, glass)


# ---------------------------------------------------------------------------
# the backward kernels K3 (loss-fused) and K4 (generic) against their plain
# versions, on the forward parity scenes and the gradient scenes
# ---------------------------------------------------------------------------

from pyrayt_tpu_torch.analysis import metrics  # noqa: E402
from pyrayt_tpu_torch.ops import fused_grad as fg  # noqa: E402
from torch_parity_scenes import GRAD_SCENES, follows_float64_path, grad_rays  # noqa: E402

ALL_SCENES = sorted(SCENES) + [f"grad:{name}" for name in sorted(GRAD_SCENES)]
# The imager's coordinates reach 50 units, where the 1e-6 push-off is below
# float32 resolution: a float32 trace can re-hit the surface a ray just left
# (distances ~1e-6 where float64 finds the next surface).  The plain version
# then is no oracle at float32: on the float64 trace's own records its
# float32 backward misses the float64 one by ~10% of max |g|, though by
# < 1e-5 over the rays whose float32 trace follows the float64 path
# (test_torch_grad.py::test_imager_float32_recompute_is_ill_conditioned);
# replaying the forward kernel's float32 records it misses the kernel by up
# to 65% of max |g| on an H100 even over those rays.  So at float32 the
# imager's kernel runs on those rays, which must be at least
# FOLLOW_SHARE32 of them (11 of 24 on an H100), and is held against the
# plain version at float64 on the float64 records of the same rays.  The
# hetero row under FocusError likewise: its rays through the lens centres
# reach the detector almost parallel to the axis, where the plan's record
# cotangent grows as 1 / tilt^2, so rounding of the large rows leaves
# residues in the nearly cancelling rows of the same ray: at float32 the
# plain version misses its own float64 state cotangents row by row on a
# third of the rays (on the same float32 records), and at float64, once
# thousands of rays put a tilt near the plan's minimum, a 2e-16 change of
# the records moves some components by more than 1e-9
# (test_torch_grad.py::test_hetero_row_focus_state_cotangents_are_ill_conditioned).
# There the float64 state cotangents of test_backward_at_scale_matches_plain
# are held at each ray's block scale (assert_backward_close's state_blocks).
ILL_CONDITIONED32 = ("grad:imager", "grad:hetero_row")
FOLLOW_SHARE32 = 0.25
CASES = [(name, torch.float64) for name in ALL_SCENES] + [
    (name, torch.float32) for name in ALL_SCENES if name not in ILL_CONDITIONED32
] + [(name, torch.float32) for name in ILL_CONDITIONED32]
# float64: the kernel contracts FMAs and sums in another order
TOL64 = dict(rtol=1e-9, atol=1e-9)
# float32: parameter cotangents within this share of their largest entry,
# and this share of rays with every initial-state cotangent within it (a
# grazing ray's recomputed hit is ill-conditioned at float32, as for K1)
REL32 = 1e-3


def backward_inputs(name, device, dtype, n=None):
    """(spec, config, kernel arguments, reference arguments), each
    arguments tuple ``(kernel inputs, records, masks)`` with the forward
    kernel's records on the card, float64 scene math cast to ``dtype``, on
    ``n`` rays (default: the scene's count).
    The reference is the kernel's own arguments, except for an
    ILL_CONDITIONED32 scene at float32: there both keep only the rays whose
    float32 trace follows the float64 path, and the reference is float64."""
    if name.startswith("grad:"):
        build, _, _, gens, _ = GRAD_SCENES[name[5:]]
        pos, dirs, meta = grad_rays(name[5:], n=n)
    else:
        build, origin, angle, _, gens = SCENES[name]
        pos, dirs, meta = numpy_rays(origin, angle, n or SCENES[name][3])
    with TORCH_NS.fresh_ids():
        scene = TORCH_NS.compile(build(TORCH_NS), device=device, dtype=torch.float64)
    rays = interop.rays_from_numpy(pos, dirs, meta, device=device, dtype=torch.float64)
    inputs = ft.kernel_inputs(scene.params, rays.to(dtype=dtype))
    config = TraceConfig(generation_limit=gens)
    records, masks, _ = ft.fused_trace(scene.spec, config, *inputs)
    args = (inputs, records, masks)
    if dtype != torch.float32 or name not in ILL_CONDITIONED32:
        return scene.spec, config, args, args
    inputs64 = ft.kernel_inputs(scene.params, rays)
    records64, masks64, _ = ft.fused_trace(scene.spec, config, *inputs64)
    keep = follows_float64_path(records, masks, records64, masks64)
    assert keep.float().mean() >= FOLLOW_SHARE32

    def cut(inputs, records, masks):
        return ((inputs[0][:, keep].contiguous(),) + tuple(inputs[1:]),
                records[..., keep].contiguous(), masks[:, keep].contiguous())

    return scene.spec, config, cut(*args), cut(inputs64, records64, masks64)


def detector_losses(records, masks):
    """One descriptor per plan, on the surface most masked rows end on."""
    sid = float(records[:, 5][masks].mode().values)
    return [
        metrics.RmsSpotRadius(sid),
        metrics.FocusError(1.0, sid),
        metrics.SoftFocusError(1.0, sid, (0.6, 0.6), 0.1),
    ]


def ray_block_scale(p):
    """Per ray, |p| with the position rows (0-3) and the direction rows
    (4-7) of each ray at that ray's largest entry of the block."""
    pos = p[:4].abs().amax(dim=0, keepdim=True).expand(4, -1)
    dirs = p[4:8].abs().amax(dim=0, keepdim=True).expand(4, -1)
    return torch.cat((pos, dirs, p[8:].abs()))


def assert_backward_close(kernel, plain, dtype, state_blocks=False):
    """``state_blocks``: hold d_state0 at float64 with each ray's position
    and direction rows at the scale of that ray's block (rounding of a
    large cotangent lands on all three components, where the exact value
    of one may cancel to nothing)."""
    for name, k, p in zip(("d_objtx", "d_prim", "d_glass", "d_state0"), kernel, plain):
        assert torch.isfinite(k).all(), name
        if dtype == torch.float64 and name == "d_state0" and state_blocks:
            scale = TOL64["rtol"] * ray_block_scale(p) + TOL64["atol"]
            assert bool(((k - p).abs() <= scale).all()), name
        elif dtype == torch.float64:
            torch.testing.assert_close(k, p, msg=name, **TOL64)
        elif name == "d_state0":
            rows = p.abs().amax(dim=1, keepdim=True)
            if p.dtype != k.dtype:  # a float64 reference (ILL_CONDITIONED32)
                # float32 rounding of a position's or direction's cotangent
                # lands on all three components (normalization mixes them),
                # where float64 may cancel one to ~1e-14: hold those rows
                # at their block's scale
                rows = torch.cat((rows[:4].amax().expand(4, 1), rows[4:8].amax().expand(4, 1),
                                  rows[8:]))
            scale = REL32 * rows + 1e-6
            ok = ((k - p).abs() <= scale).all(dim=0)
            assert ok.float().mean() >= MIN_AGREE32, name
        else:
            assert float((k - p).abs().max()) <= REL32 * float(p.abs().max()) + 1e-6, name


@pytest.mark.cuda
@pytest.mark.parametrize("name, dtype", CASES)
def test_generic_backward_matches_plain(cuda, name, dtype):
    spec, config, (inputs, records, masks), ref = backward_inputs(name, cuda, dtype)
    ref_inputs, ref_records, ref_masks = ref
    gen = torch.Generator(device="cpu").manual_seed(3)
    d_records = torch.randn(records.shape, generator=gen, dtype=torch.float64).to(cuda)
    d_fstate = torch.randn(inputs[0].shape, generator=gen, dtype=torch.float64).to(cuda)
    before = fg.fused_bwd.launches
    kernel = fg.fused_bwd(spec, config, *inputs, records, masks, d_records.to(dtype),
                          d_fstate.to(dtype))
    assert fg.fused_bwd.launches == before + 1
    plain = fg.fused_bwd_plain(spec, config, *ref_inputs, ref_records, ref_masks,
                               d_records.to(ref_records.dtype), d_fstate.to(ref_records.dtype))
    torch.cuda.synchronize()
    assert float(kernel[0].abs().max()) > 0
    assert_backward_close(kernel, plain, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("name, dtype", CASES)
def test_loss_backward_matches_plain(cuda, name, dtype):
    spec, config, (inputs, records, masks), ref = backward_inputs(name, cuda, dtype)
    ref_inputs, ref_records, ref_masks = ref
    one = torch.ones((), device=cuda)
    for loss in detector_losses(records, masks):
        plan = fg.loss_plan(loss)
        scal = plan.row(plan.scalars(records, masks), one)
        before = fg.fused_bwd_loss.launches
        kernel = fg.fused_bwd_loss(spec, config, *inputs, records, masks, scal, plan)
        assert fg.fused_bwd_loss.launches == before + 1
        ref_scal = plan.row(plan.scalars(ref_records, ref_masks), one)
        plain = fg.fused_bwd_loss_plain(spec, config, *ref_inputs, ref_records, ref_masks,
                                        ref_scal, plan)
        torch.cuda.synchronize()
        assert_backward_close(kernel, plain, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("name", ["grad:imager", "grad:hetero_row", "grad:condenser"])
def test_backward_repeats_bit_identical(cuda, name, dtype):
    """Two K3 and two K4 launches on the same inputs give the same bits
    (fixed lanes, shuffle trees and warp order in the per-warp fold, a
    fixed-order reduce of the block partials, no atomics)."""
    spec, config, (inputs, records, masks), _ = backward_inputs(name, cuda, dtype)
    loss = detector_losses(records, masks)[0]
    plan = fg.loss_plan(loss)
    scal = plan.row(plan.scalars(records, masks), torch.ones((), device=cuda))
    first = fg.fused_bwd_loss(spec, config, *inputs, records, masks, scal, plan)
    second = fg.fused_bwd_loss(spec, config, *inputs, records, masks, scal, plan)
    for a, b in zip(first, second):
        assert torch.equal(a, b)
    gen = torch.Generator(device="cpu").manual_seed(3)
    d_records = torch.randn(records.shape, generator=gen, dtype=torch.float64).to(cuda, dtype)
    d_fstate = torch.randn(inputs[0].shape, generator=gen, dtype=torch.float64).to(cuda, dtype)
    first = fg.fused_bwd(spec, config, *inputs, records, masks, d_records, d_fstate)
    second = fg.fused_bwd(spec, config, *inputs, records, masks, d_records, d_fstate)
    for a, b in zip(first, second):
        assert torch.equal(a, b)
    assert float(first[0].abs().max()) > 0


# K3 and K4 at more rays than the parity scenes carry: 2**17 (a thousand
# blocks, every warp full) and 1000 (a last warp of 8 lanes and a last block
# of 104 threads), on the condenser and on the 31-leaf hetero row, whose
# unsorted line puts rays on many leaves and glasses into every warp
SCALE_CASES = [(name, n, dtype) for name in ("grad:condenser", "grad:hetero_row")
               for n in (1 << 17, 1000) for dtype in (torch.float64, torch.float32)]


@pytest.mark.cuda
@pytest.mark.parametrize("name, n, dtype", SCALE_CASES)
def test_backward_at_scale_matches_plain(cuda, name, n, dtype):
    """As test_generic_backward_matches_plain and
    test_loss_backward_matches_plain, on more rays."""
    spec, config, (inputs, records, masks), ref = backward_inputs(name, cuda, dtype, n)
    ref_inputs, ref_records, ref_masks = ref
    gen = torch.Generator(device="cpu").manual_seed(3)
    d_records = torch.randn(records.shape, generator=gen, dtype=torch.float64).to(cuda)
    d_fstate = torch.randn(inputs[0].shape, generator=gen, dtype=torch.float64).to(cuda)
    kernel = fg.fused_bwd(spec, config, *inputs, records, masks, d_records.to(dtype),
                          d_fstate.to(dtype))
    plain = fg.fused_bwd_plain(spec, config, *ref_inputs, ref_records, ref_masks,
                               d_records.to(ref_records.dtype), d_fstate.to(ref_records.dtype))
    torch.cuda.synchronize()
    assert float(kernel[0].abs().max()) > 0
    blocks = name in ILL_CONDITIONED32
    assert_backward_close(kernel, plain, dtype, state_blocks=blocks)
    one = torch.ones((), device=cuda)
    for loss in detector_losses(records, masks):
        plan = fg.loss_plan(loss)
        scal = plan.row(plan.scalars(records, masks), one)
        kernel = fg.fused_bwd_loss(spec, config, *inputs, records, masks, scal, plan)
        ref_scal = plan.row(plan.scalars(ref_records, ref_masks), one)
        plain = fg.fused_bwd_loss_plain(spec, config, *ref_inputs, ref_records, ref_masks,
                                        ref_scal, plan)
        torch.cuda.synchronize()
        assert_backward_close(kernel, plain, dtype, state_blocks=blocks)


@pytest.mark.cuda
def test_backward_wrappers_reject_bad_inputs(cuda):
    spec, config, (inputs, records, masks), _ = backward_inputs("condenser", cuda, torch.float32)
    d_records = torch.zeros_like(records)
    d_fstate = torch.zeros_like(inputs[0])
    with pytest.raises(ValueError, match="contiguous"):
        fg.fused_bwd(spec, config, *inputs, records, masks, d_records.transpose(0, 2)
                     .contiguous().transpose(0, 2), d_fstate)
    with pytest.raises(ValueError, match="float32"):
        fg.fused_bwd(spec, config, *inputs, records.double(), masks, d_records, d_fstate)
    with pytest.raises(ValueError, match="shape"):
        fg.fused_bwd(spec, config, *inputs, records[:2].contiguous(), masks, d_records, d_fstate)
    with pytest.raises(ValueError, match="on cuda"):  # mixed devices
        fg.fused_bwd(spec, config, *(t.cpu() for t in inputs), records, masks, d_records, d_fstate)
    plan = fg.loss_plan(metrics.RmsSpotRadius(1.0))
    with pytest.raises(ValueError, match="scalar row"):
        fg.fused_bwd_loss(spec, config, *inputs, records, masks, torch.zeros(40, device=cuda), plan)


@pytest.mark.cuda
def test_objective_runs_k1_and_k3_on_the_card(cuda):
    """build_objective on CUDA rays launches K1 then K3, and its theta
    gradient equals the plain engine's."""
    from pyrayt_tpu_torch.analysis import build_objective

    build, _, _, gens, _ = GRAD_SCENES["condenser"]
    rays = interop.rays_from_numpy(*grad_rays("condenser"), device=cuda, dtype=torch.float64)

    def build_fn(theta):
        lens = TORCH_NS.comp.thick_lens(theta[0], -1.0, 0.25, aperture=0.5, r1_sign=1,
                                       material=TORCH_NS.matl.glass["BK7"])
        return [lens.move_x(theta[1]), TORCH_NS.comp.baffle((1.0, 1.0)).move_x(1.0)]

    with TORCH_NS.fresh_ids():
        sid = float(TORCH_NS.compile(build_fn([1.0, 0.0])).spec.leaf_ids[-1])
    loss = metrics.RmsSpotRadius(sid)
    grads = []
    for use_fused in (None, False):
        objective = build_objective(build_fn, rays, loss,
                                    TraceConfig(generation_limit=gens, use_fused=use_fused))
        theta = torch.tensor([1.0, 0.02], dtype=torch.float64, device=cuda, requires_grad=True)
        k1, k3 = ft.fused_trace.launches, fg.fused_bwd_loss.launches
        (g,) = torch.autograd.grad(objective(theta), theta)
        launched = (ft.fused_trace.launches - k1, fg.fused_bwd_loss.launches - k3)
        assert launched == ((1, 1) if use_fused is None else (0, 0))
        grads.append(g)
    torch.testing.assert_close(grads[0], grads[1], **TOL64)
    assert float(grads[0].abs().max()) > 0


# ---------------------------------------------------------------------------
# the wide forward kernel K2 and the staged wide backward K5 (tail), K6
# (group) and K7 (singles) against their plain versions
# ---------------------------------------------------------------------------

from torch_parity_scenes import (  # noqa: E402
    WIDE_SCENES,
    far_rays,
    mla,
    rehit_free32,
    sphere_lens_wall,
    wide_rays,
)

WIDE_CASES = [(name, dtype) for name in sorted(WIDE_SCENES)
              for dtype in (torch.float64, torch.float32)]
WIDE_BWD_CASES = WIDE_CASES
# The meniscus wall at float32: a ray that leaves the aperture cylinder
# almost parallel to its axis starts 1e-6 off the wall, where the root
# behind it is smaller than the float32 rounding of the textbook quadratic
# formula, so rounding decides whether a recompute finds the wall again
# 1e-6 ahead.  The plain forward's own trace does so on 9 of the 1024 rays;
# K6 and K8, recomputing from the plain records with FMAs, on 4 others,
# whose leaf cotangents then part from the plain version's by up to 134.6
# of 285.4 (tests/test_torch/card_wide_ray_split.py on an H100; ROADMAP F2).
# The plain float32 recompute does the same on the float64 trace's records
# (test_torch_grad.py::test_meniscus_float32_rehits_are_ill_conditioned).
# So the backward tests hold its float32 cases on the rays that cannot
# re-hit that way (torch_parity_scenes.rehit_free32 on the float64 trace).
REHIT_PRONE32 = ("meniscus",)
REHIT_FREE_SHARE = 0.6


def wide_inputs(name, device, dtype, rehit_free=False):
    """(spec, config, K2 inputs (state, obj_tx, prim, glass, slots, aabb, cull)),
    float64 scene math cast to ``dtype``; ``rehit_free`` keeps only the
    rays whose float32 trace cannot re-hit the surface it just left."""
    build, _, _, gens = WIDE_SCENES[name]
    with TORCH_NS.fresh_ids():
        scene = TORCH_NS.compile(build(TORCH_NS), device=device, dtype=torch.float64)
    config = TraceConfig(generation_limit=gens, fixed_loop=True)
    pos, dirs, meta = wide_rays(name)
    if rehit_free:
        rays64 = interop.rays_from_numpy(pos, dirs, meta, device=device, dtype=torch.float64)
        inputs64 = ft.wide_kernel_inputs(scene.spec, scene.params, rays64)
        rec, masks, _ = ft.fused_trace_wide_plain(scene.spec, config, *inputs64)
        keep = rehit_free32(scene.spec, inputs64[1], inputs64[2], rec, masks).cpu().numpy()
        assert keep.mean() >= REHIT_FREE_SHARE
        pos, dirs, meta = pos[:, keep], dirs[:, keep], meta[:, keep]
    rays = interop.rays_from_numpy(pos, dirs, meta, device=device, dtype=dtype)
    inputs = ft.wide_kernel_inputs(scene.spec, scene.params, rays)
    return scene.spec, config, inputs


def agreeing_rays(k_masks, p_masks, k_win, p_win):
    return (k_masks == p_masks).all(dim=0) & (k_win == p_win).all(dim=0)


@pytest.mark.cuda
@pytest.mark.parametrize("name, dtype", WIDE_CASES)
def test_wide_kernel_matches_plain(cuda, name, dtype):
    spec, config, inputs = wide_inputs(name, cuda, dtype)
    before = ft.fused_trace_wide.launches
    k_rec, k_mask, k_fin, k_fold, k_win = ft.fused_trace_wide(spec, config, *inputs, save_fold=True)
    assert ft.fused_trace_wide.launches == before + 1
    p_rec, p_mask, p_fin, p_fold, p_win = ft.fused_trace_wide_plain(spec, config, *inputs,
                                                                   save_fold=True)
    torch.cuda.synchronize()
    assert k_win.dtype == torch.int32 and int(k_mask.sum()) > 100
    fold_k = torch.where(torch.isinf(k_fold), 0.0, k_fold)
    fold_p = torch.where(torch.isinf(p_fold), 0.0, p_fold)
    assert torch.equal(torch.isinf(k_fold), torch.isinf(p_fold)) or dtype == torch.float32
    if dtype == torch.float64:
        assert torch.equal(k_mask, p_mask) and torch.equal(k_win, p_win)
        for k, p in ((k_rec, p_rec), (k_fin, p_fin), (fold_k, fold_p)):
            torch.testing.assert_close(k, p, rtol=1e-9, atol=1e-9)
        return
    agree = agreeing_rays(k_mask, p_mask, k_win, p_win)
    assert agree.float().mean() >= MIN_AGREE32
    for k, p in ((k_rec, p_rec), (k_fin, p_fin), (fold_k, fold_p)):
        torch.testing.assert_close(k[..., agree], p[..., agree], rtol=1e-4, atol=1e-4)
    # without save_fold the same trace comes back
    again = ft.fused_trace_wide(spec, config, *inputs)
    assert len(again) == 3 and torch.equal(again[0], k_rec) and torch.equal(again[1], k_mask)


def staged_inputs(name, device, dtype):
    """A wide scene's plain forward (records, masks, fold5, win) plus seeded
    cotangents: both versions of each backward kernel read the same
    inputs (a REHIT_PRONE32 scene at float32: its rehit-free rays)."""
    spec, config, inputs = wide_inputs(
        name, device, dtype, rehit_free=dtype == torch.float32 and name in REHIT_PRONE32)
    rec, masks, _, fold5, win = ft.fused_trace_wide_plain(spec, config, *inputs, save_fold=True)
    gen = torch.Generator(device="cpu").manual_seed(11)
    n, g = masks.shape[1], masks.shape[0]
    carry = torch.randn((g, 11, n), generator=gen, dtype=torch.float64).to(device, dtype)
    d_rec = torch.randn(rec.shape, generator=gen, dtype=torch.float64).to(device, dtype)
    d_rec = d_rec * masks[:, None]
    sid = float(spec.leaf_ids[-1])
    plan = fg.loss_plan(metrics.RmsSpotRadius(sid))
    scal = plan.row(plan.scalars(rec, masks), torch.ones((), device=device))
    return spec, config, inputs, (rec, masks, fold5, win), carry, d_rec, plan, scal


def assert_rows_close(k, p, dtype, per_ray):
    assert torch.isfinite(k).all()
    if dtype == torch.float64:
        torch.testing.assert_close(k, p, **TOL64)
    elif per_ray:
        scale = REL32 * p.abs().amax(dim=1, keepdim=True) + 1e-6
        assert ((k - p).abs() <= scale).all(dim=0).float().mean() >= MIN_AGREE32
    else:
        assert float((k - p).abs().max()) <= REL32 * float(p.abs().max()) + 1e-6


@pytest.mark.cuda
@pytest.mark.parametrize("name, dtype", WIDE_CASES)
def test_staged_tail_matches_plain(cuda, name, dtype):
    spec, config, inputs, (rec, masks, fold5, win), carry, d_rec, plan, scal = staged_inputs(
        name, cuda, dtype)
    state0, glass = inputs[0], inputs[3]
    for g in range(masks.shape[0]):
        pmask = masks[g - 1] if g else None
        for kw in (dict(d_rec=d_rec[g]), dict(scal=scal, plan=plan)):
            before = fg.staged_tail.launches
            kernel = fg.staged_tail(spec, config, state0, rec[g], masks[g], pmask, fold5[g], glass,
                                    carry[g], **kw)
            assert fg.staged_tail.launches == before + 1
            plain = fg.staged_tail_plain(spec, config, state0, rec[g], masks[g], pmask, fold5[g],
                                         glass, carry[g], **kw)
            torch.cuda.synchronize()
            for k, p, per_ray in zip(kernel, plain, (True, True, False)):
                assert_rows_close(k, p, dtype, per_ray)


@pytest.mark.cuda
@pytest.mark.parametrize("name, dtype", WIDE_BWD_CASES)
def test_staged_fold_matches_plain(cuda, name, dtype):
    spec, config, inputs, (rec, masks, fold5, win), carry, d_rec, plan, scal = staged_inputs(
        name, cuda, dtype)
    state0, obj_tx, prim, glass, slots = inputs[:5]
    n_groups = len(ft.engine.wide_plan(spec)[1])
    for g in range(masks.shape[0]):
        buf, _, _ = fg.staged_tail_plain(spec, config, state0, rec[g], masks[g],
                                         masks[g - 1] if g else None, fold5[g], glass, carry[g],
                                         d_rec=d_rec[g])
        calls = [(fg.staged_group, fg.staged_group_plain, (spec, gi, buf, win[g], obj_tx, prim),
                  (slots,), (slots,)) for gi in range(n_groups)]
        calls.append((fg.staged_singles, fg.staged_singles_plain, (spec, buf, win[g], obj_tx, prim),
                      (slots,), ()))
        for wrapper, plain_fn, args, k_extra, p_extra in calls:
            before = wrapper.launches
            kernel = wrapper(*args, *k_extra)
            assert wrapper.launches == before + 1
            plain = plain_fn(*args, *p_extra)
            torch.cuda.synchronize()
            for k, p, per_ray in zip(kernel, plain, (False, False, True)):
                assert_rows_close(k, p, dtype, per_ray)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_staged_backward_repeats_bit_identical(cuda, dtype):
    spec, config, inputs, (rec, masks, fold5, win), carry, d_rec, plan, scal = staged_inputs(
        "csg_singles", cuda, dtype)
    state0, obj_tx, prim, glass, slots = inputs[:5]
    first = fg.staged_bwd(spec, config, state0, obj_tx, prim, glass, slots, rec, masks, fold5,
                          win, scal=scal, plan=plan)
    second = fg.staged_bwd(spec, config, state0, obj_tx, prim, glass, slots, rec, masks, fold5,
                           win, scal=scal, plan=plan)
    for a, b in zip(first, second):
        assert torch.equal(a, b)
    assert float(first[0].abs().max()) > 0


@pytest.mark.cuda
def test_wide_objective_runs_k2_and_the_staged_backward(cuda):
    """build_objective on CUDA rays through a 5x5 array launches K2, K5, K6
    and K7, and its per-lenslet radius gradient equals the plain engine's."""
    from pyrayt_tpu_torch.analysis import build_objective

    rays = interop.rays_from_numpy(*wide_rays("mla5"), device=cuda, dtype=torch.float64)

    def build_fn(radii):
        lenslets = TORCH_NS.comp.microlens_array(radii, 0.25, 5, 5, 1.0)
        return lenslets + [TORCH_NS.comp.baffle((10.0, 10.0)).move_x(4.0)]

    radii0 = [2.0 + 0.01 * k for k in range(25)]
    with TORCH_NS.fresh_ids():
        sid = float(TORCH_NS.compile(build_fn(radii0), device=cuda).spec.leaf_ids[-1])
    grads = []
    counters = (ft.fused_trace_wide, fg.staged_tail, fg.staged_group, fg.staged_singles)
    for use_fused in (None, False):
        objective = build_objective(build_fn, rays, metrics.RmsSpotRadius(sid),
                                    TraceConfig(generation_limit=4, use_fused=use_fused))
        radii = torch.tensor(radii0, dtype=torch.float64, device=cuda, requires_grad=True)
        before = [c.launches for c in counters]
        (g,) = torch.autograd.grad(objective(radii), radii)
        launched = [c.launches - b for c, b in zip(counters, before)]
        if use_fused is None:
            assert launched[0] == 1 and all(k > 0 for k in launched[1:]), launched
        else:
            assert launched == [0, 0, 0, 0]
        grads.append(g)
    torch.testing.assert_close(grads[0], grads[1], **TOL64)
    assert float(grads[0].abs().max()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("name, dtype", WIDE_BWD_CASES)
def test_wide_fused_bwd_matches_plain(cuda, name, dtype):
    """K8 against its plain version on the plain forward's records, both
    modes; two launches bit-identical; at float64 also against the staged
    backward, which reads the fold the forward saved."""
    spec, config, inputs, (rec, masks, fold5, win), _, d_rec, plan, scal = staged_inputs(
        name, cuda, dtype)
    gen = torch.Generator(device="cpu").manual_seed(13)
    d_fstate = torch.randn(inputs[0].shape, generator=gen, dtype=torch.float64).to(cuda, dtype)
    for kw in (dict(d_records=d_rec, d_fstate=d_fstate), dict(scal=scal, plan=plan)):
        before = fg.fused_bwd_wide.launches
        kernel = fg.fused_bwd_wide(spec, config, *inputs, rec, masks, **kw)
        again = fg.fused_bwd_wide(spec, config, *inputs, rec, masks, **kw)
        assert fg.fused_bwd_wide.launches == before + 2
        plain = fg.fused_bwd_wide_plain(spec, config, *inputs, rec, masks, **kw)
        torch.cuda.synchronize()
        for k, a, p, per_ray in zip(kernel, again, plain, (False, False, False, True)):
            assert torch.equal(k, a)
            assert_rows_close(k, p, dtype, per_ray)
        assert float(kernel[0].abs().max()) > 0
        if dtype == torch.float64:
            state0, obj_tx, prim, glass, slots = inputs[:5]
            staged = fg.staged_bwd(spec, config, state0, obj_tx, prim, glass, slots, rec, masks,
                                   fold5, win, **kw)
            for k, s in zip(kernel, staged):
                torch.testing.assert_close(k, s, **TOL64)


FAR_SCENES = {"mla16": (lambda m: mla(m, 16), 8.0), "sphere_lenses": (sphere_lens_wall, 6.6)}


def open_cull(spec, cull):
    """A cull table whose boxes hold everything (slopes 0): K2 then
    evaluates every tree, in the same order and arithmetic as with its
    real table."""
    table = torch.empty_like(cull)
    table[:, :3], table[:, 3:] = -1e30, 1e30
    table[list(ft.cull_offsets(spec)[0])] = 0.0
    return table


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(FAR_SCENES))
@pytest.mark.parametrize("dist", [1e3, 1e4])
def test_wide_kernel_far_origins(cuda, name, dist):
    """Rays from origins 1e3 and 1e4 away, where rounding in the
    intersectors grows with the distance: K2 with its cull table gives bit
    for bit what K2 gives when every box holds everything (the pads and
    cones never drop a winner of the kernel's own arithmetic), at float64
    and float32; at float64 its first generation's masks and win codes
    also equal the unculled plain version's."""
    build, half = FAR_SCENES[name]
    with TORCH_NS.fresh_ids():
        scene = TORCH_NS.compile(build(TORCH_NS), device=cuda, dtype=torch.float64)
    spec = scene.spec
    p, v = far_rays(4096, dist, half, seed=5)
    n = p.shape[1]
    pos = np.concatenate((p.numpy(), np.ones((1, n))))
    dirs = np.concatenate((v.numpy(), np.zeros((1, n))))
    meta = np.stack((np.zeros(n), np.full(n, 100.0), np.full(n, 0.633), np.ones(n),
                     np.arange(n, dtype=float)))
    config = TraceConfig(generation_limit=4, fixed_loop=True)
    for dtype in (torch.float64, torch.float32):
        rays = interop.rays_from_numpy(pos, dirs, meta, device=cuda, dtype=dtype)
        inputs = ft.wide_kernel_inputs(spec, scene.params, rays)
        culled = ft.fused_trace_wide(spec, config, *inputs, save_fold=True)
        unculled = ft.fused_trace_wide(spec, config, *inputs[:6], open_cull(spec, inputs[6]),
                                       save_fold=True)
        torch.cuda.synchronize()
        assert int((culled[4][0] >= 0).sum()) > n // 4
        for a, b in zip(culled, unculled):
            assert torch.equal(a, b), dtype
        if dtype == torch.float64:
            plain = ft.fused_trace_wide_plain(spec, TraceConfig(generation_limit=1), *inputs,
                                              save_fold=True)
            assert torch.equal(culled[1][0], plain[1][0]) and torch.equal(culled[4][0], plain[4][0])


@pytest.mark.cuda
def test_wide_objective_runs_k2_and_k8(cuda):
    """build_objective with ``wide_grad="fused"`` on CUDA rays through a 5x5
    array launches K2 and K8 (no staged kernel), and its per-lenslet radius
    gradient equals the plain engine's."""
    from pyrayt_tpu_torch.analysis import build_objective

    rays = interop.rays_from_numpy(*wide_rays("mla5"), device=cuda, dtype=torch.float64)

    def build_fn(radii):
        lenslets = TORCH_NS.comp.microlens_array(radii, 0.25, 5, 5, 1.0)
        return lenslets + [TORCH_NS.comp.baffle((10.0, 10.0)).move_x(4.0)]

    radii0 = [2.0 + 0.01 * k for k in range(25)]
    with TORCH_NS.fresh_ids():
        sid = float(TORCH_NS.compile(build_fn(radii0), device=cuda).spec.leaf_ids[-1])
    grads = []
    counters = (ft.fused_trace_wide, fg.fused_bwd_wide, fg.staged_tail, fg.staged_group,
                fg.staged_singles)
    for use_fused in (None, False):
        objective = build_objective(build_fn, rays, metrics.RmsSpotRadius(sid),
                                    TraceConfig(generation_limit=4, use_fused=use_fused,
                                                wide_grad="fused"))
        radii = torch.tensor(radii0, dtype=torch.float64, device=cuda, requires_grad=True)
        before = [c.launches for c in counters]
        (g,) = torch.autograd.grad(objective(radii), radii)
        launched = [c.launches - b for c, b in zip(counters, before)]
        assert launched == ([1, 1, 0, 0, 0] if use_fused is None else [0] * 5), launched
        grads.append(g)
    torch.testing.assert_close(grads[0], grads[1], **TOL64)
    assert float(grads[0].abs().max()) > 0


# ---------------------------------------------------------------------------
# the table reduce of K6, K7 and K8 alone, and inside them
# ---------------------------------------------------------------------------

from torch_parity_scenes import reduce_inputs, reduce_key_sets  # noqa: E402

REDUCE_KEY_SETS = reduce_key_sets(1 << 17)
REDUCE_CASES = [(name, dtype) for name in sorted(REDUCE_KEY_SETS)
                for dtype in (torch.float64, torch.float32)]


@pytest.mark.cuda
@pytest.mark.parametrize("name, dtype", REDUCE_CASES)
def test_row_reduce_matches_plain(cuda, name, dtype):
    """The counting-sort reduce against its plain version on the adversarial
    key sets (every key -1, one row, 4096 rows, a detector-like skew, one
    entry, a ragged length); two launches bit-identical; NaN values behind
    the -1 keys are never read."""
    keys_np, rows = REDUCE_KEY_SETS[name]
    keys, vals, slots = reduce_inputs(keys_np, rows, dtype, cuda)
    before = fg.row_reduce.launches
    kernel = fg.row_reduce(keys, vals, slots, rows, rows + 3)
    again = fg.row_reduce(keys, vals, slots, rows, rows + 3)
    assert fg.row_reduce.launches == before + 2
    plain = fg.row_reduce_plain(keys, vals, slots, rows, rows + 3)
    torch.cuda.synchronize()
    for k, a, p in zip(kernel, again, plain):
        assert torch.equal(k, a)
        assert_rows_close(k, p, dtype, per_ray=False)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_row_reduce_is_the_sum_k6_and_k8_end_with(cuda, dtype, monkeypatch):
    """The reduce alone on the table K6 (and K8) filled gives their table
    cotangents bit for bit, and its plain version agrees with them."""
    spec, config, inputs, (rec, masks, fold5, win), carry, d_rec, plan, scal = staged_inputs(
        "mla6", cuda, dtype)
    state0, obj_tx, prim, glass, slots = inputs[:5]
    tables = []
    make = fg._reduce_table

    def keep(*args):
        tables.append(make(*args))
        return tables[-1]

    monkeypatch.setattr(fg, "_reduce_table", keep)
    buf, _, _ = fg.staged_tail_plain(spec, config, state0, rec[0], masks[0], None, fold5[0], glass,
                                     carry[0], d_rec=d_rec[0])
    info = fg._group_entry(spec, 0)
    reduce_slots = slots[info["off"]:info["off"] + info["T"] * info["L"]]
    d_obj, d_prim, _ = fg.staged_group(spec, 0, buf, win[0], obj_tx, prim, slots)
    k8 = fg.fused_bwd_wide(spec, config, *inputs, rec, masks, scal=scal, plan=plan)
    k6_keys, k6_vals = tables[0]
    k8_keys, k8_vals = (t.reshape(-1, *t.shape[2:]) for t in tables[1])
    s_count = spec.n_leaves
    alone = fg.row_reduce(k6_keys, k6_vals, reduce_slots, reduce_slots.numel(), s_count)
    assert torch.equal(alone[0], d_obj) and torch.equal(alone[1], d_prim)
    all_slots = torch.arange(s_count, dtype=torch.int32, device=cuda)
    alone8 = fg.row_reduce(k8_keys, k8_vals, all_slots, s_count)
    assert torch.equal(alone8[0][:, :12], k8[0][:, :12]) and torch.equal(alone8[1], k8[1])
    for keys, vals, rs, k in ((k6_keys, k6_vals, reduce_slots, (d_obj, d_prim)),
                              (k8_keys, k8_vals, all_slots, alone8)):
        vals = torch.where((keys >= 0)[:, None], vals, 0.0)  # unwritten entries
        plain = fg.row_reduce_plain(keys, vals, rs, rs.numel(), s_count)
        for a, b in zip(k, plain):
            assert_rows_close(a, b, dtype, per_ray=False)
    assert int((k6_keys >= 0).sum()) > 0 and int((k8_keys >= 0).sum()) > 0


# ---------------------------------------------------------------------------
# parallel/: pad_rayset's dead rays through every kernel, and ranks on the card
# ---------------------------------------------------------------------------

ROUTE_KERNELS = {
    "narrow": ("fused_trace", "fused_bwd"),
    "staged": ("fused_trace_wide", "staged_tail", "staged_group", "staged_singles"),
    "fused": ("fused_trace_wide", "fused_bwd_wide"),
}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("route", sorted(ROUTE_KERNELS))
def test_padded_rays_through_the_kernels(cuda, route, dtype):
    """Padding rays (zero direction, w = 1, zero metadata) through K1 + K4,
    K2 (with its cull) + K5/K6/K7 and K2 + K8: no record, zero cotangents,
    finite gradients equal to the unpadded trace's."""
    from torch_parallel_worlds import launch_counts, padded_ray_contract

    before = launch_counts()
    out = padded_ray_contract(route, cuda, dtype)
    torch.cuda.synchronize()
    launched = {k: v - before[k] for k, v in launch_counts().items()}
    assert all(launched[k] > 0 for k in ROUTE_KERNELS[route]), launched
    assert out["n_padded"] > 0 and out["valid_masks"] > 0
    assert not out["pad_masks"].any() and torch.all(out["pad_records"] == 0)
    assert torch.all(out["pad_d_positions"] == 0) and torch.all(out["pad_d_directions"] == 0)
    tol = TOL64 if dtype == torch.float64 else dict(rtol=1e-5, atol=1e-6)
    for key, grad in out["grads"].items():
        assert torch.isfinite(grad).all(), key
        torch.testing.assert_close(grad, out["unpadded_grads"][key], **tol)


@pytest.mark.cuda
def test_two_gloo_ranks_on_the_card_trace_like_one_launch(cuda, tmp_path):
    """A 2-rank gloo world on one card: each rank's K1 and K2 trace of its
    block, gathered, equals one launch over every ray, bit for bit."""
    from torch_parallel_worlds import World
    from torch_parity_scenes import grid_rays

    ft.build_kernels()  # once here: the ranks load the libraries
    inputs = {"narrow": dict(zip(("pos", "dirs", "meta"), numpy_rays((-0.5, 0.0, 0.0), 10.0,
                                                                     4095))),
              "wide": dict(zip(("pos", "dirs", "meta"), grid_rays(4.5, 4.5, -1.0, 4095)))}
    torch.save(inputs, tmp_path / "inputs.pt")
    ranks = World("card_trace", 2, tmp_path, backend="gloo", device="cuda").wait()
    for out in ranks:
        for key, case in out.items():
            kernel = "fused_trace" if key.startswith("narrow") else "fused_trace_wide"
            assert case["launched"][kernel] == 1, (key, case["launched"])
            assert case["equal"] and case["records"] > 0, key

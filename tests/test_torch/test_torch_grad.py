"""Gradient parity of the port's plain backward (the oracle of the CUDA
kernels K3/K4) against ``jax.grad`` of the JAX package's engine, float64.

Two port paths are held against the JAX engine's gradient of the spot
radius on the five scenes of tests/test_ops/test_fused_grad.py (condenser,
spherical mirror, glass coefficients under a wavelength spread, a union
blob through the network CSG, the nine-leaf imager), at that file's
tolerance (rtol 1e-8, atol 1e-10):

* autograd of the plain engine;
* ``build_fused_vjp_trace_fn``, whose backward on CPU tensors is
  ``fused_bwd_plain``: the kernel's reverse sweep over record-rebuilt
  states.

The rest pins which generations a ray ran.  The union blob and the imager
are in test_torch_grad_csg.py; final-ray and initial-ray cotangents in
test_torch_grad_rays.py (the JAX gradients take seconds each).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyrayt_tpu.analysis.metrics import rms_spot_radius as j_rms
from pyrayt_tpu.config import TraceConfig as JConfig
from pyrayt_tpu.tracer import engine as j_engine
from pyrayt_tpu_torch.analysis.metrics import rms_spot_radius
from pyrayt_tpu_torch.config import TraceConfig
from pyrayt_tpu_torch.ops import fused_grad as fg
from pyrayt_tpu_torch.ops import fused_trace as ft
from pyrayt_tpu_torch.tracer import engine
from torch_parity_scenes import (
    GRAD_SCENES,
    TORCH_NS,
    WIDE_SCENES,
    follows_float64_path,
    grad_rays,
    rehit_free32,
    wide_rays,
)

TOL = dict(rtol=1e-8, atol=1e-10)
_JAX_GRADS = {}


def jax_param_grads(twins, name, loss=j_rms):
    """(value, grads) of ``loss`` through the JAX engine, cached per scene."""
    key = (name, loss)
    if key not in _JAX_GRADS:
        j_scene, _, j_rays, _, gens = twins.grad_inputs(name)
        fn = j_engine.build_trace_fn(
            j_scene.spec, j_scene.materials, JConfig(generation_limit=gens, fixed_loop=True)
        )
        value, grads = jax.jit(jax.value_and_grad(lambda p: loss(fn(p, j_rays))))(j_scene.params)
        _JAX_GRADS[key] = (float(value), {k: np.asarray(v) for k, v in grads.items()})
    return _JAX_GRADS[key]


def port_param_grads(t_scene, t_rays, gens, path, loss=rms_spot_radius):
    params = {k: v.clone().requires_grad_(True) for k, v in t_scene.params.items()}
    if path == "engine":
        fn = engine.build_trace_fn(
            t_scene.spec, t_scene.materials, TraceConfig(generation_limit=gens, fixed_loop=True)
        )
    else:
        fn = fg.build_fused_vjp_trace_fn(
            t_scene.spec, t_scene.materials, TraceConfig(generation_limit=gens)
        )
    value = loss(fn(params, t_rays))
    grads = torch.autograd.grad(value, list(params.values()), allow_unused=True)
    return float(value.detach()), {
        k: (torch.zeros_like(v) if g is None else g).numpy()
        for (k, v), g in zip(params.items(), grads)
    }


def assert_param_grads_match(twins, name, path):
    value_j, grads_j = jax_param_grads(twins, name)
    _, t_scene, _, t_rays, gens = twins.grad_inputs(name)
    value, grads = port_param_grads(t_scene, t_rays, gens, path)
    assert value == pytest.approx(value_j, rel=1e-12)
    for key in ("world", "prim", "glass"):
        np.testing.assert_allclose(grads[key], grads_j[key], err_msg=key, **TOL)
    return grads_j


@pytest.mark.parametrize("path", ["engine", "fused_bwd_plain"])
@pytest.mark.parametrize("name", ["condenser", "mirror", "glass_coeffs", "hetero_row"])
def test_param_grads_match_jax(twins, name, path):
    grads = assert_param_grads_match(twins, name, path)
    assert np.abs(grads["world"]).max() > 1e-6  # the gradient is real
    if name == "glass_coeffs":
        assert np.abs(grads["glass"]).max() > 1e-10  # dispersion is differentiated


# ---------------------------------------------------------------------------
# which generations a ray ran
# ---------------------------------------------------------------------------


def _skip_scene(m):
    """Two facing mirrors (a ray between them is alive at the horizon) and
    a baffle off to the side (a ray absorbed in generation 0)."""
    m1 = m.comp.plane_mirror(0.1, aperture=4.0)
    m2 = m.comp.plane_mirror(0.1, aperture=4.0).move_x(2.0)
    return [m1, m2, m.comp.baffle((2.0, 2.0)).move_x(5.0).move_y(10.0)]


def _skip_rays():
    # alive at the horizon, misses, absorbed at generation 0, killed by the
    # intensity threshold (hits the mirror but its intensity is 0.05)
    pos = np.array([[1.0, 0.1, 0.0, 1.0], [1.0, 0.0, 0.3, 1.0], [4.0, 10.2, 0.1, 1.0],
                    [1.0, -0.2, 0.1, 1.0]]).T
    tilt = np.deg2rad(2.0)
    dirs = np.array([[np.cos(tilt), np.sin(tilt), 0.0, 0.0], [0.0, 0.0, 1.0, 0.0],
                     [1.0, 0.0, 0.0, 0.0], [1.0, 0.0, 0.0, 0.0]]).T
    meta = np.stack((np.zeros(4), [100.0, 100.0, 100.0, 0.05], np.full(4, 0.633), np.ones(4),
                     np.arange(4.0)))
    return pos, dirs, meta


def test_generations_ran_pins_the_skip_cases(twins):
    from pyrayt_tpu_torch import interop

    with twins.torch.fresh_ids():
        scene = twins.torch.compile(_skip_scene(twins.torch), device="cpu", dtype=torch.float64)
    rays = interop.rays_from_numpy(*_skip_rays(), device="cpu", dtype=torch.float64)
    gens = 5
    config = TraceConfig(generation_limit=gens, apply_intensity_threshold=True)
    state0, obj_tx, prim, glass = ft.kernel_inputs(scene.params, rays)
    records, masks, _ = ft.fused_trace(scene.spec, config, state0, obj_tx, prim, glass)
    ran = fg.generations_ran(records, masks)
    assert ran[:, 0].all()  # alive at the horizon: every generation
    assert ran[0, 1:].all() and not ran[1:, 1:].any()  # miss, absorbed, killed
    # the absorbed ray records its hit on the baffle, then stops
    assert masks[:, 0].all() and masks[0, 2] and not masks[0, 1] and not masks[0, 3]
    assert not masks[1:, 1:].any()

    def world_grad(fn, loss):
        params = {k: v.clone().requires_grad_(True) for k, v in scene.params.items()}
        return torch.autograd.grad(loss(fn(params, rays)), params["world"])[0]

    def engine_fn(generations):
        return engine.build_trace_fn(scene.spec, scene.materials, TraceConfig(
            generation_limit=generations, apply_intensity_threshold=True, fixed_loop=True))

    fused = fg.build_fused_vjp_trace_fn(scene.spec, scene.materials, config)

    # a loss on masked records and on the final rays of the rays that stop
    # for good (alive at the horizon, missed, absorbed): the per-ray sweep
    # equals autograd of the plain engine (a global loop)
    def loss(result):
        m = result.record_mask[:, None].to(result.records.dtype)
        hits = result.records[:, 9:12] * m
        return (hits**2).sum() + result.final_rays.positions[1, :3].sum()

    grad = world_grad(fused, loss)
    torch.testing.assert_close(grad, world_grad(engine_fn(gens), loss), rtol=1e-10, atol=1e-12)
    assert grad.abs().max() > 0

    # the threshold-killed ray stops after generation 0 with its mirror
    # direction, which a global loop keeps stepping: its final-ray
    # cotangent is that of a one-generation trace
    def killed(result):
        return result.final_rays.positions[1, 3] + result.final_rays.directions[0, 3]

    grad = world_grad(fused, killed)
    torch.testing.assert_close(grad, world_grad(engine_fn(1), killed), rtol=1e-10, atol=1e-12)
    assert grad.abs().max() > 0


def imager_float32_errors():
    """max |plain float32 - plain float64| / max |float64| of the generic
    backward's (d_objtx, d_prim, d_glass) on the imager, both fed the float64
    trace's records (float32: rounded), over all rays and over the rays
    whose float32 trace follows the float64 path; and that share of rays."""
    from pyrayt_tpu_torch import interop

    build, _, _, gens, _ = GRAD_SCENES["imager"]
    with TORCH_NS.fresh_ids():
        scene = TORCH_NS.compile(build(TORCH_NS), device="cpu", dtype=torch.float64)
    rays = interop.rays_from_numpy(*grad_rays("imager"), device="cpu", dtype=torch.float64)
    config = TraceConfig(generation_limit=gens)
    in64 = ft.kernel_inputs(scene.params, rays)
    in32 = [t.float().contiguous() for t in in64]
    records, masks, _ = ft.fused_trace_plain(scene.spec, config, *in64)
    records32, masks32, _ = ft.fused_trace_plain(scene.spec, config, *in32)
    follows = follows_float64_path(records32, masks32, records, masks)
    gen = torch.Generator().manual_seed(3)
    d_records = torch.randn(records.shape, generator=gen, dtype=torch.float64)
    d_fstate = torch.randn(in64[0].shape, generator=gen, dtype=torch.float64)
    errors = {}
    for label, keep in (("all", torch.ones_like(follows)), ("follows", follows)):
        def cut(t):
            return t[..., keep].contiguous()

        wide = fg.fused_bwd_plain(scene.spec, config, cut(in64[0]), *in64[1:], cut(records),
                                  cut(masks), cut(d_records), cut(d_fstate))
        narrow = fg.fused_bwd_plain(scene.spec, config, cut(in32[0]), *in32[1:],
                                    cut(records).float(), cut(masks), cut(d_records).float(),
                                    cut(d_fstate).float())
        errors[label] = [float((b.double() - a).abs().max() / a.abs().max())
                         for a, b in zip(wide[:3], narrow[:3])]
    return errors, float(follows.float().mean())


def test_imager_float32_recompute_is_ill_conditioned():
    """Why the card tests hold the imager's float32 backward only on the
    rays whose float32 trace follows the float64 path: at 50 units the 1e-6
    push-off is below float32 resolution, so even on the float64 trace's own
    records the plain float32 recompute re-hits a surface a ray just left,
    and misses the float64 cotangents by far more than the card tests'
    1e-3 share.  On the rays that follow the float64 path it agrees."""
    errors, share = imager_float32_errors()
    assert max(errors["all"]) > 1e-2
    assert max(errors["follows"]) < 1e-5
    assert 0.5 <= share < 1.0


def hetero_row_focus_shares():
    """The share of the hetero row's rays whose FocusError state cotangents
    (K3's plain version) agree between float32 and float64 on the same
    float32 trace within 1e-3 of their row's largest entry (+ 1e-6), with
    each row at its own scale and with the position and direction rows at
    their block's scale."""
    from pyrayt_tpu_torch import interop
    from pyrayt_tpu_torch.analysis import metrics

    build, _, _, gens, _ = GRAD_SCENES["hetero_row"]
    with TORCH_NS.fresh_ids():
        scene = TORCH_NS.compile(build(TORCH_NS), device="cpu", dtype=torch.float64)
    rays = interop.rays_from_numpy(*grad_rays("hetero_row"), device="cpu", dtype=torch.float32)
    config = TraceConfig(generation_limit=gens)
    in32 = ft.kernel_inputs(scene.params, rays)
    in64 = [t.double() for t in in32]
    records, masks, _ = ft.fused_trace_plain(scene.spec, config, *in32)
    plan = fg.loss_plan(metrics.FocusError(1.0, float(scene.spec.leaf_ids[-1])))
    out = []
    for inputs, rec in ((in32, records), (in64, records.double())):
        scal = plan.row(plan.scalars(rec, masks), torch.ones((), dtype=rec.dtype))
        out.append(fg.fused_bwd_loss_plain(scene.spec, config, *inputs, rec, masks, scal, plan)[3])
    low, high = out[0].double(), out[1]
    rows = high.abs().amax(dim=1, keepdim=True)
    blocks = torch.cat((rows[:4].amax().expand(4, 1), rows[4:8].amax().expand(4, 1), rows[8:]))
    return [float(((low - high).abs() <= 1e-3 * r + 1e-6).all(dim=0).float().mean())
            for r in (rows, blocks)]


def hetero_row_focus_float64_moves(n=1 << 14):
    """The float64 FocusError cotangents (K3's plain version) of the hetero
    row on ``n`` rays, against those of the same records with their
    geometric rows changed by 2e-16 (relative, seeded): how many state
    cotangent entries move by more than 1e-9 (rtol and atol) element by
    element and at each ray's block scale, and whether the parameter
    cotangents stay within it."""
    from pyrayt_tpu_torch import interop
    from pyrayt_tpu_torch.analysis import metrics

    build, _, _, gens, _ = GRAD_SCENES["hetero_row"]
    with TORCH_NS.fresh_ids():
        scene = TORCH_NS.compile(build(TORCH_NS), device="cpu", dtype=torch.float64)
    rays = interop.rays_from_numpy(*grad_rays("hetero_row", n=n), device="cpu",
                                   dtype=torch.float64)
    config = TraceConfig(generation_limit=gens)
    inputs = ft.kernel_inputs(scene.params, rays)
    records, masks, _ = ft.fused_trace_plain(scene.spec, config, *inputs)
    moved = records.clone()
    gen = torch.Generator().manual_seed(1)
    moved[:, 6:15] *= 1 + 2e-16 * torch.randn(moved[:, 6:15].shape, generator=gen,
                                               dtype=torch.float64)
    plan = fg.loss_plan(metrics.FocusError(1.0, float(scene.spec.leaf_ids[-1])))
    scal = plan.row(plan.scalars(records, masks), torch.ones((), dtype=torch.float64))
    a, b = (fg.fused_bwd_loss_plain(scene.spec, config, *inputs, rec, masks, scal, plan)
            for rec in (records, moved))
    diff = (b[3] - a[3]).abs()
    pos = a[3][:4].abs().amax(dim=0, keepdim=True).expand(4, -1)
    dirs = a[3][4:8].abs().amax(dim=0, keepdim=True).expand(4, -1)
    blocks = torch.cat((pos, dirs, a[3][8:].abs()))
    params_hold = all(torch.allclose(x, y, rtol=1e-9, atol=1e-9) for x, y in zip(a[:3], b[:3]))
    return (int((diff > 1e-9 * a[3].abs() + 1e-9).sum()), int((diff > 1e-9 * blocks + 1e-9).sum()),
            params_hold)


def test_hetero_row_focus_state_cotangents_are_ill_conditioned():
    """Why the card tests hold the hetero row's float32 backward against the
    float64 plain version with the position and direction rows at their
    block's scale, and its float64 backward on 2**17 rays with each ray's
    rows at that ray's block scale (test_torch_cuda.py ILL_CONDITIONED32):
    under FocusError its rays through the lens centres reach the detector
    almost parallel to the axis, the plan's record cotangent grows as
    1 / tilt^2, and rounding of the large rows leaves residues in the
    nearly cancelling rows of the same ray.  So the plain version at
    float32 misses its own float64 state cotangents, row by row, on many
    rays, and at float64 on 2**14 rays a 2e-16 change of the records moves
    some entries by more than 1e-9, though none at the block scale."""
    per_row, per_block = hetero_row_focus_shares()
    assert per_row < 0.9
    assert per_block >= 0.99
    per_entry, per_ray_block, params_hold = hetero_row_focus_float64_moves()
    assert per_entry > 0 and per_ray_block == 0 and params_hold


def meniscus_float32_errors():
    """max |plain float32 - plain float64| / max |float64| of the monolithic
    wide backward's plain version (d_objtx, d_prim) on the meniscus wall,
    both fed the float64 trace's records (float32: rounded) and seeded
    cotangents, over the rays that ``rehit_free32`` leaves out and over the
    rest; and the share of the rest."""
    from pyrayt_tpu_torch import interop

    build, _, _, gens = WIDE_SCENES["meniscus"]
    with TORCH_NS.fresh_ids():
        scene = TORCH_NS.compile(build(TORCH_NS), device="cpu", dtype=torch.float64)
    rays = interop.rays_from_numpy(*wide_rays("meniscus"), device="cpu", dtype=torch.float64)
    config = TraceConfig(generation_limit=gens, fixed_loop=True)
    in64 = ft.wide_kernel_inputs(scene.spec, scene.params, rays)
    in32 = [t.float().contiguous() if t.is_floating_point() else t for t in in64]
    records, masks, _ = ft.fused_trace_wide_plain(scene.spec, config, *in64)
    keep = rehit_free32(scene.spec, in64[1], in64[2], records, masks)
    gen = torch.Generator().manual_seed(3)
    d_records = torch.randn(records.shape, generator=gen, dtype=torch.float64) * masks[:, None]
    d_fstate = torch.randn(in64[0].shape, generator=gen, dtype=torch.float64)
    errors = {}
    for label, rays_kept in (("left_out", ~keep), ("kept", keep)):
        def cut(t):
            return t[..., rays_kept].contiguous()

        wide = fg.fused_bwd_wide_plain(scene.spec, config, cut(in64[0]), *in64[1:], cut(records),
                                       cut(masks), d_records=cut(d_records),
                                       d_fstate=cut(d_fstate))
        narrow = fg.fused_bwd_wide_plain(scene.spec, config, cut(in32[0]), *in32[1:],
                                         cut(records).float(), cut(masks),
                                         d_records=cut(d_records).float(),
                                         d_fstate=cut(d_fstate).float())
        errors[label] = [float((b.double() - a).abs().max() / a.abs().max())
                         for a, b in zip(wide[:2], narrow[:2])]
    return errors, float(keep.float().mean())


def test_meniscus_float32_rehits_are_ill_conditioned():
    """Why the card tests hold the meniscus wall's float32 backward only on
    its rehit-free rays: a ray leaving the aperture cylinder almost parallel
    to its axis starts 1e-6 off the wall, where float32 rounding of the
    quadratic's root behind it decides whether a recompute finds the wall
    again 1e-6 ahead.  The plain float32 recompute on the float64 trace's
    own records does, and misses the float64 leaf cotangents by far more
    than the card tests' 1e-3 share, as K6 and K8 do on the float32 trace's
    records (ROADMAP F2); on the rays ``rehit_free32`` keeps it agrees."""
    errors, share = meniscus_float32_errors()
    assert max(errors["left_out"]) > 1e-2
    assert max(errors["kept"]) < 1e-5
    assert 0.6 <= share < 0.95


def test_loss_plans_route_and_descriptors_hash():
    from pyrayt_tpu_torch.analysis import metrics

    rms = metrics.RmsSpotRadius(3.0)
    assert fg.loss_plan(rms).kind == fg.PLAN_RMS
    assert fg.loss_plan(metrics.FocusError(1.0, 3.0)).kind == fg.PLAN_FOCUS
    soft = metrics.SoftFocusError(1.0, 3.0, (0.5, 0.5), 0.05)
    assert fg.loss_plan(soft).kind == fg.PLAN_SOFT_FOCUS
    assert fg.loss_plan(metrics.RmsSpotRadius(None)) is None
    assert fg.loss_plan(metrics.rms_spot_radius) is None
    assert hash(rms) == hash(metrics.RmsSpotRadius(3.0)) and len({rms, soft}) == 2


def test_wide_scenes_raise_in_the_gradient_path():
    """A wide scene's gradients take the staged backward (K5-K7) by
    default and the monolithic wide backward K8 with ``wide_grad="fused"``;
    only an unknown mode raises."""
    from pyrayt_tpu_torch import components as comp
    from pyrayt_tpu_torch.scene.compile import compile_scene

    spec = compile_scene(comp.microlens_array(1.0, 0.2, 5, 4, 0.5), device="cpu").spec  # 40 leaves
    assert fg.wide_grad_mode(spec, TraceConfig()) == "staged"
    assert callable(fg.build_fused_vjp_trace_fn(spec, (), TraceConfig()))
    assert fg.wide_grad_mode(spec, TraceConfig(wide_grad="fused")) == "fused"
    assert callable(fg.build_fused_vjp_trace_fn(spec, (), TraceConfig(wide_grad="fused")))
    with pytest.raises(ValueError, match="unknown"):
        fg.build_fused_vjp_trace_fn(spec, (), TraceConfig(wide_grad="monolithic"))

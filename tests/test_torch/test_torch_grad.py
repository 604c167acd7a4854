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
from torch_parity_scenes import GRAD_SCENES, TORCH_NS, follows_float64_path, grad_rays

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
@pytest.mark.parametrize("name", ["condenser", "mirror", "glass_coeffs"])
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

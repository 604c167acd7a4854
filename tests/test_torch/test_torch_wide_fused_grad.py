"""The monolithic wide backward (K8, ``TraceConfig(wide_grad="fused")``)
on the CPU, float64: its plain version against ``jax.grad`` of the JAX
engine and the JAX package's own K8 in interpret mode, and against the
port's staged backward (the tolerances of
tests/test_ops/test_fused_wide_grad.py).

On CPU tensors the fused Functions run K2's plain version forward and
``fused_bwd_wide_plain`` backward, so these tests pin the arithmetic the
kernel is held to on the card.  The JAX references cost seconds each (the
interpret-mode kernel about 13 s), so each is computed once per module.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pyrayt_tpu.components as j_comp
from pyrayt_tpu.analysis.metrics import RmsSpotRadius as JRms
from pyrayt_tpu.analysis.metrics import rms_spot_radius as j_rms_fn
from pyrayt_tpu.config import TraceConfig as JConfig
from pyrayt_tpu.ops import fused_grad as j_fg
from pyrayt_tpu.scene import fresh_ids as j_fresh_ids
from pyrayt_tpu.scene.compile import compile_scene as j_compile
from pyrayt_tpu.tracer import engine as j_engine
from pyrayt_tpu.tracer.rayset import RaySet as JRaySet
from pyrayt_tpu_torch import interop
from pyrayt_tpu_torch.analysis import build_objective, metrics
from pyrayt_tpu_torch.config import TraceConfig
from pyrayt_tpu_torch.ops import fused_grad as fg
from pyrayt_tpu_torch.ops import fused_trace as ft
from torch_parity_scenes import TORCH_NS, WIDE_SCENES, grid_rays, mla, wide_rays

RTOL = 1e-8
ATOL = 1e-12
NAMES = ("world", "prim", "glass")
GENS = 4
JAX_NS = types.SimpleNamespace(comp=j_comp)


def _port_grads(t_scene, t_rays, gens, loss, descriptor, wide_grad="fused"):
    """(value, {world, prim, glass} grads, d positions) of the port's route."""
    config = TraceConfig(generation_limit=gens, fixed_loop=True, wide_grad=wide_grad)
    params = {k: v.detach().clone().requires_grad_(True) for k, v in t_scene.params.items()}
    pos = t_rays.positions.detach().clone().requires_grad_(True)
    rays = t_rays.replace(positions=pos)
    if descriptor:
        value = fg.build_fused_value_and_grad_fn(t_scene.spec, t_scene.materials, config, loss)(
            params, rays)
    else:
        value = loss(fg.build_fused_vjp_trace_fn(t_scene.spec, t_scene.materials, config)(
            params, rays))
    grads = torch.autograd.grad(value, [params[k] for k in NAMES] + [pos])
    return float(value.detach()), dict(zip(NAMES, grads[:3])), grads[3]


def _assert_close(t_grads, j_grads):
    for k in NAMES:
        np.testing.assert_allclose(np.asarray(t_grads[k]), np.asarray(j_grads[k]), rtol=RTOL,
                                   atol=ATOL, err_msg=k)


def _losses(det_id, mode):
    """(jax loss, torch loss, torch loss is a descriptor) of a mode."""
    if mode == "loss_plan":
        return JRms(surface_id=det_id), metrics.RmsSpotRadius(det_id), True
    return ((lambda res: j_rms_fn(res, det_id)),
            (lambda res: metrics.rms_spot_radius(res, det_id)), False)


@pytest.fixture(scope="module")
def mla5():
    """The 5x5 array (51 leaves) in both packages, its grid of rays, and
    ``jax.grad`` of the JAX engine per mode (the two modes' losses are the
    same function, one through a descriptor)."""
    build, _, _, gens = WIDE_SCENES["mla5"]
    with j_fresh_ids():
        j_scene = j_compile(build(JAX_NS))
    with TORCH_NS.fresh_ids():
        t_scene = TORCH_NS.compile(build(TORCH_NS), device="cpu", dtype=torch.float64)
    pos, dirs, meta = wide_rays("mla5")
    j_rays = JRaySet(positions=jnp.asarray(pos), directions=jnp.asarray(dirs),
                     **{f: jnp.asarray(meta[k]) for k, f in enumerate(JRaySet.fields)})
    t_rays = interop.rays_from_numpy(pos, dirs, meta, device="cpu", dtype=torch.float64)
    det_id = float(t_scene.spec.leaf_ids[-1])
    fn = j_engine.build_trace_fn(j_scene.spec, j_scene.materials,
                                 JConfig(generation_limit=gens, fixed_loop=True))
    value, (dp, dr) = jax.value_and_grad(
        lambda p, r: j_rms_fn(fn(p, r), det_id), argnums=(0, 1))(j_scene.params, j_rays)
    reference = (float(value), {k: np.asarray(dp[k]) for k in NAMES},
                 np.asarray(dr.positions[:3]))
    return j_scene, t_scene, j_rays, t_rays, gens, det_id, reference


@pytest.mark.parametrize("mode", ["loss_plan", "generic"])
def test_fused_grads_match_jax_on_the_5x5_array(mla5, mode):
    _, t_scene, _, t_rays, gens, det_id, (j_value, j_grads, j_dpos) = mla5
    _, t_loss, descriptor = _losses(det_id, mode)
    before = (fg.fused_bwd_wide.launches, fg.staged_tail.launches, fg.staged_group.launches)
    t_value, t_grads, t_dpos = _port_grads(t_scene, t_rays, gens, t_loss, descriptor)
    assert t_value == pytest.approx(j_value, rel=1e-12)
    _assert_close(t_grads, j_grads)
    np.testing.assert_allclose(t_dpos[:3].numpy(), j_dpos, rtol=RTOL, atol=ATOL)
    # every lenslet's transform receives its own cotangent
    assert (t_grads["world"][:50].abs().sum(dim=(1, 2)) > 0).sum() > 30
    # plain versions on the CPU, and never the staged path
    assert (fg.fused_bwd_wide.launches, fg.staged_tail.launches,
            fg.staged_group.launches) == before


def test_fused_matches_the_jax_kernel_in_interpret_mode(mla5):
    """The JAX package's own K8 (``_make_bwd_kernel_wide``, Pallas interpret
    mode, loss-fused RmsSpotRadius) against the port's fused route."""
    j_scene, t_scene, j_rays, t_rays, gens, det_id, _ = mla5
    config = JConfig(generation_limit=gens, fixed_loop=True, wide_grad="fused")
    assert j_fg.wide_grad_mode(j_scene.spec, config) == "fused"
    vg = j_fg.build_fused_value_and_grad_fn(j_scene.spec, j_scene.materials, config,
                                            JRms(surface_id=det_id), interpret=True)
    j_value, (dp, dr) = jax.value_and_grad(vg, argnums=(0, 1))(j_scene.params, j_rays)
    t_value, t_grads, t_dpos = _port_grads(t_scene, t_rays, gens, metrics.RmsSpotRadius(det_id),
                                           True)
    assert t_value == pytest.approx(float(j_value), rel=1e-12)
    _assert_close(t_grads, {k: dp[k] for k in NAMES})
    np.testing.assert_allclose(t_dpos[:3].numpy(), np.asarray(dr.positions[:3]), rtol=RTOL,
                               atol=ATOL)


def _fused_against_staged(t_scene, t_rays, gens, mode):
    det_id = float(t_scene.spec.leaf_ids[-1])
    _, t_loss, descriptor = _losses(det_id, mode)
    fused = _port_grads(t_scene, t_rays, gens, t_loss, descriptor, "fused")
    staged = _port_grads(t_scene, t_rays, gens, t_loss, descriptor, "staged")
    assert fused[0] == staged[0]
    _assert_close(fused[1], staged[1])
    torch.testing.assert_close(fused[2], staged[2], rtol=RTOL, atol=ATOL)
    return fused[1]


@pytest.mark.parametrize("mode", ["loss_plan", "generic"])
def test_fused_matches_staged_on_the_hetero_wall(twins, mode):
    _, t_scene, _, t_rays, gens = twins.wide_inputs("hetero")
    grads = _fused_against_staged(t_scene, t_rays, gens, mode)
    assert (grads["glass"].abs().sum(dim=1) > 0).sum() >= 3  # three glasses


@pytest.mark.parametrize("mode", ["loss_plan", "generic"])
def test_fused_matches_staged_on_the_16x16_array(mode):
    """513 leaves, past the JAX package's 300-leaf cap on its K8."""
    with TORCH_NS.fresh_ids():
        t_scene = TORCH_NS.compile(mla(TORCH_NS, 16), device="cpu", dtype=torch.float64)
    assert t_scene.spec.n_leaves == 513
    assert fg.wide_grad_mode(t_scene.spec, TraceConfig(wide_grad="fused")) == "fused"
    t_rays = interop.rays_from_numpy(*grid_rays(16 * 0.9, 16 * 0.9, -1.0, 256), device="cpu",
                                     dtype=torch.float64)
    grads = _fused_against_staged(t_scene, t_rays, GENS, mode)
    assert (grads["world"][:512].abs().sum(dim=(1, 2)) > 0).sum() > 100


def _lenslets(m, r):
    return m.comp.microlens_array(r, 0.25, 5, 5, 1.0) + [m.comp.baffle((10.0, 10.0)).move_x(4.0)]


def test_fused_lenslet_radius_matches_fd(monkeypatch):
    """The shared lenslet radius through ``build_objective`` with
    ``wide_grad="fused"`` (the counterpart of tests/test_ops/
    test_fused_wide_grad.py::test_wide_traced_lenslet_radius_matches_fd):
    patching ``pick_fused`` sends the CPU objective down the card's route,
    K2 forward and K8 backward, whose wrappers run their plain versions."""
    with TORCH_NS.fresh_ids():
        det_id = float(_lenslets(TORCH_NS, 2.0)[-1].get_id())
    rays = interop.rays_from_numpy(*grid_rays(4.5, 4.5, -1.0, 144), device="cpu",
                                   dtype=torch.float64)
    objective = build_objective(lambda r: _lenslets(TORCH_NS, r), rays,
                                lambda res: metrics.rms_spot_radius(res, det_id),
                                TraceConfig(generation_limit=GENS, wide_grad="fused"))
    monkeypatch.setattr(ft, "pick_fused", lambda spec, config, device: True)
    calls = {"fused": 0, "staged": 0}

    def counted(name, fn):
        def call(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return call

    monkeypatch.setattr(fg, "fused_bwd_wide", counted("fused", fg.fused_bwd_wide))
    monkeypatch.setattr(fg, "staged_bwd", counted("staged", fg.staged_bwd))
    r0 = torch.tensor(2.0, dtype=torch.float64, requires_grad=True)
    (grad,) = torch.autograd.grad(objective(r0), r0)
    eps = 1e-5
    with torch.no_grad():
        fd = (float(objective(r0 + eps)) - float(objective(r0 - eps))) / (2 * eps)
    assert calls == {"fused": 1, "staged": 0}
    assert abs(float(grad) - fd) < 1e-4 * max(1.0, abs(fd))
    assert abs(float(grad)) > 1e-3


def test_fused_wrapper_runs_the_plain_version_on_the_cpu(twins):
    """On CPU tensors ``fused_bwd_wide`` is ``fused_bwd_wide_plain`` and
    counts no launch; it takes one mode's cotangents, not both."""
    _, t_scene, _, t_rays, gens = twins.wide_inputs("csg_singles")
    spec = t_scene.spec
    config = TraceConfig(generation_limit=gens, fixed_loop=True)
    inputs = ft.wide_kernel_inputs(spec, t_scene.params, t_rays)
    records, masks, _ = ft.fused_trace_wide(spec, config, *inputs)
    gen = torch.Generator().manual_seed(11)
    d_records = torch.randn(records.shape, generator=gen, dtype=torch.float64) * masks[:, None]
    d_fstate = torch.randn(inputs[0].shape, generator=gen, dtype=torch.float64)
    before = fg.fused_bwd_wide.launches
    out = fg.fused_bwd_wide(spec, config, *inputs, records, masks, d_records=d_records,
                            d_fstate=d_fstate)
    plain = fg.fused_bwd_wide_plain(spec, config, *inputs, records, masks, d_records=d_records,
                                    d_fstate=d_fstate)
    assert fg.fused_bwd_wide.launches == before
    for a, b in zip(out, plain):
        assert torch.equal(a, b)
    assert float(out[0].abs().max()) > 0 and not out[3][[3, 7]].any()
    plan = fg.loss_plan(metrics.RmsSpotRadius(float(spec.leaf_ids[-1])))
    scal = plan.row(plan.scalars(records, masks), torch.ones((), dtype=torch.float64))
    with pytest.raises(ValueError, match="generic mode"):
        fg.fused_bwd_wide(spec, config, *inputs, records, masks, d_records=d_records,
                          d_fstate=d_fstate, scal=scal, plan=plan)
    with pytest.raises(ValueError, match="generic mode"):
        fg.fused_bwd_wide(spec, config, *inputs, records, masks)

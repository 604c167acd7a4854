"""Ray cotangents of the port's plain backward against ``jax.grad`` of
the JAX engine (float64, rtol 1e-8, atol 1e-10): cotangents entering
through the final rays, the cotangent of the initial rays (w rows zero on
the kernel path), and ``remat``."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from pyrayt_tpu.analysis.metrics import rms_spot_radius as j_rms
from pyrayt_tpu.config import TraceConfig as JConfig
from pyrayt_tpu.tracer import engine as j_engine
from pyrayt_tpu_torch.analysis.metrics import rms_spot_radius
from pyrayt_tpu_torch.config import TraceConfig
from pyrayt_tpu_torch.ops import fused_grad as fg
from pyrayt_tpu_torch.tracer import engine
from test_torch_grad import TOL, jax_param_grads, port_param_grads


def test_final_ray_cotangents_match_jax(twins):
    """Cotangents entering through the final rays: rays alive at the
    horizon and rays that stopped (their state passes through)."""

    def j_loss(result):
        return jnp.sum(result.final_rays.positions[1] ** 2) / 1e3

    def t_loss(result):
        return torch.sum(result.final_rays.positions[1] ** 2) / 1e3

    _, grads_j = jax_param_grads(twins, "condenser", j_loss)
    _, t_scene, _, t_rays, gens = twins.grad_inputs("condenser")
    for path in ("engine", "fused_bwd_plain"):
        _, grads = port_param_grads(t_scene, t_rays, gens, path, t_loss)
        for key in ("world", "prim", "glass"):
            np.testing.assert_allclose(grads[key], grads_j[key], err_msg=f"{path} {key}", **TOL)


def test_initial_ray_cotangents_match_jax(twins):
    """The xyz rows of d(rays) match jax.grad of the JAX engine; the w rows
    are zero on the kernel path (the JAX engine gives them a value)."""
    j_scene, t_scene, j_rays, t_rays, gens = twins.grad_inputs("condenser")
    fn = j_engine.build_trace_fn(
        j_scene.spec, j_scene.materials, JConfig(generation_limit=gens, fixed_loop=True)
    )
    g_j = np.asarray(
        jax.jit(jax.grad(lambda p: j_rms(fn(j_scene.params, j_rays.replace(positions=p)))))(
            j_rays.positions
        )
    )
    trace = fg.build_fused_vjp_trace_fn(t_scene.spec, t_scene.materials, TraceConfig(gens))
    positions = t_rays.positions.clone().requires_grad_(True)
    (g,) = torch.autograd.grad(
        rms_spot_radius(trace(t_scene.params, t_rays.replace(positions=positions))), positions
    )
    np.testing.assert_allclose(g.numpy()[:3], g_j[:3], **TOL)
    np.testing.assert_array_equal(g.numpy()[3], 0.0)
    assert np.abs(g_j[:3]).max() > 1e-6


def test_remat_gives_the_same_gradient(twins):
    _, t_scene, _, t_rays, gens = twins.grad_inputs("condenser")
    grads = []
    for remat in (False, True):
        params = {k: v.clone().requires_grad_(True) for k, v in t_scene.params.items()}
        fn = engine.build_trace_fn(
            t_scene.spec, t_scene.materials,
            TraceConfig(generation_limit=gens, fixed_loop=True, remat=remat),
        )
        grads.append(torch.autograd.grad(rms_spot_radius(fn(params, t_rays)), params["world"])[0])
    torch.testing.assert_close(grads[0], grads[1], rtol=0, atol=0)

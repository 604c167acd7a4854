"""The CUDA kernel against its plain version on the card.

Skips without a CUDA device.  It imports no JAX, so a machine with only
PyTorch runs it (the ``--noconftest`` keeps the suite's JAX setup out):

    python -m pytest --noconftest -m cuda tests/test_torch/test_torch_cuda.py
"""

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

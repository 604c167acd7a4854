"""The port's plain K1 against the TPU kernel K1 itself, run by Pallas in
interpret mode on the CPU (as tests/test_ops/test_fused_trace.py runs it):
masks exactly equal, masked records and final rays within rtol = atol =
1e-9, at float64, on the five parity scenes."""

import numpy as np
import pytest
import torch

from pyrayt_tpu.config import TraceConfig as JConfig
from pyrayt_tpu.ops import fused_trace as j_fused
from pyrayt_tpu_torch.config import TraceConfig
from pyrayt_tpu_torch.ops import fused_trace as ft

TOL = dict(rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("name", ["condenser", "all_primitives", "prism_tir", "mirrors", "union"])
def test_plain_kernel_matches_pallas_kernel(twins, name):
    j_scene, t_scene, j_rays, t_rays, gens = twins.inputs(name)
    j_fn = j_fused.build_fused_trace_fn(
        j_scene.spec, j_scene.materials, JConfig(generation_limit=gens, fixed_loop=True),
        interpret=True,
    )
    j_res = j_fn(j_scene.params, j_rays)
    res = ft.build_fused_trace_fn(
        t_scene.spec, t_scene.materials, TraceConfig(generation_limit=gens)
    )(t_scene.params, t_rays)

    mask = res.record_mask.numpy()
    np.testing.assert_array_equal(mask, np.asarray(j_res.record_mask))
    assert int(res.generations_run) == int(j_res.generations_run)
    np.testing.assert_allclose(
        res.records.numpy() * mask[:, None], np.asarray(j_res.records) * mask[:, None], **TOL
    )
    for field in ("positions", "directions", "generation", "intensity", "index"):
        np.testing.assert_allclose(
            getattr(res.final_rays, field).numpy(),
            np.asarray(getattr(j_res.final_rays, field)),
            err_msg=f"final_rays.{field}",
            **TOL,
        )
    assert res.records.dtype == torch.float64

"""The port's plain engine and RayTracer against the JAX package (float64),
and the port's import isolation."""

import subprocess
import sys

import numpy as np
import pandas as pd
import pytest
import torch

import pyrayt_tpu as j_pyrayt
import pyrayt_tpu_torch as t_pyrayt
from pyrayt_tpu.config import TraceConfig as JConfig
from pyrayt_tpu.tracer import engine as j_engine
from pyrayt_tpu_torch import interop
from pyrayt_tpu_torch.config import TraceConfig
from pyrayt_tpu_torch.tracer import engine
from pyrayt_tpu_torch.tracer.frame import FRAME_COLUMNS, records_to_dataframe
from pyrayt_tpu_torch.tracer.rayset import RaySet

TOL = dict(rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("fixed_loop", [True, False])
@pytest.mark.parametrize("name", ["condenser", "all_primitives", "prism_tir", "mirrors", "union"])
def test_plain_engine_matches_jax_engine(twins, name, fixed_loop):
    """Same loop semantics as the JAX engine: every record row (masked or
    not), every mask and the final rays agree."""
    j_scene, t_scene, j_rays, t_rays, gens = twins.inputs(name)
    j_res = j_engine.build_trace_fn(
        j_scene.spec, j_scene.materials, JConfig(generation_limit=gens, fixed_loop=fixed_loop)
    )(j_scene.params, j_rays)
    res = engine.build_trace_fn(
        t_scene.spec, t_scene.materials, TraceConfig(generation_limit=gens, fixed_loop=fixed_loop)
    )(t_scene.params, t_rays)
    np.testing.assert_array_equal(res.record_mask.numpy(), np.asarray(j_res.record_mask))
    np.testing.assert_allclose(res.records.numpy(), np.asarray(j_res.records), **TOL)
    assert int(res.generations_run) == int(j_res.generations_run)
    for field in ("positions", "directions", "generation", "intensity", "wavelength", "index"):
        np.testing.assert_allclose(
            getattr(res.final_rays, field).numpy(),
            np.asarray(getattr(j_res.final_rays, field)),
            err_msg=field,
            **TOL,
        )


def _collimator(pkg):
    comp = pkg.components
    lens = comp.biconvex_lens(2, 2, 0.25, aperture=1)
    focus = pkg.lensmakers_equation(2, -2, 1.5, 0.25)
    source = comp.ConeOfRays(cone_angle=6).move_x(-focus)
    baffle = comp.baffle((1, 1)).move_x(1)
    return source, [lens, baffle]


def test_ray_tracer_collimator_matches_jax_frame():
    with j_pyrayt.scene.fresh_ids():
        j_source, j_parts = _collimator(j_pyrayt)
        j_frame = j_pyrayt.RayTracer(
            j_source, j_parts, rays_per_source=50, generation_limit=100
        ).trace()
    with t_pyrayt.scene.fresh_ids():
        t_source, t_parts = _collimator(t_pyrayt)
        tracer = t_pyrayt.RayTracer(
            t_source, t_parts, rays_per_source=50, generation_limit=100, dtype=torch.float64,
            device="cpu",
        )
        frame = tracer.trace()
    assert len(frame) == len(j_frame) == 150
    assert list(frame.columns) == list(j_frame.columns)
    assert (frame.dtypes == np.float32).all()
    np.testing.assert_allclose(frame.to_numpy(), j_frame.to_numpy(), rtol=1e-6, atol=1e-6)
    assert np.allclose(frame[frame.generation == 2]["x1"], 1.0)
    tracer.calculate_source_ids()
    assert (tracer.get_results()["source_id"] == 0).all()


def test_ray_tracer_api():
    source, parts = _collimator(t_pyrayt)
    second = t_pyrayt.components.LineOfRays(0.2).move_x(-1.0)
    tracer = t_pyrayt.RayTracer(
        [source, second], parts, rays_per_source=8, generation_limit=4, device="cpu"
    )
    assert tracer.get_config().generation_limit == 4
    result = tracer.trace_device()
    assert result.records.dtype == torch.float32  # the production dtype
    assert result.records.shape == (4, 15, 16)
    np.testing.assert_array_equal(result.final_rays.id.numpy(), np.arange(16))
    fn, params, rays = tracer.trace_fn()
    again = fn(params, rays)
    torch.testing.assert_close(again.records, result.records)
    compact = records_to_dataframe(result.records, result.record_mask)
    naive = records_to_dataframe(result.records, result.record_mask, compact=False)
    np.testing.assert_array_equal(compact.to_numpy(), naive.to_numpy())
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, axis = plt.subplots()
    tracer.show(axis=axis, resolution=32, color_function="source")
    assert axis.images and axis.collections  # the rendered parts and the ray segments
    plt.close(fig)
    tracer.set_config(TraceConfig(use_fused=True))
    with pytest.raises(ValueError, match="CUDA tensors"):
        tracer.trace()


FRAME_MASKS = {
    "all_live": lambda rng, shape: torch.ones(shape, dtype=torch.bool),
    "holes": lambda rng, shape: torch.rand(shape, generator=rng) < 0.6,
    "empty_middle": lambda rng, shape: (torch.rand(shape, generator=rng) < 0.6)
    * (torch.arange(shape[0]) != 1)[:, None],
    "all_empty": lambda rng, shape: torch.zeros(shape, dtype=torch.bool),
}


def _refuse_page_locked(monkeypatch):
    """Records that look as if they sat on a card whose page-locked
    allocation raises."""
    empty = torch.empty

    def refusing(*args, pin_memory=False, **kw):
        if pin_memory:
            raise RuntimeError("no page-locked memory")
        return empty(*args, **kw)

    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    monkeypatch.setattr(torch, "empty", refusing)


@pytest.mark.parametrize("host", ["records", "pinning_refused"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("mask", sorted(FRAME_MASKS))
def test_frame_selected_where_the_records_are(mask, dtype, host, monkeypatch):
    """The default frame, selected on the records' device, equals the host
    selection of ``compact=False`` bit for bit, has contiguous columns,
    owns its buffer, and is counted in ``records_to_dataframe.rows/.slots``.
    Records on the host count in neither ``.pinned`` nor ``.pageable``;
    card records whose page-locked allocation raises give the same frame,
    copied pageable and counted in ``.pageable``."""
    rng = torch.Generator().manual_seed(15)
    records = torch.randn((4, 15, 37), generator=rng, dtype=dtype)
    record_mask = FRAME_MASKS[mask](rng, (4, 37))
    rows, slots = records_to_dataframe.rows, records_to_dataframe.slots
    pinned, pageable = records_to_dataframe.pinned, records_to_dataframe.pageable
    with monkeypatch.context() as patch:
        if host == "pinning_refused":
            _refuse_page_locked(patch)
        frame = records_to_dataframe(records, record_mask)
    assert records_to_dataframe.rows - rows == len(frame) == int(record_mask.sum())
    assert records_to_dataframe.slots - slots == 4 * 37
    assert records_to_dataframe.pinned == pinned
    assert records_to_dataframe.pageable - pageable == (host == "pinning_refused")
    naive = records_to_dataframe(records, record_mask, compact=False)
    pd.testing.assert_frame_equal(frame, naive, check_exact=True)
    assert list(frame.columns) == list(FRAME_COLUMNS)
    assert (frame.dtypes == np.float32).all()
    assert isinstance(frame.index, pd.RangeIndex)
    assert all(frame[c].to_numpy().flags.c_contiguous for c in frame.columns)
    kept = frame.to_numpy().copy()
    records.add_(1.0)
    assert len(records_to_dataframe(records, record_mask)) == len(kept)
    np.testing.assert_array_equal(frame.to_numpy(), kept)
    assert (records_to_dataframe.pinned, records_to_dataframe.pageable) == (
        pinned, pageable + (host == "pinning_refused"))


def test_ray_tracer_defaults_to_the_card(monkeypatch):
    """No device means CUDA; without a card that raises instead of
    falling back to the CPU."""
    source, parts = _collimator(t_pyrayt)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        t_pyrayt.RayTracer(source, parts)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        source.generate_rays(4)
    assert source.generate_rays(4, device="cpu").device == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert t_pyrayt.RayTracer(source, parts)._device == torch.device("cuda")
    assert t_pyrayt.RayTracer(source, parts, device="cpu")._device == torch.device("cpu")


def _compiled_params(**kw):
    return t_pyrayt.scene.compile_scene(_collimator(t_pyrayt)[1], **kw).params["world"]


def _numpy_rays(**kw):
    pos, dirs = np.zeros((4, 3)), np.zeros((4, 3))
    return interop.rays_from_numpy(pos, dirs, np.zeros((5, 3)), **kw).positions


def _numpy_params(**kw):
    arrays = {"world": np.eye(4)[None], "prim": np.zeros((1, 6)), "glass": np.zeros((1, 7))}
    return interop.params_from_numpy(arrays, **kw)["world"]


def _created_rays(**kw):
    return RaySet.create(3, **kw).positions


@pytest.mark.parametrize("make", [_compiled_params, _numpy_rays, _numpy_params, _created_rays])
def test_builders_default_to_the_card(monkeypatch, make):
    """Every public ``device=None`` means CUDA, as in RayTracer: the scene
    and the rays of one program never land on two devices unasked."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        make()
    assert make(device="cpu").device == torch.device("cpu")


def test_pin_restores_poses():
    lens = t_pyrayt.components.thick_lens(1.0, -1.0, 0.25, aperture=0.5)
    start = lens.get_world_transform()
    with t_pyrayt.pin(lens):
        lens.move_x(0.3).rotate_z(10)
        assert not np.allclose(lens.get_world_transform(), start)
    np.testing.assert_allclose(lens.get_world_transform(), start, atol=1e-12)


def test_import_does_not_load_jax():
    code = (
        "import sys, pyrayt_tpu_torch, pyrayt_tpu_torch.ops.fused_trace, "
        "pyrayt_tpu_torch.interop, pyrayt_tpu_torch.render, pyrayt_tpu_torch.debug, "
        "pyrayt_tpu_torch.analysis\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'pyrayt_tpu.'))"
        " or m == 'pyrayt_tpu']\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)

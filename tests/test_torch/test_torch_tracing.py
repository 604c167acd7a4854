"""The port's spans (``pyrayt_tpu_torch/tracing.py``) on the CPU.

With no profiler recording, a span is one shared no-op object and the
port opens no ``record_function``.  Under ``torch.profiler`` a
``trace()`` and an ``optimize()`` step record their layers' spans nested
by time, each launching wrapper records one ``pyrayt.ops.<wrapper>`` span
per call, and the numbers are the same, bit for bit, as without it.
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from pyrayt_tpu_torch import RayTracer, interop, tracing
from pyrayt_tpu_torch import components as comp
from pyrayt_tpu_torch import materials as matl
from pyrayt_tpu_torch.analysis import build_objective, metrics, optimize
from pyrayt_tpu_torch.config import TraceConfig
from pyrayt_tpu_torch.ops import fused_grad as fg
from pyrayt_tpu_torch.ops import fused_trace as ft
from torch_parity_scenes import (
    SCENES,
    TORCH_NS,
    WIDE_SCENES,
    numpy_rays,
    reduce_inputs,
    reduce_key_sets,
    wide_rays,
)

STEP_CHILDREN = ("optimize.zero_grad", "optimize.objective", "optimize.backward",
                 "optimize.update", "optimize.readback")


def _recorded(run):
    """``(run()'s value, [(span name without "pyrayt.", start, end)]``
    in order of start) under the CPU profiler."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        value = run()
    spans = []
    for ev in prof.profiler.kineto_results.events():
        if ev.name().startswith("pyrayt."):
            start = ev.start_ns()
            spans.append((ev.name()[len("pyrayt."):], start, start + ev.duration_ns()))
    return value, sorted(spans, key=lambda s: s[1])


def _named(spans, name):
    return [s for s in spans if s[0] == name]


def _one(spans, name):
    found = _named(spans, name)
    assert len(found) == 1, (name, found)
    return found[0]


def _inside(inner, outer):
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def _tracer():
    with TORCH_NS.fresh_ids():  # the same surface ids in every tracer
        lens = comp.thick_lens(1.0, -1.0, 0.25, aperture=0.5, material=matl.glass["BK7"])
        parts = [lens, comp.baffle((1.0, 1.0)).move_x(1.0)]
    source = comp.LineOfRays(0.4).move_x(-0.5)
    return RayTracer(source, parts, rays_per_source=16, generation_limit=4, device="cpu",
                     dtype=torch.float64)


def _singlet(theta):
    lens = comp.thick_lens(r1=theta["r1"], r2=-theta["r1"], thickness=0.1, aperture=0.8,
                           material=matl.glass["ideal"], r1_sign=1, r2_sign=-1)
    return [lens, comp.baffle((3.0, 3.0)).move_x(2.0)]


def _design(steps=2, **kw):
    rays = comp.LineOfRays(0.4).move_x(-1.0).generate_rays(16, device="cpu",
                                                           dtype=torch.float64)
    objective = build_objective(_singlet, rays, metrics.rms_spot_radius,
                                TraceConfig(generation_limit=4, fixed_loop=True))
    return optimize(objective, {"r1": torch.tensor(3.0, dtype=torch.float64)}, steps=steps,
                    learning_rate=5e-2, **kw)


def test_a_span_without_a_profiler_is_one_shared_object():
    assert tracing.span("trace") is tracing.span("ops.fused_trace")
    with tracing.span("trace") as opened:
        assert opened is None


def test_nothing_is_recorded_without_a_profiler(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) with no profiler recording")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    _tracer().trace()
    _, history = _design()
    assert len(history) == 2


def test_trace_spans_nest_by_layer():
    frame, spans = _recorded(_tracer().trace)
    assert len(frame) > 0
    trace = _one(spans, "trace")
    device = _one(spans, "trace_device")
    frame_span = _one(spans, "frame")
    assert _inside(device, trace) and _inside(frame_span, trace)
    assert device[2] <= frame_span[1]
    for name in ("sources", "scene.compile"):
        assert _inside(_one(spans, name), device), name
    copy, rows = _one(spans, "frame.copy"), _one(spans, "frame.rows")
    assert _inside(copy, frame_span) and _inside(rows, frame_span)
    assert copy[2] <= rows[1]


def test_optimize_spans_nest_by_step():
    (_, history), spans = _recorded(_design)
    steps = _named(spans, "optimize.step")
    assert len(steps) == len(history) == 2
    for step in steps:
        children = [_one([s for s in spans if _inside(s, step)], name) for name in STEP_CHILDREN]
        assert all(a[2] <= b[1] for a, b in zip(children, children[1:]))
        objective = children[1]
        for name in ("objective.build", "scene.compile", "objective.loss"):
            assert _inside(_one([s for s in spans if _inside(s, step)], name), objective), name
    assert not _named(spans, "optimize.checkpoint")


def test_checkpoint_span_at_each_save(tmp_path):
    _, spans = _recorded(lambda: _design(steps=2, checkpoint_path=str(tmp_path / "run.pt"),
                                         checkpoint_every=1))
    saves = _named(spans, "optimize.checkpoint")
    steps = _named(spans, "optimize.step")
    assert len(saves) == 3  # after each step and at the end
    assert _inside(saves[0], steps[0]) and _inside(saves[1], steps[1])


@pytest.fixture(scope="module")
def narrow():
    """The condenser's K1 inputs and forward on CPU tensors, float64."""
    build, origin, angle, _, gens = SCENES["condenser"]
    with TORCH_NS.fresh_ids():
        scene = TORCH_NS.compile(build(TORCH_NS), device="cpu", dtype=torch.float64)
    rays = interop.rays_from_numpy(*numpy_rays(origin, angle, 32), device="cpu",
                                   dtype=torch.float64)
    config = TraceConfig(generation_limit=gens)
    inputs = ft.kernel_inputs(scene.params, rays)
    records, masks, fstate = ft.fused_trace(scene.spec, config, *inputs)
    plan = fg.loss_plan(metrics.RmsSpotRadius(float(scene.spec.leaf_ids[-1])))
    scal = plan.row(plan.scalars(records, masks), torch.ones((), dtype=torch.float64))
    return scene.spec, config, inputs, records, masks, fstate, plan, scal


@pytest.fixture(scope="module")
def wide():
    """The array with CSG singles: K2's inputs and forward with its fold
    on CPU tensors, float64, and the staged chain's first generation."""
    build, _, _, gens = WIDE_SCENES["csg_singles"]
    with TORCH_NS.fresh_ids():
        scene = TORCH_NS.compile(build(TORCH_NS), device="cpu", dtype=torch.float64)
    rays = interop.rays_from_numpy(*wide_rays("csg_singles", 64), device="cpu",
                                   dtype=torch.float64)
    config = TraceConfig(generation_limit=gens)
    spec = scene.spec
    inputs = ft.wide_kernel_inputs(spec, scene.params, rays)
    records, masks, fstate, fold5, win = ft.fused_trace_wide(spec, config, *inputs,
                                                             save_fold=True)
    state0, glass = inputs[0], inputs[3]
    n = state0.shape[1]
    buf, _, _ = fg.staged_tail(spec, config, state0, records[0], masks[0], None, fold5[0], glass,
                               torch.zeros((11, n), dtype=torch.float64),
                               d_rec=torch.ones_like(records[0]))
    return spec, config, inputs, records, masks, fstate, fold5, win, buf


def _narrow_call(name, narrow):
    spec, config, inputs, records, masks, fstate, plan, scal = narrow
    if name == "fused_trace":
        return lambda: ft.fused_trace(spec, config, *inputs)
    if name == "fused_bwd":
        return lambda: fg.fused_bwd(spec, config, *inputs, records, masks,
                                    torch.ones_like(records), torch.zeros_like(fstate))
    return lambda: fg.fused_bwd_loss(spec, config, *inputs, records, masks, scal, plan)


def _wide_call(name, wide):
    spec, config, inputs, records, masks, fstate, fold5, win, buf = wide
    state0, obj_tx, prim, glass, slots = inputs[:5]
    if name == "fused_trace_wide":
        return lambda: ft.fused_trace_wide(spec, config, *inputs, save_fold=True)
    if name == "staged_tail":
        return lambda: fg.staged_tail(spec, config, state0, records[0], masks[0], None, fold5[0],
                                      glass, torch.zeros((11, state0.shape[1]),
                                                         dtype=torch.float64),
                                      d_rec=torch.ones_like(records[0]))
    if name == "staged_group":
        return lambda: fg.staged_group(spec, 0, buf, win[0], obj_tx, prim, slots)
    if name == "staged_singles":
        return lambda: fg.staged_singles(spec, buf, win[0], obj_tx, prim, slots)
    return lambda: fg.fused_bwd_wide(spec, config, *inputs, records, masks,
                                     d_records=torch.ones_like(records),
                                     d_fstate=torch.zeros_like(fstate))


@pytest.mark.parametrize("name", ["fused_trace", "fused_bwd", "fused_bwd_loss"])
def test_each_narrow_wrapper_call_is_one_span(narrow, name):
    _, spans = _recorded(_narrow_call(name, narrow))
    _one(spans, f"ops.{name}")


@pytest.mark.parametrize("name", ["fused_trace_wide", "staged_tail", "staged_group",
                                  "staged_singles", "fused_bwd_wide"])
def test_each_wide_wrapper_call_is_one_span(wide, name):
    _, spans = _recorded(_wide_call(name, wide))
    _one(spans, f"ops.{name}")


def test_the_reduce_wrapper_call_is_one_span():
    keys, rows = reduce_key_sets(64)["uniform_4096"]
    args = reduce_inputs(keys, rows, torch.float64, "cpu")
    _, spans = _recorded(lambda: fg.row_reduce(*args, rows, rows + 3))
    _one(spans, "ops.row_reduce")


def test_the_host_tables_are_one_span_each():
    build = WIDE_SCENES["csg_singles"][0]
    with TORCH_NS.fresh_ids():
        scene = TORCH_NS.compile(build(TORCH_NS), device="cpu", dtype=torch.float64)
    rays = interop.rays_from_numpy(*wide_rays("csg_singles", 8), device="cpu",
                                   dtype=torch.float64)
    for run in (lambda: ft.kernel_inputs(scene.params, rays),
                lambda: ft.wide_runtime_tables(scene.spec, scene.params, torch.float64),
                lambda: ft.wide_cull_tables(scene.spec, scene.params, torch.float64)):
        _one(_recorded(run)[1], "ops.tables")


def test_the_numbers_are_the_same_under_the_profiler():
    plain = _tracer().trace()
    traced, _ = _recorded(_tracer().trace)
    np.testing.assert_array_equal(traced.to_numpy(), plain.to_numpy())
    _, history = _design(steps=3)
    (_, traced_history), _ = _recorded(lambda: _design(steps=3))
    assert traced_history == history

"""``parallel.build_sharded_objective`` in 2-rank and 4-rank gloo worlds
on the CPU, float64, against the one-rank ``analysis.build_objective``
and the benchmark's plain reference (``doublet4_reference``).

Each rank traces its block of the doublet's six lines of rays; a
recognized loss on the kernels' route (their plain versions on CPU
tensors) combines the plan's partial sums, the gather route the records.
Three Adam steps under cosine decay through the unchanged ``optimize()``
end where the one-rank run ends up to the order of the float64 sums, with
the same bits on every rank.  Each world runs while this process computes
the one-rank runs, and is killed past its own deadline.
"""

import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark.configs import doublet_port, doublet_reference  # noqa: E402
from pyrayt_tpu_torch.analysis import build_objective  # noqa: E402
from pyrayt_tpu_torch.config import TraceConfig  # noqa: E402
from pyrayt_tpu_torch.ops import fused_grad as fg  # noqa: E402
from pyrayt_tpu_torch.tracer import engine  # noqa: E402
from torch_parallel_worlds import (  # noqa: E402
    DESCRIPTORS,
    World,
    card_route_patch,
    design_steps,
    doublet_cfg,
    doublet_objective_parts,
)

ROUTES = ("card", "gather")
CASES = [(route, descriptor) for route in ROUTES for descriptor in DESCRIPTORS]
N_PER_SOURCE, STEPS, T_MAX = 17, 3, 300  # 102 rays: not a multiple of 4
WORLD_DEADLINE_S = 120.0
RTOL = 1e-12  # the same steps over other ray partitions: the sums' order differs
REF_RTOL = 1e-9  # the port's engine against the independent reference


def log_r0():
    cfg = doublet_cfg()
    return doublet_reference.theta(cfg, {"detune": 0.02}, np.random.default_rng(2**31 + 5))[
        "log_r"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    inputs = {"rays_per_source": N_PER_SOURCE, "log_r": log_r0(), "steps": STEPS,
              "t_max": T_MAX, "cases": CASES}
    worlds = {}
    for world in (2, 4):
        workdir = tmp_path_factory.mktemp(f"objective_world{world}")
        torch.save(inputs, workdir / "inputs.pt")
        worlds[world] = World("objective", world, workdir, timeout=WORLD_DEADLINE_S)
    cfg = doublet_cfg()
    rays = doublet_port.rays(cfg, N_PER_SOURCE, "cpu", torch.float64)
    config = TraceConfig(generation_limit=cfg["generation_limit"], fixed_loop=True)
    one = {}
    for route, descriptor in CASES:
        undo = card_route_patch(route == "card")
        try:
            build, loss = doublet_objective_parts(cfg, descriptor)
            one[(route, descriptor)] = design_steps(build_objective(build, rays, loss, config),
                                                    inputs["log_r"], STEPS, T_MAX)
        finally:
            undo()
    return types.SimpleNamespace(one=one, by_world={w: x.wait() for w, x in worlds.items()})


def _close(got, want, rtol):
    np.testing.assert_allclose(np.asarray(got, dtype=np.float64),
                               np.asarray(want, dtype=np.float64), rtol=rtol, atol=0)


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("route,descriptor", CASES)
def test_three_adam_steps_equal_the_one_rank_objective(runs, world, route, descriptor):
    want = runs.one[(route, descriptor)]
    for out in runs.by_world[world]:
        got = out[(route, descriptor)]
        _close(got["history"], want["history"], RTOL)
        _close(got["theta"], want["theta"], RTOL)
        _close(got["loss0"], want["loss0"], RTOL)
        _close(got["grad0"], want["grad0"], RTOL)


@pytest.mark.parametrize("world", [2, 4])
def test_every_rank_gets_the_same_bits(runs, world):
    first = runs.by_world[world][0]
    assert first["n_rays"] * world >= 6 * N_PER_SOURCE
    for out in runs.by_world[world][1:]:
        assert out["n_rays"] == first["n_rays"]
        for case in CASES:
            assert out[case]["history"] == first[case]["history"], case
            assert torch.equal(out[case]["theta"], first[case]["theta"]), case
            assert torch.equal(out[case]["grad0"], first[case]["grad0"]), case


@pytest.mark.parametrize("world", [2, 4])
def test_a_step_combines_sums_not_records(runs, world):
    """``parallel.mesh.all_reduce``'s counters per step (objective and
    backward): the card route combines each round of the plan's partial
    sums and the gradient (float64, gathered as world x values); the
    gather route moves every record."""
    rounds = {"soft": [2], "focus": [2], "rms": [3, 1]}
    for out in runs.by_world[world]:
        for descriptor in DESCRIPTORS:
            calls, moved = out[("card", descriptor)]["per_step"]
            assert calls == len(rounds[descriptor]) + 1
            assert moved == 8 * world * (sum(rounds[descriptor]) + 4)
            assert out[("gather", descriptor)]["per_step"][1] > 100 * moved


@pytest.mark.parametrize("world", [2, 4])
def test_loss_and_gradient_equal_the_reference(runs, world):
    for out in runs.by_world[world]:
        ref = out["reference"]
        for route in ROUTES:
            got = out[(route, "soft")]
            _close(got["loss0"], ref["loss0"], REF_RTOL)
            _close(got["grad0"], ref["grad0"], REF_RTOL)


@pytest.mark.parametrize("descriptor", DESCRIPTORS)
def test_finish_of_the_partials_is_the_scalars(descriptor):
    """At float64 each plan's partial sums, summed and finished, give its
    scalars bit for bit; split over two blocks of rays, to rounding."""
    cfg = doublet_cfg()
    build, loss = doublet_objective_parts(cfg, descriptor)
    from pyrayt_tpu_torch.scene.compile import compile_scene
    from pyrayt_tpu_torch.scene.objects import fresh_ids

    with fresh_ids():
        scene = compile_scene(build({"log_r": log_r0()}), device="cpu", dtype=torch.float64)
    rays = doublet_port.rays(cfg, N_PER_SOURCE, "cpu", torch.float64)
    result = engine.trace_rays(scene, rays, TraceConfig(generation_limit=8, fixed_loop=True))
    records, masks = result.records, result.record_mask
    plan = fg.loss_plan(loss)
    assert plan.partials and plan.finish is not None

    def finished(blocks):
        sums = torch.zeros(0, dtype=torch.float64)
        for partials in plan.partials:
            total = sum(partials(records[..., b], masks[..., b], sums) for b in blocks)
            sums = torch.cat((sums, total))
        return plan.finish(sums)

    want = plan.scalars(records, masks)
    assert torch.equal(finished([slice(None)]), want)
    half = records.shape[-1] // 2
    _close(finished([slice(0, half), slice(half, None)]), want, 1e-14)
    assert torch.equal(plan.value(want), loss(result))


def test_the_objective_opens_its_spans():
    """Under the profiler, one rank's call and backward (a mesh of one rank,
    no group) record ``parallel.objective``, one ``parallel.partials`` per
    round of the plan's sums inside it, and ``parallel.grad_sum``."""
    from torch.profiler import ProfilerActivity, profile

    from pyrayt_tpu_torch.parallel import build_sharded_objective, default_mesh

    cfg = doublet_cfg()
    rays = doublet_port.rays(cfg, 4, "cpu", torch.float64)
    undo = card_route_patch(True)
    try:
        build, loss = doublet_objective_parts(cfg, "rms")
        objective = build_sharded_objective(build, rays, loss, TraceConfig(generation_limit=8),
                                            default_mesh(device="cpu"))
        theta = {"log_r": torch.tensor(log_r0()).requires_grad_(True)}
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            objective(theta).backward()
    finally:
        undo()
    spans = {}
    for ev in prof.profiler.kineto_results.events():
        if ev.name().startswith("pyrayt.parallel."):
            start = ev.start_ns()
            spans.setdefault(ev.name()[len("pyrayt.parallel."):], []).append(
                (start, start + ev.duration_ns()))
    assert sorted(spans) == ["grad_sum", "objective", "partials"]
    ((lo, hi),) = spans["objective"]
    assert len(spans["partials"]) == 2 and all(lo <= s and e <= hi for s, e in spans["partials"])
    assert len(spans["grad_sum"]) == 1 and spans["grad_sum"][0][0] >= hi


# ``doublet.optimize``'s design loop on one rank (the benchmark's doublet,
# SoftFocusError, float32, the kernels' route in its plain versions, 6 x 50
# rays, six cosine-decayed Adam steps from a seeded detune), recorded before
# the loss plans gained their partial sums
ONE_CARD_HISTORY = ["0x1.48782c0000000p+5", "0x1.05edcc0000000p+5", "0x1.9285b40000000p+4",
                    "0x1.2687580000000p+4", "0x1.93049a0000000p+3", "0x1.f4253e0000000p+2"]


def test_one_card_design_history_is_unchanged():
    from pyrayt_tpu_torch.analysis import optimize
    from pyrayt_tpu_torch.scene.objects import fresh_ids

    cfg = doublet_cfg()
    drawn = doublet_reference.theta(cfg, {"detune": 0.02}, np.random.default_rng(2**31 + 7))
    theta0 = {"log_r": torch.tensor(drawn["log_r"], dtype=torch.float32)}
    rays = doublet_port.rays(cfg, 50, "cpu", torch.float32)
    with fresh_ids():
        sid = doublet_port.components(cfg, theta0)[-1].get_id()
    undo = card_route_patch(True)
    try:
        objective = build_objective(lambda th: doublet_port.components(cfg, th), rays,
                                    doublet_port.loss(cfg, sid),
                                    TraceConfig(generation_limit=8, fixed_loop=True))
        _, history = optimize(objective, theta0, steps=6, learning_rate=5e-3, scheduler=lambda o:
                              torch.optim.lr_scheduler.CosineAnnealingLR(o, T_max=300))
    finally:
        undo()
    assert [float(h).hex() for h in history] == ONE_CARD_HISTORY

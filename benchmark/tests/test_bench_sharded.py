"""The ``sharded`` kind at CPU size: two gloo ranks, rank 0 in the test
process and rank 1 spawned, with the port's card route (K1's and K3's
plain versions on the CPU) or its gather route.

Sound runs read true; the control (the reference in bfloat16 in the
program's place), the reference with one rank's rays left out, and a
rank that finishes the loss from its own rays' sums in place of every
rank's read false."""

import sys
import time
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark.harness import common, manifest, runner, sharded  # noqa: E402

CELL = "doublet.sharded4"
SEED = 2**31 + 23
TRAFFIC = dict(manifest.traffic("sharded2p28"), rays_per_source=101, steps=5, warmup_steps=1,
               reference_block=128)
CFG = dict(manifest.config_numbers("doublet4"), ranks=2, mesh={"hosts": 1, "rays": 2})


def card_route(kind, value):
    """The kernels' route on every rank (their plain versions on the CPU)."""
    if kind == "rank":
        from pyrayt_tpu_torch.ops import fused_trace

        fused_trace.pick_fused = lambda spec, config, device: True
    return value


def local_scalars(kind, value):
    """Rank 1 finishes the loss from its own rays' sums (it still joins
    every collective, so the ranks stay in step)."""
    card_route(kind, value)
    if kind == "rank" and value == 1:
        from pyrayt_tpu_torch.parallel import objective

        every_rank = objective._global_scalars

        def own(plan, mesh):
            combined = every_rank(plan, mesh)

            def scalars(records, masks):
                combined(records, masks)
                return plan.scalars(records, masks)

            return scalars

        objective._global_scalars = own
    return value


@pytest.fixture(autouse=True)
def _restore_the_port():
    """Rank 0 runs in this process: undo what a run's hooks patched."""
    from pyrayt_tpu_torch.ops import fused_trace
    from pyrayt_tpu_torch.parallel import objective

    saved = fused_trace.pick_fused, objective._global_scalars
    yield
    fused_trace.pick_fused, objective._global_scalars = saved


def _run(fault=None):
    return runner.run_cell(CELL, SEED, 2.0, False, "cpu", time.perf_counter(), TRAFFIC, fault,
                           CFG)


@pytest.mark.parametrize("route", [card_route, None], ids=["card_route", "gather_route"])
def test_a_sound_run_is_correct(route):
    result = _run(route)
    assert result.correct, result.checks
    assert result.attempted > 0 and result.failed == 0
    assert result.device["count"] == 2


def test_a_rank_on_its_own_sums_is_not_correct():
    result = _run(local_scalars)
    assert not result.correct, result.checks


def test_the_control_and_a_rank_left_out_are_not_correct():
    numbers = sharded.calibrate(CELL, SEED, "cpu", TRAFFIC, CFG, left_out=1)
    for label in ("control", "left_out"):
        ok, checks = common.judge(numbers[label], manifest.limits(CELL))
        assert not ok, (label, checks)

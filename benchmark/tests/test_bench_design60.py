"""``doublet.design60`` (the ``optimize`` kind on the lens-design example's
60 rays) at its own size on the CPU: a sound run reads true, and the
control, half of the batch and a step that leaves its state unchanged
read false under the cell's limits."""

import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import calibrate  # noqa: E402
from benchmark.harness import common, manifest, runner  # noqa: E402

CELL = "doublet.design60"
SEED = 2**31 + 29
TRAFFIC = dict(manifest.traffic("design60_cosine"), steps=6, warmup_steps=2)


def _run(fault=None):
    return runner.run_cell(CELL, SEED, 3.0, False, "cpu", time.perf_counter(), TRAFFIC, fault)


def state_unchanged(kind, value):
    if kind == "optimizer":
        for group in value.param_groups:
            group["lr"] = 0.0
    return value


def test_a_sound_run_is_correct():
    result = _run()
    assert result.correct, result.checks
    assert result.attempted > 0 and result.failed == 0


def test_a_step_that_leaves_the_state_unchanged_is_not_correct():
    assert not _run(state_unchanged).correct


def test_the_control_and_half_the_batch_are_not_correct():
    for reading in (calibrate.control, calibrate.half_batch):
        ok, checks = common.judge(reading(CELL, SEED, "cpu", TRAFFIC), manifest.limits(CELL))
        assert not ok, (reading.__name__, checks)

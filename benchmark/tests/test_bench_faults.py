"""``correct`` comes out false where it must.

The control (the plain reference in bfloat16 in the program's place) fails
each cell's comparison, and every run of the harness, with the look for a
card skipped and the timed path broken underneath, reads false for each
fault its cell can have: a step that leaves its state unchanged, half of
the batch left out, an answer altered where it is produced.  Sound runs of
the same sizes read true.  The sizes are small enough for the CPU, where
the port runs its plain engine; on the card ``calibrate.py`` reads the
control at each cell's own size."""

import sys
import time
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import calibrate  # noqa: E402
from benchmark.harness import common, manifest, runner  # noqa: E402

SEED = 2**31 + 11
SMALL = {
    "doublet.optimize": (dict(manifest.traffic("design300_cosine"), rays_per_source=200,
                              steps=6, warmup_steps=2, reference_block=600), None, 3.0),
    "mla16.optimize": (dict(manifest.traffic("design30"), rays_per_source=4096, steps=5,
                            warmup_steps=2, reference_block=2048),
                       dict(manifest.config_numbers("mla16"), n=4), 3.0),
    "mla16.trace": (dict(manifest.traffic("frame2p20"), rays_per_source=4096,
                         reference_block=2048), dict(manifest.config_numbers("mla16"), n=4), 1.0),
    "doublet.spot": (dict(manifest.traffic("tolerance16m"), rays_per_source=300,
                          reference_block=900), None, 1.0),
}


def _run(cell, fault=None):
    traffic, cfg, seconds = SMALL[cell]
    return runner.run_cell(cell, SEED, seconds, False, "cpu", time.perf_counter(), traffic,
                           fault, cfg)


def _first_half(rays):
    n = rays.n_rays // 2
    return type(rays)(**{f: getattr(rays, f)[..., :n] for f in (
        "positions", "directions", "generation", "intensity", "wavelength", "index", "id")})


def state_unchanged(kind, value):
    if kind == "optimizer":  # every step leaves the parameters as they were
        for group in value.param_groups:
            group["lr"] = 0.0
    return value


def half_batch(kind, value):
    if kind == "rays":
        return _first_half(value)
    if kind == "frame":  # the rows of the first half of the rays
        return value[value["id"] < value["id"].max() / 2]
    if kind == "result":  # the second half's records dropped; the mean over the rest
        mask = value.record_mask.clone()
        mask[:, mask.shape[1] // 2:] = False
        return value.replace(record_mask=mask)
    return value


def answer_altered(kind, value):
    if kind == "objective":
        return lambda theta: value(theta) * 1.01
    if kind == "frame":
        value = value.copy()
        value["y1"] += 1e-3
        return value
    if kind == "radius":
        return value * 1.01
    return value


FAULTS = {
    "doublet.optimize": [state_unchanged, half_batch, answer_altered],
    "mla16.optimize": [state_unchanged, half_batch, answer_altered],
    "mla16.trace": [half_batch, answer_altered],
    "doublet.spot": [half_batch, answer_altered],
}


@pytest.mark.parametrize("cell", list(SMALL))
def test_a_sound_run_is_correct(cell):
    result = _run(cell)
    assert result.correct, result.checks
    assert result.attempted > 0 and result.failed == 0


@pytest.mark.parametrize("cell,fault", [(c, f) for c, fs in FAULTS.items() for f in fs],
                         ids=lambda x: x if isinstance(x, str) else x.__name__)
def test_a_fault_is_not_correct(cell, fault):
    result = _run(cell, fault)
    assert not result.correct, result.checks


@pytest.mark.parametrize("cell", list(SMALL))
def test_the_control_is_not_correct(cell):
    traffic, cfg, _ = SMALL[cell]
    ok, checks = common.judge(calibrate.control(cell, SEED, "cpu", traffic, cfg),
                              manifest.limits(cell))
    assert not ok, checks


@pytest.mark.parametrize("cell", ["doublet.optimize", "mla16.optimize"])
def test_half_the_batch_read_by_the_reference_is_not_correct(cell):
    traffic, cfg, _ = SMALL[cell]
    ok, checks = common.judge(calibrate.half_batch(cell, SEED, "cpu", traffic, cfg),
                              manifest.limits(cell))
    assert not ok, checks


def test_the_control_runs_in_bfloat16():
    assert calibrate.LOW == torch.bfloat16

"""The ``mla32`` configuration and its cell ``mla32.optimize`` on the CPU.

The manifest names it with a source of its own and nothing cut; its numbers
are ``mla16``'s at n = 32; the plain reference equals the port's plain
engine record for record on the 32 x 32 array; and at CPU size a sound run
reads true while the bfloat16 control, half of the batch read by the
reference and each planted fault of the timed path read false under the
cell's limits."""

import json
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import calibrate  # noqa: E402
from benchmark.configs import mla32_port, mla32_reference  # noqa: E402
from benchmark.harness import common, manifest, runner  # noqa: E402
from benchmark.reference import solve  # noqa: E402
from benchmark.tests.test_bench_faults import (  # noqa: E402
    answer_altered,
    half_batch,
    state_unchanged,
)

CELL = "mla32.optimize"
SEED = 2**31 + 13
CFG = manifest.config_numbers("mla32")
# the cell's run at CPU size: every lenslet of the 32 x 32 array, an eighth
# of them hit by a 12 x 11 grid, and a window that holds a design run's
# first four steps even on a loaded CPU (about 0.3 s a step alone)
SMALL = dict(manifest.traffic("design30_2p22"), rays_per_source=128, steps=5,
             warmup_steps=2, reference_block=64)
SECONDS = 10.0


def test_the_manifest_names_mla32_with_a_source_of_its_own():
    entries = {c["name"]: c for c in manifest.load()["configs"]}
    mla32, mla16 = entries["mla32"], entries["mla16"]
    assert mla32["source"] != mla16["source"] and mla32["reduced"] == []
    numbers = json.loads((ROOT / mla32["file"]).read_text())
    assert numbers["source"] == mla32["source"] and numbers["reduced"] == []
    mla16_numbers = manifest.config_numbers("mla16")
    assert {k for k in numbers if numbers.get(k) != mla16_numbers.get(k)} \
        == {"name", "source", "n", "why"}
    assert numbers["n"] == 32
    cell = manifest.workload(CELL)
    assert (cell["config"], cell["traffic"], cell["chips"]) == ("mla32", "design30_2p22", 1)
    mix = manifest.traffic("design30_2p22")
    assert mix["kind"] == "optimize" and mix["rays_per_source"] == 4096 * 32 * 32
    assert (mix["steps"], mix["learning_rate"]) == (30, 0.02)
    assert mla32_reference.scene_counts(CFG)[0] == 2049


def test_the_reference_equals_the_port_plain_trace():
    from pyrayt_tpu_torch.config import TraceConfig
    from pyrayt_tpu_torch.scene.compile import compile_scene
    from pyrayt_tpu_torch.scene.objects import fresh_ids
    from pyrayt_tpu_torch.tracer import engine

    n_rays = 48 * 48
    theta = mla32_reference.theta(CFG, manifest.traffic("design30_2p22"),
                                  np.random.default_rng(SEED))
    with fresh_ids():
        parts = mla32_port.components(CFG, theta)
    assert parts[-1].get_id() == mla32_reference.surface_id(CFG)
    scene = compile_scene(parts, device="cpu", dtype=torch.float64)
    result = engine.trace_rays(scene, mla32_port.rays(CFG, n_rays, "cpu", torch.float64),
                               TraceConfig(generation_limit=4, fixed_loop=True))
    th = {k: torch.as_tensor(v) for k, v in theta.items()}
    records, masks = solve.trace_records(mla32_reference, CFG, th,
                                         mla32_reference.rays(CFG, n_rays, torch.float64, "cpu"),
                                         torch.float64, block=1000)
    assert torch.equal(masks, result.record_mask)
    assert int(masks.sum()) > n_rays
    gap = (records - result.records).abs().permute(1, 0, 2)[:, masks]
    assert float(gap.max()) <= 1e-9


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread, as ``run.py`` runs a cell: with a pool per test
    worker the small ops of a CPU-size step fight over the cores, and one
    step took 52 s beside two other workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _run(fault=None):
    return runner.run_cell(CELL, SEED, SECONDS, False, "cpu", time.perf_counter(), SMALL, fault)


def test_a_sound_run_is_correct():
    result = _run()
    assert result.correct, result.checks
    assert result.attempted > 0 and result.failed == 0


@pytest.mark.parametrize("fault", [state_unchanged, half_batch, answer_altered],
                         ids=lambda f: f.__name__)
def test_a_fault_is_not_correct(fault):
    result = _run(fault)
    assert not result.correct, result.checks


@pytest.mark.parametrize("reading", [calibrate.control, calibrate.half_batch],
                         ids=["control", "half_batch"])
def test_the_control_and_half_the_batch_are_not_correct(reading):
    ok, checks = common.judge(reading(CELL, SEED, "cpu", SMALL), manifest.limits(CELL))
    assert not ok, checks

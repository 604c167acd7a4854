"""``examples_torch/lens_design.py`` and ``lens_design.ipynb`` against the
JAX package's at float64 on the CPU, at the smoke size of
tests/test_examples (3 steps; the notebook's ``STEPS = 300`` replaced by
2): every printed line equal."""

import torch

from torch_examples import line_faults, load, run, run_notebook

STEPS = ("STEPS = 300", "STEPS = 2")
ON_CPU = [("DEVICE = None", 'DEVICE = "cpu"'), ("DTYPE = torch.float32", "DTYPE = torch.float64")]


def test_script_prints_what_jax_prints():
    _, expected = run(load("jax", "lens_design").main, steps=3, show=False)
    _, lines = run(load("torch", "lens_design").main, steps=3, show=False, device="cpu",
                   dtype=torch.float64)
    assert not line_faults(lines, expected)
    assert lines[3] == "doublet:" and any("optimized" in line for line in lines)
    assert lines[-1] == "chromatic aberration reduced: True"


def test_notebook_prints_what_jax_prints():
    expected, j_ns = run_notebook("jax", [STEPS])
    lines, ns = run_notebook("torch", [STEPS] + ON_CPU)
    assert not line_faults(lines, expected)
    assert any(line.startswith("optimized radii:") for line in lines)
    assert lines[-1].startswith("chromatic aberration reduced:")
    assert ns["theta"].dtype == torch.float64 and ns["rays"].device.type == "cpu"
    assert len(ns["history"]) == len(j_ns["history"]) == 2

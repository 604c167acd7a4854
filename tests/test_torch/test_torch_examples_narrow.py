"""The three narrow example scripts of ``examples_torch/`` against the JAX
package's ``examples/`` at float64 on the CPU: every printed line equal.
Also: no port example imports JAX or the JAX package, and every entry
point means the card by default and raises without one."""

import pytest
import torch

from torch_examples import (FORBIDDEN, SCRIPTS, TORCH_DIR, imported_roots, line_faults, load,
                            run, run_notebook)

NARROW = ("convex_collimator", "chromatic_dispersion", "reflective_beam_expander")


@pytest.mark.parametrize("name", NARROW)
def test_printed_lines_match_jax(name):
    _, expected = run(load("jax", name).main, show=False)
    _, lines = run(load("torch", name).main, show=False, device="cpu", dtype=torch.float64)
    assert not line_faults(lines, expected)
    assert lines  # the script printed its results


def test_narrow_scripts_print_what_the_jax_smoke_tests_assert():
    _, collimator = run(load("torch", "convex_collimator").main, device="cpu",
                        dtype=torch.float64)
    assert "traced 150 segments" in collimator[0] and collimator[1].endswith("True")
    _, prism = run(load("torch", "chromatic_dispersion").main, device="cpu",
                   dtype=torch.float64)
    assert sum(line.count("->") for line in prism) >= 11
    _, expander = run(load("torch", "reflective_beam_expander").main, device="cpu",
                      dtype=torch.float64)
    assert any("beam expansion: 4.000x" in line for line in expander)


@pytest.mark.parametrize("path", sorted(TORCH_DIR.iterdir()), ids=lambda p: p.name)
def test_no_example_imports_jax(path):
    assert path.suffix in (".py", ".ipynb")
    roots = imported_roots(path)
    assert "pyrayt_tpu_torch" in roots
    assert not roots & set(FORBIDDEN), roots & set(FORBIDDEN)


def test_every_script_is_ported():
    assert {p.stem for p in TORCH_DIR.glob("*.py")} == set(SCRIPTS)
    assert (TORCH_DIR / "lens_design.ipynb").exists()


@pytest.mark.parametrize("name,entry", [(n, "main") for n in SCRIPTS]
                         + [("microlens_array", "main_per_lenslet")])
def test_the_card_is_the_default_and_there_is_no_cpu_fallback(monkeypatch, name, entry):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        getattr(load("torch", name), entry)()


def test_the_notebook_means_the_card_too(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        run_notebook("torch")

"""The port's aberration analyses (``pyrayt_tpu_torch.analysis.aberrations``)
against the JAX package's on the same systems, float64, CPU.

Each analysis makes its own rays from a line source, which both packages
build alike, so the tables must agree to rounding (rtol 1e-9: the two
engines' float64 arithmetic in another order); the physics checks of
tests/test_analysis/test_aberrations.py run on the port's tables too.
"""

import numpy as np
import pandas as pd
import pytest
import torch

from pyrayt_tpu.analysis import aberrations as j_ab
from pyrayt_tpu_torch.analysis import aberrations as t_ab
from pyrayt_tpu_torch.utils import lensmakers_equation
from torch_parity_scenes import TORCH_NS

RTOL, ATOL = 1e-9, 1e-12
N_IDEAL = 1.5
CPU = dict(device="cpu", dtype=torch.float64)


def singlet(m, glass="ideal", focal_length=2.0, thickness=0.05):
    """A symmetric biconvex singlet and an imager at twice its focal length."""
    r = 2 * (N_IDEAL - 1) * focal_length
    lens = m.comp.thick_lens(r, -r, thickness, aperture=1.0, material=m.matl.glass[glass])
    return [lens, m.comp.baffle((4.0, 4.0)).move_x(2.0 * focal_length)]


def twin_systems(twins, build):
    with twins.jax.fresh_ids():
        j_system = build(twins.jax)
    with TORCH_NS.fresh_ids():
        t_system = build(TORCH_NS)
    return j_system, t_system


def assert_tables_equal(t_table: pd.DataFrame, j_table: pd.DataFrame):
    assert list(t_table.columns) == list(j_table.columns) and len(t_table) == len(j_table)
    for column in j_table.columns:
        np.testing.assert_allclose(t_table[column].to_numpy(), j_table[column].to_numpy(),
                                   rtol=RTOL, atol=ATOL, err_msg=column)


@pytest.mark.parametrize("max_radius", [0.1, 0.8])
def test_spherical_aberration_matches_jax(twins, max_radius):
    j_system, t_system = twin_systems(twins, singlet)
    kw = dict(ray_origin=-1.0, max_radius=max_radius, sample_points=11)
    t_table = t_ab.spherical_aberration(t_system, **kw, **CPU)
    assert_tables_equal(t_table, j_ab.spherical_aberration(j_system, **kw))
    f = lensmakers_equation(2.0, -2.0, N_IDEAL, 0.05)
    focus = t_table.sort_values("radius")["focus"].to_numpy()
    if max_radius < 0.5:  # paraxial: the lensmaker's focus within 1%
        assert np.allclose(focus, f, rtol=0.01)
    else:  # a biconvex lens: the marginal focus is shorter
        assert focus[-1] < focus[0] and focus[-1] < f


@pytest.mark.parametrize("glass", ["BK7", "ideal"])
def test_chromatic_aberration_matches_jax(twins, glass):
    j_system, t_system = twin_systems(twins, lambda m: singlet(m, glass))
    kw = dict(ray_origin=-1.0, test_radius=0.05, wavelengths=(0.4861, 0.5893, 0.6563))
    t_table = t_ab.chromatic_aberration(t_system, **kw, **CPU)
    assert_tables_equal(t_table, j_ab.chromatic_aberration(j_system, **kw))
    focus = t_table.sort_values("wavelength")["focus"].to_numpy()
    if glass == "BK7":  # normal dispersion: blue focuses shorter
        assert focus[0] < focus[1] < focus[2]
    else:
        assert np.allclose(focus, focus[0], rtol=1e-9)


def test_coma_matches_jax(twins):
    j_system, t_system = twin_systems(twins, singlet)
    values = {}
    for label, max_radius, angle in (("on_axis", 0.05, 0.0), ("off_axis", 0.5, 5.0)):
        kw = dict(ray_origin=-1.0, max_radius=max_radius, angle=angle)
        values[label] = t_ab.coma(t_system, **kw, **CPU)
        assert values[label] == pytest.approx(j_ab.coma(j_system, **kw), rel=RTOL, abs=ATOL)
    assert values["on_axis"] < 1e-6 and values["off_axis"] > values["on_axis"]


def test_aberrations_default_to_the_card(monkeypatch):
    """``device=None`` means the CUDA card, as every entry point of the
    port: without one the analysis raises instead of tracing on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with TORCH_NS.fresh_ids():
        system = singlet(TORCH_NS)
    with pytest.raises(RuntimeError, match="CUDA"):
        t_ab.coma(system, ray_origin=-1.0, max_radius=0.5, angle=5.0)

"""Optics utilities: wavelength -> RGB and the lensmaker's equation.

Counterpart of ``pyrayt_tpu.utils``; both functions are plain NumPy /
arithmetic.
"""

from __future__ import annotations

import numpy as np

__all__ = ["wavelength_to_rgb", "lensmakers_equation"]


# The Bruton visible-spectrum approximation as a zone table.  Each zone is
# (lo_um, hi_um, (r, g, b), edge) where a channel spec is 0, 1, "up"
# (linear ramp across the zone) or "down" (reverse ramp); ``edge`` marks the
# spectrum ends, which fade to 30% brightness.
_SPECTRUM_ZONES = (
    (0.380, 0.440, ("down", 0, 1), "lo"),
    (0.440, 0.490, (0, "up", 1), None),
    (0.490, 0.510, (0, 1, "down"), None),
    (0.510, 0.580, ("up", 1, 0), None),
    (0.580, 0.645, (1, "down", 0), None),
    (0.645, 0.750, (1, 0, 0), "hi"),
)


def wavelength_to_rgb(wavelength, gamma=0.8) -> np.ndarray:
    """Visible-spectrum (0.38-0.75 um) wavelengths to gamma-corrected RGB.

    Piecewise-linear spectrum approximation; out-of-range wavelengths take
    the nearest band-edge color.  Returns an (n, 3) array.
    """
    wl = np.atleast_1d(np.asarray(wavelength, dtype=float))
    band = np.clip(wl, _SPECTRUM_ZONES[0][0], _SPECTRUM_ZONES[-1][1])
    rgb = np.zeros((wl.shape[0], 3))

    for lo, hi, channels, edge in _SPECTRUM_ZONES:
        last = hi == _SPECTRUM_ZONES[-1][1]
        in_zone = (band >= lo) & ((band <= hi) if last else (band < hi))
        ramp = (band - lo) / (hi - lo)
        if edge == "lo":
            brightness = 0.3 + 0.7 * ramp
        elif edge == "hi":
            brightness = 1.0 - 0.7 * ramp
        else:
            brightness = np.ones_like(ramp)
        for c, spec in enumerate(channels):
            level = {0: 0.0, 1: 1.0, "up": ramp, "down": 1.0 - ramp}[spec]
            # clamp at 0: a ramp can sit 1 ulp outside [0, 1], and a negative
            # base under a fractional power is NaN
            value = np.maximum(level * brightness, 0.0) ** gamma
            rgb[:, c] = np.where(in_zone, value, rgb[:, c])
    return rgb


def lensmakers_equation(r1: float, r2: float, n_lens: float, thickness: float) -> float:
    """Thick-lens paraxial focal length."""
    p = (n_lens - 1) * (1 / r1 - 1 / r2 + (n_lens - 1) * thickness / (n_lens * r1 * r2))
    return 1 / p

"""Gooch (cool-to-warm) shading for the viewport renderers (counterpart
of ``pyrayt_tpu.render.gooch``).

Per-pixel color = mix(warm tone, cool tone) with the mixture ratio
(1 + l . n) / 2 averaged over the lights.  Shading is host-side NumPy over
at most about a million pixels; the nearest-hit pass that finds them runs
on the card (renderers.py).  With more than one light, each light's vector
is normalized on its own (the reference PyRayT normalizes an (L, 3, n)
array by an (L, n) norm, which agrees for the single light the renderers
pass).
"""

from __future__ import annotations

import abc
from dataclasses import dataclass, field

import numpy as np

from pyrayt_tpu_torch.render import color
from pyrayt_tpu_torch.render.color import RGBAColor

__all__ = [
    "Material",
    "GoochMaterial",
    "WHITE",
    "RED",
    "GREEN",
    "BLUE",
    "YELLOW",
    "ORANGE",
    "BLACK",
]


class Material(abc.ABC):
    """Base class for all viewport (render) materials."""

    @abc.abstractmethod
    def shade(self, rays, normals, light_positions) -> np.ndarray:
        """Per-pixel RGBA values, shape (4, n)."""


@dataclass
class GoochMaterial(Material):
    base_color: RGBAColor = field(default_factory=RGBAColor)
    warm_color: RGBAColor = field(default_factory=RGBAColor)
    cool_color: RGBAColor = field(default_factory=RGBAColor)

    alpha: float = 0.3
    beta: float = 0.3

    def shade(self, rays, normals, light_positions) -> np.ndarray:
        """Cool-to-warm shade of hit points.

        ``rays``: (2, 4, n) hit positions + view directions (world space);
        ``normals``: (4, n) or (4,) unit surface normals;
        ``light_positions``: (4,) single light or (4, L) light array.
        Returns (4, n) RGBA.

        Per the Gooch model: the warmth at a pixel is the mean over lights
        of (1 + cos(light, normal)) / 2, and the pixel color interpolates
        between two tones, each the warm/cool hue pulled toward the
        surface's own color by alpha/beta.
        """
        rays = np.atleast_3d(np.asarray(rays, dtype=float))
        points = rays[0, :3]
        unit_n = np.asarray(normals, dtype=float)
        if unit_n.ndim == 1:
            unit_n = unit_n[:, None]
        unit_n = unit_n[:3]

        lights = np.asarray(light_positions, dtype=float)
        if lights.ndim == 1:
            lights = lights[:, None]

        # accumulate cos(light, normal) light by light (viewport scenes have
        # one or two lights; a Python loop keeps the memory footprint flat)
        n_lights = lights.shape[1]
        cos_total = np.zeros(points.shape[1])
        for k in range(n_lights):
            to_light = lights[:3, k : k + 1] - points
            to_light /= np.linalg.norm(to_light, axis=0)
            cos_total += np.sum(to_light * unit_n, axis=0)
        warmth = 0.5 + cos_total / (2.0 * n_lights)

        warm_tone = np.asarray(self.warm_color) + self.alpha * (
            np.asarray(self.base_color) - np.asarray(self.warm_color)
        )
        cool_tone = np.asarray(self.cool_color) + self.beta * (
            np.asarray(self.base_color) - np.asarray(self.cool_color)
        )
        return warm_tone[:, None] * warmth + cool_tone[:, None] * (1.0 - warmth)


def _blue_yellow_gooch(base_color):
    return GoochMaterial(
        base_color=base_color, warm_color=color.ORANGE, cool_color=color.BLUE
    )


WHITE = _blue_yellow_gooch(color.WHITE)
RED = _blue_yellow_gooch(color.RED)
GREEN = _blue_yellow_gooch(color.GREEN)
BLUE = GoochMaterial(
    base_color=color.BLUE, warm_color=color.YELLOW, cool_color=color.BLUE, alpha=0.2
)
YELLOW = _blue_yellow_gooch(color.YELLOW)
ORANGE = _blue_yellow_gooch(color.ORANGE)
BLACK = _blue_yellow_gooch(color.BLACK)

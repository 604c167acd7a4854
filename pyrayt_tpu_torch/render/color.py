"""RGBA color type and named constants (counterpart of
``pyrayt_tpu.render.color``): a 4-vector ndarray subclass with r/g/b/a
accessors.  Colors are host-side viewport data and stay NumPy."""

from __future__ import annotations

import numpy as np

__all__ = [
    "RGBAColor",
    "WHITE",
    "BLACK",
    "RED",
    "GREEN",
    "BLUE",
    "YELLOW",
    "ORANGE",
]


class RGBAColor(np.ndarray):
    def __new__(cls, r: float = 0.0, g: float = 0.0, b: float = 0.0, a: float = 1.0):
        obj = np.asarray([r, g, b, a], dtype=float).view(cls)
        return obj

    @property
    def r(self):
        return self[0]

    @r.setter
    def r(self, value):
        self[0] = value

    @property
    def g(self):
        return self[1]

    @g.setter
    def g(self, value):
        self[1] = value

    @property
    def b(self):
        return self[2]

    @b.setter
    def b(self, value):
        self[2] = value

    @property
    def a(self):
        return self[3]

    @a.setter
    def a(self, value):
        self[3] = value


WHITE = RGBAColor(1, 1, 1)
BLACK = RGBAColor()
RED = RGBAColor(1, 0, 0)
GREEN = RGBAColor(0, 1, 0)
BLUE = RGBAColor(0, 0, 1)
YELLOW = RGBAColor(1, 1, 0)
ORANGE = RGBAColor(1, 0.5, 0)

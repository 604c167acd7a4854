"""Optical materials of the PyTorch port.

Counterpart of ``pyrayt_tpu.materials``: absorber, mirror, ``Glass``,
``BasicRefractor``, ``SellmeierRefractor`` and the glass catalog.

Two interfaces per material:

* ``trace(surface, ray_set)`` — eager, object-oriented;
* ``pure_trace(directions, normals, wavelength, index, intensity)`` — the
  branch-free form the plain engine evaluates for every ray under that
  material's dispatch mask.

Built-in refractive materials expose their dispersion model as a packed
row ``[A, b1, b2, b3, c1, c2, c3]`` meaning
``n(lambda) = sqrt(A + sum_i b_i l^2 / (l^2 - c_i))``: ``A = n0^2`` with all
``b = 0`` is a constant index, ``A = 1`` the Sellmeier equation.  The
engines read these rows from the scene params.
"""

from __future__ import annotations

import abc
from functools import lru_cache
from typing import Union

import numpy as np
import torch

from pyrayt_tpu_torch.core.operations import reflect, refract

__all__ = [
    "TracableMaterial",
    "Glass",
    "BasicRefractor",
    "SellmeierRefractor",
    "absorber",
    "mirror",
    "glass",
    "index_from_coeffs",
    "KIND_ABSORB",
    "KIND_MIRROR",
    "KIND_GLASS",
    "N_GLASS_COEFFS",
]

# material kind codes used by the flattened scene representation
KIND_ABSORB = 0
KIND_MIRROR = 1
KIND_GLASS = 2

N_GLASS_COEFFS = 7


def index_from_coeffs(coeffs, wavelength):
    """Refractive index from a packed ``[A, b1..b3, c1..c3]`` row.

    Each Sellmeier denominator is guarded at its pole (``wl^2 == c`` gives
    1, as the CUDA kernels do): no real trace evaluates there, but an
    unguarded 0/0 of a constant-index row (``c = 0``) at a zero wavelength
    would emit a NaN whose gradient poisons the summed glass cotangent."""
    wl2 = wavelength**2
    n2 = coeffs[0]
    for i in range(3):
        b, c = coeffs[1 + i], coeffs[4 + i]
        den = wl2 - c
        n2 = n2 + b * wl2 / torch.where(den == 0, 1.0, den)
    return torch.sqrt(n2)


def _coeff_row(values):
    """A packed glass row: a tensor when any value requires grad."""
    traced = [v for v in values if isinstance(v, torch.Tensor) and v.requires_grad]
    if traced:
        ref = traced[0]
        return torch.stack(
            [torch.as_tensor(v, dtype=ref.dtype, device=ref.device).reshape(()) for v in values]
        )
    return np.asarray([float(v) for v in values], dtype=float)


def _sqrt(x):
    return torch.sqrt(x) if isinstance(x, torch.Tensor) else np.sqrt(x)


class TracableMaterial(abc.ABC):
    """Base class for any material traceable by RayTracer objects."""

    kind: int  # one of the KIND_* codes

    def __init__(self, base_material=None, *args, **kwargs):
        super().__init__(*args, **kwargs)
        # the render material used when the object is drawn
        self._base_material = base_material

    def shade(self, rays, normals, light_positions):
        """Viewport RGBA (4, n) of the pixels that see this material: its
        render material's Gooch shade (black when it has none)."""
        from pyrayt_tpu_torch.render import gooch

        base = self._base_material or gooch.BLACK
        return base.shade(rays, normals, light_positions)

    @abc.abstractmethod
    def trace(self, surface, ray_set):
        """Eagerly update a RaySet after hitting ``surface``."""

    @abc.abstractmethod
    def pure_trace(self, directions, normals, wavelength, index, intensity):
        """Functional form: returns (new_directions, new_index, new_intensity)."""

    def glass_coeffs(self):
        """Packed dispersion row for the scene params (zeros if N/A); a
        tensor when a coefficient requires grad."""
        return np.zeros(N_GLASS_COEFFS)


def _as_float(value) -> float:
    if isinstance(value, torch.Tensor) and value.requires_grad:
        raise TypeError("non-concrete material value")
    return float(value)


class _ValueIdentity:
    """Equality/hash by physical value, not object identity: rebuilt but
    identical materials share a material slot in ``compile_scene``.
    Values that require grad fall back to identity."""

    def _value_key(self):
        return ()

    def __eq__(self, other):
        if type(other) is not type(self):
            return NotImplemented
        try:
            return self._value_key() == other._value_key()
        except TypeError:
            return self is other

    def __hash__(self):
        try:
            return hash((type(self),) + self._value_key())
        except TypeError:
            return object.__hash__(self)


class _AbsorbingMaterial(_ValueIdentity, TracableMaterial):
    """Ideal absorber: zeroes the direction vector, which the tracer reads
    as a dead ray."""

    kind = KIND_ABSORB

    def trace(self, surface, ray_set):
        return ray_set.replace(directions=torch.zeros_like(ray_set.directions))

    def pure_trace(self, directions, normals, wavelength, index, intensity):
        return torch.zeros_like(directions), index, intensity


class _ReflectingMaterial(_ValueIdentity, TracableMaterial):
    """Ideal mirror."""

    kind = KIND_MIRROR

    def trace(self, surface, ray_set):
        normals = surface.get_world_normals(ray_set.positions)
        return ray_set.replace(directions=reflect(ray_set.directions, normals))

    def pure_trace(self, directions, normals, wavelength, index, intensity):
        return reflect(directions, normals), index, intensity


class Glass(TracableMaterial):
    """Refractive material ABC."""

    kind = KIND_GLASS

    def trace(self, surface, ray_set):
        normals = surface.get_world_normals(ray_set.positions)
        new_dirs, new_index = refract(
            ray_set.directions, normals, ray_set.index, self.index_at(ray_set.wavelength)
        )
        return ray_set.replace(directions=new_dirs, index=new_index)

    def pure_trace(self, directions, normals, wavelength, index, intensity):
        new_dirs, new_index = refract(
            directions, normals, index, self.index_at(wavelength)
        )
        return new_dirs, new_index, intensity

    @lru_cache(100)
    def abbe(self) -> float:
        """Abbe number V_d = (n_d - 1) / (n_F - n_C)."""
        n_short = self.index_at(0.4861)
        n_center = self.index_at(0.5893)
        n_long = self.index_at(0.6563)
        with np.errstate(divide="ignore"):  # a constant index has V_d = inf
            return float((n_center - 1) / (n_short - n_long))

    @abc.abstractmethod
    def index_at(self, wavelength):
        """Refractive index at ``wavelength`` (microns); shape-preserving."""


class BasicRefractor(_ValueIdentity, Glass):
    def __init__(self, refractive_index: float, *args, **kwargs):
        """Non-dispersive glass with a constant refractive index.

        Immutable: materials hash by value and key ``compile_scene``'s slot
        map.  To vary the index, build a new material or change the scene
        params' glass rows.
        """
        self._refractive_index = refractive_index
        super().__init__()

    @property
    def refractive_index(self):
        return self._refractive_index

    def _value_key(self):
        return (_as_float(self._refractive_index),)

    def index_at(self, wavelength: Union[float, torch.Tensor]):
        if isinstance(wavelength, torch.Tensor):
            return torch.full_like(wavelength, float(self._refractive_index))
        wavelength = np.asarray(wavelength)
        if wavelength.ndim == 0:
            return np.asarray(self._refractive_index, dtype=float)
        return np.full(wavelength.shape, self._refractive_index, dtype=float)

    def glass_coeffs(self):
        n = self._refractive_index
        return _coeff_row([n * n] + [0.0] * (N_GLASS_COEFFS - 1))


class SellmeierRefractor(_ValueIdentity, Glass):
    def __init__(self, b1=0, b2=0, b3=0, c1=0, c2=0, c3=0):
        """Dispersive glass following the Sellmeier equation (coefficients
        as found at refractiveindex.info).  Immutable, like BasicRefractor."""
        self._b1, self._b2, self._b3 = b1, b2, b3
        self._c1, self._c2, self._c3 = c1, c2, c3
        super().__init__()

    b1 = property(lambda self: self._b1)
    b2 = property(lambda self: self._b2)
    b3 = property(lambda self: self._b3)
    c1 = property(lambda self: self._c1)
    c2 = property(lambda self: self._c2)
    c3 = property(lambda self: self._c3)

    def _value_key(self):
        return tuple(
            _as_float(v)
            for v in (self.b1, self.b2, self.b3, self.c1, self.c2, self.c3)
        )

    def index_at(self, wavelength):
        if not isinstance(wavelength, torch.Tensor):
            wavelength = np.asarray(wavelength, dtype=float)
        wl2 = wavelength**2
        return _sqrt(
            1
            + (self.b1 * wl2) / (wl2 - self.c1)
            + (self.b2 * wl2) / (wl2 - self.c2)
            + (self.b3 * wl2) / (wl2 - self.c3)
        )

    def glass_coeffs(self):
        return _coeff_row([1.0, self.b1, self.b2, self.b3, self.c1, self.c2, self.c3])


absorber = _AbsorbingMaterial()
"""A bulk absorbing material."""

mirror = _ReflectingMaterial()
"""A perfectly reflecting material."""

glass = {
    "ideal": BasicRefractor(1.5),
    "BK7": SellmeierRefractor(
        1.03961212,
        0.231792344,
        1.01046945,
        6.00069867e-3,
        2.00179144e-2,
        1.03560653e02,
    ),
    "SF5": SellmeierRefractor(
        1.52481889, 0.187085527, 1.42729015, 0.011254756, 0.0588995392, 129.141675
    ),
    "SF2": SellmeierRefractor(
        1.40301821, 0.231767504, 0.939056586, 0.0105795466, 0.0493226978, 112.405955
    ),
}
"""A dictionary of common glasses (the same catalog as the JAX package)."""

"""Optical component factories and ray sources.

Counterpart of ``pyrayt_tpu.components``: the same CSG recipes
(thick_lens, mirrors, prism, baffle/aperture, microlens_array) and the same
source hierarchy.  Factories build NumPy scene objects; sources make rays
as tensors with an explicit ``device`` and ``dtype``.

``Lamp`` and ``StaticLamp`` draw from a seeded ``torch.Generator`` (the
JAX package uses a ``jax.random`` key): the same seed gives other numbers
than the JAX package, with the same distributions.
"""

from __future__ import annotations

import abc
import math
from functools import lru_cache, wraps
from typing import Tuple, Union

import numpy as np
import torch

import pyrayt_tpu_torch.materials as matl
from pyrayt_tpu_torch.config import default_device
from pyrayt_tpu_torch.core.operations import safe_sqrt, transform_rays
from pyrayt_tpu_torch.scene import csg
from pyrayt_tpu_torch.scene._backend import is_traced, plain
from pyrayt_tpu_torch.scene.lenslets import LensletGrid
from pyrayt_tpu_torch.scene.objects import WorldObject
from pyrayt_tpu_torch.scene.surfaces import Cuboid, Cylinder, Paraboloid, Sphere, XYPlane
from pyrayt_tpu_torch.tracer.rayset import RaySet

__all__ = [
    "thick_lens",
    "biconvex_lens",
    "plano_convex_lens",
    "plane_mirror",
    "spherical_mirror",
    "elliptical_mirror",
    "parabolic_mirror",
    "equilateral_prism",
    "baffle",
    "aperture",
    "microlens_array",
    "Source",
    "LineOfRays",
    "GridOfRays",
    "CircleOfRays",
    "ConeOfRays",
    "WedgeOfRays",
    "Lamp",
    "StaticLamp",
]


def _lens(func):
    """Inject common lens kwargs and orient the optical axis to +X."""

    @wraps(func)
    def wrapper_function(*args, **kwargs):
        lens_arguments = {"aperture": 1, "material": matl.glass["ideal"]}
        lens_arguments.update(kwargs)
        return func(*args, **lens_arguments).rotate_y(90).rotate_x(90)

    return wrapper_function


def _mirror(func):
    """Inject common mirror kwargs and orient the optical axis to +X."""

    @wraps(func)
    def wrapper_function(*args, **kwargs):
        mirror_arguments = {"aperture": 1, "material": matl.mirror, "off_axis": (0, 0)}
        mirror_arguments.update(kwargs)
        return func(*args, **mirror_arguments).rotate_y(90).rotate_x(90)

    return wrapper_function


def _create_aperture(aperture: Union[float, tuple], thickness):
    """Aperture solid: circular (float), rectangular (tuple > 0), or
    elliptical (tuple < 0)."""
    if not hasattr(aperture, "__len__"):
        return Cylinder(radius=aperture / 2, min_height=-thickness / 2, max_height=thickness / 2)
    if aperture[0] > 0 and aperture[1] > 0:
        min_corner = (-aperture[0] / 2, -aperture[1] / 2, -thickness / 2)
        max_corner = (aperture[0] / 2, aperture[1] / 2, thickness / 2)
        return Cuboid(min_corner, max_corner)
    if aperture[0] < 0 and aperture[1] < 0:
        shape = Cylinder(
            radius=abs(aperture[0]) / 2, min_height=-thickness / 2, max_height=thickness / 2
        )
        return shape.scale_y(aperture[1] / aperture[0])
    raise TypeError(f"Could not deduce an aperture from {aperture}")


def _surface_sign(r, override=None, name="r"):
    """Static classification of a lens surface radius: +1, -1, or 0 (planar).

    The per-surface CSG choice (intersect vs difference) is scene
    structure, so it must be known when the scene is compiled.  Concrete
    radii carry their own sign; traced radii (tensors that require grad)
    must state it via ``r1_sign``/``r2_sign``, and the optimizer then
    explores magnitudes within that fixed convexity.
    """
    if override is not None:
        if override not in (1, -1, 0):
            raise ValueError(f"{name}_sign must be +1, -1, or 0, got {override!r}")
        return override
    r = plain(r)
    if is_traced(r):
        raise ValueError(
            f"{name} is a traced value; its sign selects the lens's CSG "
            f"structure, which must be static under jit/grad.  Pass "
            f"{name}_sign=+1 (curving toward +Z/-X) or {name}_sign=-1."
        )
    r = float(r)
    if not np.isfinite(r):
        return 0
    return 1 if r > 0 else -1


def _lens_full_thickness(r1, r2, thickness, aperture, s1=None, s2=None) -> Tuple[float, float]:
    """Sag-extended aperture thickness + center shift for a thick lens.
    ``s1``/``s2`` are the static surface signs from :func:`_surface_sign`
    (inferred when omitted); the sag math itself takes traced values."""
    if s1 is None:
        s1 = _surface_sign(r1, name="r1")
    if s2 is None:
        s2 = _surface_sign(r2, name="r2")
    if not hasattr(aperture, "__len__"):
        max_height = aperture / 2
    else:
        max_height = np.linalg.norm(aperture) / 2

    def _sag(r):
        # aperture-edge sag of a spherical cap; safe_sqrt keeps the backward
        # pass finite as |r| approaches the semi-aperture
        r = plain(r)
        if is_traced(r):
            return torch.abs(r) - safe_sqrt(r * r - max_height**2)
        return abs(r) - np.sqrt(max(r * r - max_height**2, 0.0))

    left_thickness = thickness / 2
    if s1 == -1:
        left_thickness = left_thickness + _sag(r1)

    right_thickness = thickness / 2
    if s2 == 1:
        right_thickness = right_thickness + _sag(r2)

    center_shift = right_thickness - left_thickness
    total_thickness = right_thickness + left_thickness
    return total_thickness, center_shift


@_lens
def thick_lens(r1: float, r2: float, thickness: float, **kwargs):
    """Thick lens with arbitrary surface curvature (radius-of-curvature sign
    convention).  The first surface faces -X, the second +X; the aperture
    lies in the YZ plane.  Pass ``np.inf`` for a planar surface."""
    s1 = _surface_sign(r1, kwargs.pop("r1_sign", None), "r1")
    s2 = _surface_sign(r2, kwargs.pop("r2_sign", None), "r2")
    aperture_thickness, aperture_offset = _lens_full_thickness(
        r1, r2, thickness, kwargs.get("aperture"), s1, s2
    )

    lens = _create_aperture(kwargs.get("aperture"), aperture_thickness).move_z(
        aperture_offset / 2
    )
    lens.material = kwargs.get("material")

    if s1 != 0:
        left_side = Sphere(r1, material=kwargs.get("material")).move_z(r1 - thickness / 2)
        lens = csg.intersect(lens, left_side) if s1 > 0 else csg.difference(lens, left_side)

    if s2 != 0:
        right_side = Sphere(r2, material=kwargs.get("material")).move_z(r2 + thickness / 2)
        lens = csg.intersect(lens, right_side) if s2 < 0 else csg.difference(lens, right_side)

    return lens


@_lens
def biconvex_lens(r1: float, r2: float, thickness: float, **kwargs):
    """Biconvex thick lens (the left surface uses r1 for both its radius and
    its position)."""
    aperture_shape = _create_aperture(kwargs.get("aperture"), thickness)
    left_side = Sphere(r1).move_z(r1 - thickness / 2)
    right_side = Sphere(r2).move_z(-(r2 - thickness / 2))

    material = kwargs.get("material")
    aperture_shape.material = material
    left_side.material = material
    right_side.material = material

    return csg.intersect(csg.intersect(left_side, right_side), aperture_shape)


def _plano_convex(r, thickness, sphere_z, aperture, material):
    """The plano-convex solid before the optical-axis rotations, its sphere
    at ``z = sphere_z``."""
    aperture_shape = _create_aperture(aperture, thickness)
    right_side = Sphere(r).move_z(sphere_z)

    aperture_shape.material = material
    right_side.material = material

    return csg.intersect(right_side, aperture_shape)


@_lens
def plano_convex_lens(r: float, thickness: float, **kwargs):
    """Plano-convex lens: planar surface faces -X, sphere faces +X."""
    return _plano_convex(
        r, thickness, -(r - thickness / 2), kwargs.get("aperture"), kwargs.get("material")
    )


@_mirror
def plane_mirror(thickness: float, **kwargs):
    """Plane mirror, every side reflective."""
    off_axis = kwargs.get("off_axis")
    mirror_shape = _create_aperture(kwargs.get("aperture"), thickness).move(*off_axis, 0)
    mirror_shape.material = kwargs.get("material")
    return mirror_shape


@_mirror
def spherical_mirror(radius: float, thickness: float, **kwargs):
    """Spherical mirror; only the spherical surface reflects, the sidewalls
    absorb.  Focal point at (r/2, 0, 0).  ``radius_sign`` states the
    curvature sign explicitly."""
    off_axis = kwargs.get("off_axis")
    material = kwargs.get("material")
    aperture_arg = kwargs.get("aperture")

    sign = _surface_sign(radius, kwargs.pop("radius_sign", None), "radius")
    if sign == 0:
        raise ValueError("spherical_mirror radius must be finite and nonzero")

    l = np.sqrt(off_axis[0] ** 2 + off_axis[1] ** 2)
    if hasattr(aperture_arg, "__len__"):
        dl = np.linalg.norm(aperture_arg) / 2
    else:
        dl = aperture_arg / 2

    radius = plain(radius)
    if is_traced(radius, plain(thickness)):
        r_abs = torch.abs(radius) if is_traced(radius) else abs(radius)
        aperture_front_thickness = r_abs - safe_sqrt(
            torch.as_tensor(radius * radius - (l + dl) ** 2)
        )
    else:
        r_abs = abs(radius)
        aperture_front_thickness = r_abs - np.sqrt(radius**2 - (l + dl) ** 2)
    total_thickness = aperture_front_thickness + thickness

    aperture_solid = _create_aperture(aperture_arg, thickness + aperture_front_thickness)
    aperture_solid.material = matl.absorber
    aperture_solid.move(*off_axis, 0)

    if sign > 0:
        mirror_surface = Sphere(radius, material=material).move_z(radius)
        aperture_solid.move_z(total_thickness / 2 - thickness)
    else:
        mirror_surface = Sphere(r_abs, material=material).move_z(radius)
        aperture_solid.move_z(thickness - total_thickness / 2)
    return csg.difference(aperture_solid, mirror_surface)


@_mirror
def elliptical_mirror(major_radius: float, minor_radius: float, thickness: float, **kwargs):
    """Elliptical mirror: a reflective prolate-spheroid surface on an
    absorbing aperture solid; rays from one focus reflect through the
    other.  After the mirror rotations the major axis lies along world Z,
    the center at ``(minor_radius, 0, 0)``."""
    off_axis = kwargs.get("off_axis")
    material = kwargs.get("material")
    aperture_arg = kwargs.get("aperture")
    if major_radius < minor_radius:
        raise ValueError("major_radius must be >= minor_radius")

    aperture_thickness = thickness + minor_radius
    aperture_solid = _create_aperture(aperture_arg, aperture_thickness)
    aperture_solid.material = matl.absorber
    aperture_solid.move(*off_axis, 0)
    aperture_solid.move_z(minor_radius / 2 - thickness)

    mirror_surface = Sphere(minor_radius, material=material)
    mirror_surface.scale_y(major_radius / minor_radius)
    mirror_surface.move_z(minor_radius)
    return csg.difference(aperture_solid, mirror_surface)


@_mirror
def parabolic_mirror(focus: float, thickness: float, **kwargs):
    """Parabolic mirror with its focus at the origin."""
    off_axis = kwargs.get("off_axis")
    material = kwargs.get("material")
    aperture_arg = kwargs.get("aperture")

    if hasattr(aperture_arg, "__len__"):
        furthest_point = np.linalg.norm(
            np.abs(np.asarray(off_axis)) + np.asarray(aperture_arg) / 2
        )
    else:
        furthest_point = np.linalg.norm(np.asarray(off_axis)) + aperture_arg

    front_thickness = 1 / (4 * focus) * furthest_point**2
    total_thickness = thickness + front_thickness

    aperture_shape = _create_aperture(aperture_arg, total_thickness).move(*off_axis, 0)
    aperture_shape.material = matl.absorber
    aperture_shape.move_z(total_thickness / 2 - thickness)

    mirror_surface = Paraboloid(focus, height=1.5 * front_thickness, material=material)
    mirror_shape = csg.difference(aperture_shape, mirror_surface)
    mirror_shape.move_z(-focus)
    return mirror_shape


def equilateral_prism(side_length: float, width: float, material: matl.TracableMaterial = None):
    """Equilateral prism: triangular faces parallel to YZ, base parallel to
    XY.  Default material BK7."""
    if material is None:
        material = matl.glass["BK7"]
    cut_length = 1.1 * side_length / np.sin(60 * np.pi / 180)

    prism = csg.difference(
        csg.difference(
            Cuboid.from_sides(side_length, width, side_length, material=material),
            Cuboid.from_sides(cut_length, 1.1 * width, cut_length, material=material)
            .move(-cut_length / 2, 0, cut_length / 2)
            .rotate_y(30)
            .move(-side_length / 2, 0, -side_length / 2),
        ),
        Cuboid.from_sides(cut_length, 1.1 * width, cut_length, material=material)
        .move(cut_length / 2, 0, cut_length / 2)
        .rotate_y(-30)
        .move(side_length / 2, 0, -side_length / 2),
    ).move_z(side_length / 2 * (1 - np.sin(60 * np.pi / 180)))
    return prism


def baffle(aperture: Union[float, Tuple[float, float]]):
    """Planar baffle absorbing all intersecting rays, coplanar to YZ."""
    return XYPlane(aperture[0], aperture[1], material=matl.absorber).rotate_y(90)


def aperture(
    size: Union[float, Tuple[float, float]],
    aperture_size: Union[float, Tuple[float, float]],
):
    """Planar baffle with a central transmitting opening."""
    aperture_stop = baffle(size).rotate_y(-90)
    opening = _create_aperture(aperture_size, thickness=0.1)
    return csg.difference(aperture_stop, opening).rotate_y(90).rotate_x(-90)


def microlens_array(
    r: float,
    thickness: float,
    nx: int,
    ny: int,
    pitch: float,
    aperture: float = None,
    material=None,
):
    """``ny x nx`` grid of plano-convex lenslets in the YZ plane, optical
    axes +X, centered on the origin.  Returns the component list, one
    lenslet handle per lenslet in row-major order (scene/lenslets.py): the
    grid is one record, compiled in one batched pass, and a handle builds
    its lenslet's objects on first use other than ``get_id()``.  ``r`` is
    one shared radius or ``ny * nx`` per-lenslet radii in row-major order.
    Arrays past 32 leaves batch as one group of same-shape trees: the
    wide kernel K2 on the card, the plain engine's wide path on the CPU."""
    if material is None:
        material = matl.glass["ideal"]
    if aperture is None:
        aperture = pitch

    if np.ndim(r) > 0 and len(r) != ny * nx:
        raise ValueError(f"per-lenslet radii: expected {ny * nx} values, got {len(r)}")
    return LensletGrid(r, thickness, nx, ny, pitch, aperture, material, _plano_convex).lenslets()


# ---------------------------------------------------------------------------
# Sources
# ---------------------------------------------------------------------------


class Source(WorldObject, abc.ABC):
    def __init__(self, wavelength=0.633, *args, **kwargs):
        """Base class for all sources (wavelength in microns)."""
        super().__init__(*args, **kwargs)
        self._wavelength = wavelength

    def generate_rays(self, n_rays: int, device=None, dtype: torch.dtype = torch.float32) -> RaySet:
        """Generate ``n_rays`` as ``dtype`` tensors on ``device`` (the CUDA
        card when None; pass ``device="cpu"`` for the CPU),
        world-transformed with renormalized directions."""
        device = default_device(device)
        ray_set = self._local_ray_generation(n_rays, device, dtype)
        tx = torch.as_tensor(self._world_coordinate_transform, dtype=dtype, device=device)
        positions = transform_rays(tx, ray_set.positions)
        directions = transform_rays(tx, ray_set.directions)
        directions = directions / torch.linalg.norm(directions, dim=0)
        return ray_set.replace(positions=positions, directions=directions)

    @abc.abstractmethod
    def _local_ray_generation(self, n_rays: int, device, dtype) -> RaySet:
        ...

    def _fresh(self, n_rays, device, dtype) -> RaySet:
        return RaySet.create(n_rays, wavelength=self._wavelength, device=device, dtype=dtype)

    @property
    def wavelength(self):
        return self._wavelength

    @wavelength.setter
    def wavelength(self, value):
        self._wavelength = value


class LineOfRays(Source):
    def __init__(self, spacing=1, wavelength=0.633, *args, **kwargs):
        """n rays linearly spaced over ``spacing`` along local Y, all
        pointing +X."""
        super().__init__(wavelength, *args, **kwargs)
        self._spacing = spacing

    def _local_ray_generation(self, n_rays, device, dtype) -> RaySet:
        rayset = self._fresh(n_rays, device, dtype)
        if n_rays > 1:
            rayset.positions[1] = torch.linspace(
                -self._spacing / 2, self._spacing / 2, n_rays, dtype=dtype, device=device
            )
        rayset.directions[0] = 1.0
        return rayset


class GridOfRays(Source):
    def __init__(self, width=1, height=1, wavelength=0.633, *args, **kwargs):
        """Parallel +X rays on a near-square grid spanning ``width`` (Y) x
        ``height`` (Z), filled row-major (``n_rays`` need not be a square)."""
        super().__init__(wavelength, *args, **kwargs)
        self._width = width
        self._height = height

    def _local_ray_generation(self, n_rays, device, dtype) -> RaySet:
        rayset = self._fresh(n_rays, device, dtype)
        k = int(np.ceil(np.sqrt(n_rays)))
        rows = int(np.ceil(n_rays / k))
        i = torch.arange(n_rays, device=device)
        iy = (i // k).to(dtype)
        iz = (i % k).to(dtype)
        rayset.positions[1] = (iy / max(rows - 1, 1) - 0.5) * self._width
        rayset.positions[2] = (iz / max(k - 1, 1) - 0.5) * self._height
        rayset.directions[0] = 1.0
        return rayset


class CircleOfRays(Source):
    def __init__(self, diameter=1, wavelength=0.633, *args, **kwargs):
        """Parallel +X rays uniformly placed on a circle in YZ."""
        super().__init__(wavelength, *args, **kwargs)
        self._diameter = diameter

    def _local_ray_generation(self, n_rays, device, dtype) -> RaySet:
        rayset = self._fresh(n_rays, device, dtype)
        theta = torch.linspace(0, 2 * math.pi, n_rays, dtype=dtype, device=device)
        rayset.positions[1] = self._diameter / 2 * torch.sin(theta)
        rayset.positions[2] = self._diameter / 2 * torch.cos(theta)
        rayset.directions[0] = 1.0
        return rayset


class ConeOfRays(Source):
    def __init__(self, cone_angle: float, wavelength=0.633, *args, **kwargs):
        """Point source emitting a cone of rays at a fixed polar angle about +X."""
        super().__init__(wavelength, *args, **kwargs)
        self._angle = cone_angle * np.pi / 180.0

    def _local_ray_generation(self, n_rays, device, dtype) -> RaySet:
        rayset = self._fresh(n_rays, device, dtype)
        if n_rays > 1:
            angles = 2 * math.pi * torch.arange(n_rays, dtype=dtype, device=device) / n_rays
            rayset.directions[1] = math.sin(self._angle) * torch.sin(angles)
            rayset.directions[2] = math.sin(self._angle) * torch.cos(angles)
        rayset.directions[0] = math.cos(self._angle)
        return rayset


class WedgeOfRays(Source):
    def __init__(self, angle: float, wavelength=0.633, *args, **kwargs):
        """Point source fanning rays in the XY plane over [-angle/2, angle/2]."""
        super().__init__(wavelength, *args, **kwargs)
        self._angle = angle * np.pi / 180.0

    def _local_ray_generation(self, n_rays, device, dtype) -> RaySet:
        rayset = self._fresh(n_rays, device, dtype)
        angles = torch.linspace(
            -self._angle / 2, self._angle / 2, n_rays, dtype=dtype, device=device
        )
        rayset.directions[0] = torch.cos(angles)
        rayset.directions[1] = torch.sin(angles)
        return rayset


class Lamp(Source):
    def __init__(
        self, width: float, length: float, max_angle: float = 90, seed=None, *args, **kwargs
    ) -> None:
        """Lambertian area source: random positions on a width x length
        rectangle, directions inverse-CDF sampled on the sphere cap,
        intensity = 100 cos(theta).  Draws from a ``torch.Generator`` seeded
        with ``seed`` (a random seed when None)."""
        super().__init__(*args, **kwargs)
        self._max_angle = max_angle * np.pi / 180
        self._width = width
        self._length = length
        if seed is None:
            seed = np.random.randint(0, 2**31 - 1)
        self._generator = torch.Generator().manual_seed(int(seed))

    @property
    def rng_state(self) -> torch.Tensor:
        """The generator's state; set it back to replay later draws."""
        return self._generator.get_state()

    @rng_state.setter
    def rng_state(self, state):
        self._generator.set_state(state)

    def _local_ray_generation(self, n_rays, device, dtype) -> RaySet:
        rayset = self._fresh(n_rays, device, dtype)
        # drawn in float64 on the CPU generator, then moved: the same seed
        # gives the same rays on every device and dtype
        uv = torch.rand((4, n_rays), generator=self._generator, dtype=torch.float64)
        theta = torch.arccos(1 - uv[0] * (1 - math.cos(self._max_angle)))
        phi = uv[1] * 2 * math.pi

        def put(x):
            return x.to(device=device, dtype=dtype)

        rayset.positions[1] = put(self._width * (uv[2] - 0.5))
        rayset.positions[2] = put(self._length * (uv[3] - 0.5))
        rayset.directions[0] = put(torch.cos(theta))
        rayset.directions[1] = put(torch.sin(theta) * torch.cos(phi))
        rayset.directions[2] = put(torch.sin(theta) * torch.sin(phi))
        rayset.intensity = put(100.0 * torch.cos(theta))
        return rayset


class StaticLamp(Lamp):
    """A Lamp whose generated rays are cached per ``(n_rays, device, dtype)``
    so repeated simulations see identical Monte-Carlo noise."""

    @lru_cache(10)
    def generate_rays(self, n_rays: int, device=None, dtype: torch.dtype = torch.float32):
        return super().generate_rays(n_rays, device, dtype)

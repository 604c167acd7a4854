"""Ray storage (counterpart of ``pyrayt_tpu.tracer.rayset``).

A plain dataclass of tensors with the ray axis last.  ``positions`` and
``directions`` are ``(4, n)`` homogeneous coordinates (w = 1 / 0); the
metadata fields are ``(n,)``.  Defaults: wavelength 0.633 um, index 1,
intensity 100, ids = arange.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from pyrayt_tpu_torch.config import default_device

__all__ = ["RaySet", "concatenate", "METADATA_FIELDS"]

METADATA_FIELDS = ("generation", "intensity", "wavelength", "index", "id")
_FIELDS = ("positions", "directions") + METADATA_FIELDS


@dataclasses.dataclass
class RaySet:
    """A bundle of rays: homogeneous positions/directions plus metadata."""

    positions: torch.Tensor  # (4, n)
    directions: torch.Tensor  # (4, n)
    generation: torch.Tensor  # (n,)
    intensity: torch.Tensor  # (n,)
    wavelength: torch.Tensor  # (n,)
    index: torch.Tensor  # (n,)
    id: torch.Tensor  # (n,)

    fields = METADATA_FIELDS

    @classmethod
    def create(
        cls,
        n_rays: int,
        wavelength=0.633,
        intensity=100.0,
        index=1.0,
        device=None,
        dtype: torch.dtype = torch.float32,
    ):
        """A fresh set at the origin with the default metadata, on
        ``device`` (None: the CUDA device, ``config.default_device``)."""
        kw = dict(dtype=dtype, device=default_device(device))
        positions = torch.zeros((4, n_rays), **kw)
        positions[3] = 1.0
        return cls(
            positions=positions,
            directions=torch.zeros((4, n_rays), **kw),
            generation=torch.zeros(n_rays, **kw),
            intensity=torch.full((n_rays,), float(intensity), **kw),
            wavelength=torch.full((n_rays,), float(wavelength), **kw),
            index=torch.full((n_rays,), float(index), **kw),
            id=torch.arange(n_rays, **kw),
        )

    def replace(self, **changes) -> "RaySet":
        return dataclasses.replace(self, **changes)

    @property
    def n_rays(self) -> int:
        return self.positions.shape[-1]

    @property
    def dtype(self) -> torch.dtype:
        return self.positions.dtype

    @property
    def device(self) -> torch.device:
        return self.positions.device

    @property
    def rays(self) -> torch.Tensor:
        """(2, 4, n) stacked view."""
        return torch.stack((self.positions, self.directions))

    @property
    def metadata(self) -> torch.Tensor:
        """(5, n) metadata block in field order."""
        return torch.stack(
            (self.generation, self.intensity, self.wavelength, self.index, self.id)
        )

    def with_rays(self, rays) -> "RaySet":
        return self.replace(positions=rays[0], directions=rays[1])

    def to(self, device=None, dtype=None) -> "RaySet":
        return RaySet(**{f: getattr(self, f).to(device=device, dtype=dtype) for f in _FIELDS})

    def to_numpy(self) -> np.ndarray:
        """(13, n) packed array in the reference RaySet layout."""
        return torch.cat((self.positions, self.directions, self.metadata)).cpu().numpy()


def concatenate(ray_sets) -> RaySet:
    """Concatenate ray sets along the ray axis."""
    ray_sets = list(ray_sets)
    return RaySet(
        **{name: torch.cat([getattr(r, name) for r in ray_sets], dim=-1) for name in _FIELDS}
    )

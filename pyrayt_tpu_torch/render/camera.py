"""Orthographic viewport camera (counterpart of
``pyrayt_tpu.render.camera``).

A camera looking along its local +x axis, its pixel grid spanning
``h_width x (aspect_ratio * h_width)`` in the local yz plane.  The pixel
rays are made on the host in float64 and handed to the device as one
``(2, 4, n)`` bundle for the batched nearest-hit pass.
"""

from __future__ import annotations

import numpy as np
import torch

from pyrayt_tpu_torch.config import default_device
from pyrayt_tpu_torch.scene._backend import host
from pyrayt_tpu_torch.scene.objects import WorldObject

__all__ = ["OrthographicCamera"]


class OrthographicCamera(WorldObject):
    def __init__(self, h_pixel_count: int, h_width: float, aspect_ratio: float, *args,
                 **kwargs) -> None:
        super().__init__(*args, **kwargs)
        self._h_pixels = int(h_pixel_count)
        self._h_width = float(h_width)
        self._v_width = float(aspect_ratio) * float(h_width)
        self._v_pixels = int(aspect_ratio * self._h_pixels)

    def get_resolution(self):
        return (self._h_pixels, self._v_pixels)

    def get_span(self):
        return (self._h_width, self._v_width)

    def generate_rays(self, device=None, dtype: torch.dtype = torch.float32) -> torch.Tensor:
        """(2, 4, h*v) world-space pixel rays with unit directions, on
        ``device`` (None: the CUDA card)."""
        device = default_device(device)
        world = host(self._world_coordinate_transform)
        rays = np.einsum("ij,rjn->rin", world, self._local_ray_generation())
        directions = rays[1] / np.linalg.norm(rays[1], axis=0)
        return torch.as_tensor(np.stack((rays[0], directions)), dtype=dtype, device=device)

    def _local_ray_generation(self) -> np.ndarray:
        h_steps = np.linspace(self._h_width / 2, -self._h_width / 2, self._h_pixels)
        v_steps = np.linspace(self._v_width / 2, -self._v_width / 2, self._v_pixels)
        ys, zs = np.meshgrid(h_steps, v_steps)
        n = self._h_pixels * self._v_pixels
        positions = np.zeros((4, n))
        positions[1] = ys.reshape(-1)
        positions[2] = zs.reshape(-1)
        positions[3] = 1.0
        directions = np.zeros((4, n))
        directions[0] = 1.0
        return np.stack((positions, directions))

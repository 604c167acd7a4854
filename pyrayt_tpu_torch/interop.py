"""NumPy-in constructors for scene params and ray sets.

The same scene and rays, made once with NumPy, can feed this package and
any other engine that reads the same layout: ``world`` (S, 4, 4), ``prim``
(S, 6), ``glass`` (M, 7); positions/directions (4, n) homogeneous and
metadata (5, n) in the order generation, intensity, wavelength, index, id.
``device=None`` means the CUDA device (``config.default_device``); pass
``device="cpu"`` for the CPU.
"""

from __future__ import annotations

import numpy as np
import torch

from pyrayt_tpu_torch.config import default_device
from pyrayt_tpu_torch.tracer.rayset import RaySet

__all__ = ["params_from_numpy", "rays_from_numpy"]


def params_from_numpy(params, device=None, dtype: torch.dtype = torch.float32):
    """``{"world", "prim", "glass"}`` NumPy arrays -> dict of tensors."""
    device = default_device(device)
    return {
        name: torch.as_tensor(np.asarray(params[name]), dtype=dtype, device=device)
        for name in ("world", "prim", "glass")
    }


def rays_from_numpy(
    positions, directions, metadata, device=None, dtype: torch.dtype = torch.float32
) -> RaySet:
    """(4, n) positions, (4, n) directions and (5, n) metadata -> RaySet."""
    device = default_device(device)

    def t(x):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)

    metadata = t(metadata)
    if metadata.shape[0] != 5:
        raise ValueError(f"metadata must be (5, n), got {tuple(metadata.shape)}")
    return RaySet(
        positions=t(positions),
        directions=t(directions),
        generation=metadata[0].clone(),
        intensity=metadata[1].clone(),
        wavelength=metadata[2].clone(),
        index=metadata[3].clone(),
        id=metadata[4].clone(),
    )

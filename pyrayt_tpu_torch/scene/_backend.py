"""NumPy/torch dispatch for the scene builders.

Builders do tiny 4x4 transform math.  A scene built from plain numbers
runs it on NumPy, which is fast and keeps every parameter a host value.  A
value that is a torch tensor requiring grad is "traced": the builders then
switch to torch ops on that tensor's dtype and device, so a scene rebuilt
from such values carries the gradient into the trace (the differentiable
lens-design path, ``analysis.optimize.build_objective``).  A tensor that
does not require grad is read as a plain value.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["is_traced", "xp_for", "plain", "as_tensor_like", "first_tensor", "host"]

_NUMBERS = (float, int)  # the builders' usual arguments: a fast path


def is_traced(*values) -> bool:
    """True if any value (or element of a tuple/list) is a torch tensor
    that requires grad."""
    for v in values:
        if type(v) in _NUMBERS:
            continue
        if isinstance(v, torch.Tensor) and v.requires_grad:
            return True
        if isinstance(v, (tuple, list)) and is_traced(*v):
            return True
    return False


def xp_for(*values):
    """The array namespace for ``values``: ``torch`` when any is traced,
    else ``numpy``."""
    return torch if is_traced(*values) else np


def plain(value):
    """A value as the NumPy path reads it: tensors that do not require
    grad become floats / arrays; everything else is returned as is."""
    if type(value) in _NUMBERS:
        return value
    if isinstance(value, torch.Tensor) and not value.requires_grad:
        value = value.detach().cpu().numpy()
        return float(value) if value.ndim == 0 else value
    if isinstance(value, (tuple, list)):
        return type(value)(plain(v) for v in value)
    return value


def first_tensor(*values):
    """The first torch tensor among ``values`` (searching tuples/lists)."""
    for v in values:
        if isinstance(v, torch.Tensor):
            return v
        if isinstance(v, (tuple, list)):
            t = first_tensor(*v)
            if t is not None:
                return t
    return None


def as_tensor_like(value, ref: torch.Tensor) -> torch.Tensor:
    """``value`` (number, array, tensor or a sequence mixing them) as a
    tensor of ``ref``'s floating dtype on ``ref``'s device; tensors keep
    their graph."""
    dtype = ref.dtype if ref.is_floating_point() else torch.float64
    if isinstance(value, torch.Tensor):
        return value.to(dtype=dtype, device=ref.device)
    if isinstance(value, (tuple, list)) and any(isinstance(v, torch.Tensor) for v in value):
        return torch.stack([as_tensor_like(v, ref).reshape(()) for v in value])
    return torch.as_tensor(np.asarray(value, dtype=float), dtype=dtype, device=ref.device)


def host(value) -> np.ndarray:
    """A detached float64 NumPy copy (tensors leave their graph and device)."""
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().to(torch.float64).numpy()
    if isinstance(value, (tuple, list)):
        return np.asarray([host(v) for v in value], dtype=float)
    return np.asarray(value, dtype=float)

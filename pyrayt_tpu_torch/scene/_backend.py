"""Array namespace for the scene builders.

Builders do tiny 4x4 transform math on NumPy.  A value that is a torch
tensor requiring grad is "traced": a scene rebuilt from such values would
carry gradients into the trace, which is the gradient slice's work
(ROADMAP.md).  Until then the builders refuse traced values instead of
silently detaching them.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["is_traced", "xp_for"]


def is_traced(*values) -> bool:
    """True if any value (or element of a tuple/list) is a torch tensor
    that requires grad."""
    for v in values:
        if isinstance(v, torch.Tensor) and v.requires_grad:
            return True
        if isinstance(v, (tuple, list)) and is_traced(*v):
            return True
    return False


def xp_for(*values):
    """The array namespace for ``values``: NumPy, or an error for traced
    values (differentiable scene rebuilds arrive with the gradient slice)."""
    if is_traced(*values):
        raise NotImplementedError(
            "scene builders take plain numbers here; rebuilding a scene from "
            "tensors that require grad arrives with the gradient slice "
            "(ROADMAP.md, modules to port: metrics, then the narrow backward)"
        )
    return np

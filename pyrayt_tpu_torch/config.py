"""Trace configuration (counterpart of ``pyrayt_tpu.config``).

One frozen, hashable dataclass threaded through the engines; the fields
are those of the JAX package.  ``default_device`` is the port's device
rule for its entry points: the CUDA card unless the caller names a device.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

__all__ = ["TraceConfig", "default_device"]


def default_device(device=None) -> torch.device:
    """``device`` as a torch.device; None means the CUDA card.  Raises
    when the card is meant but absent: the port never falls back to the
    CPU unless the caller asks for it with ``device="cpu"``."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "pyrayt_tpu_torch runs on the CUDA device by default and none is available; "
            'pass device="cpu" to run the plain engine on the CPU'
        )
    return torch.device("cuda")


@dataclasses.dataclass(frozen=True)
class TraceConfig:
    #: maximum bounce count before a ray is terminated
    generation_limit: int = 10
    #: epsilon push-off from the intersected surface
    ray_offset: float = 1e-6
    #: intensity kill threshold
    intensity_threshold: float = 0.1
    #: the reference's threshold test is inert; False reproduces shipped
    #: behavior, True implements the intended one
    apply_intensity_threshold: bool = False
    #: refractive index of the world / surrounding medium
    world_index: float = 1.0
    #: True -> the plain engine runs every generation (no early exit);
    #: False -> it stops once every ray is dead
    fixed_loop: bool = False
    #: CUDA kernel dispatch in trace_rays(): None = the kernel on CUDA
    #: tensors when the scene supports it, the plain engine otherwise;
    #: True = the kernel or raise (also for CPU tensors); False = always
    #: the plain engine
    use_fused: Optional[bool] = None
    #: plain engine under autograd: recompute each generation step in the
    #: backward pass (torch.utils.checkpoint) instead of saving it
    remat: bool = False
    #: wide-scene backward selection; accepted for the JAX package's
    #: signature and used by the wide slice
    wide_grad: Optional[str] = None

"""Debug and sanitizer switches (counterpart of ``pyrayt_tpu.debug``).

Context managers that restore the previous state on exit:

* :func:`debug_nans` raises ``FloatingPointError`` at the first PyTorch
  operation whose floating-point result holds a NaN (infinities are legal:
  a miss is ``+inf``), and turns on autograd's anomaly detection, which
  names the backward function that first returns a NaN;
* :func:`eager_mode` is kept for the JAX package's API: PyTorch already
  runs op by op, so there is no compilation to turn off (the CUDA kernels
  are turned off per trace with ``TraceConfig(use_fused=False)``);
* :func:`sanitize` is both.

    with pyrayt_tpu_torch.debug.sanitize():
        tracer.trace()

The NaN check sees the results of PyTorch operations, so a NaN written by
a CUDA kernel is caught at the first operation that reads it.  Every check
synchronizes with the device: a debugging aid, not for production runs.
"""

from __future__ import annotations

import contextlib

import torch
from torch.overrides import TorchFunctionMode

__all__ = ["debug_nans", "eager_mode", "sanitize"]

# factories whose results hold whatever the memory held before
_UNINITIALIZED = ("empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided")


def _first_nan(value):
    """Whether ``value`` (a tensor or a tuple or list of them) holds a NaN."""
    if isinstance(value, torch.Tensor):
        return value.is_floating_point() and bool(torch.isnan(value.detach()).any())
    if isinstance(value, (tuple, list)):
        return any(_first_nan(v) for v in value)
    return False


class _NanCheck(TorchFunctionMode):
    """Raises FloatingPointError when an operation returns a NaN."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = getattr(func, "__name__", str(func))
        if name not in _UNINITIALIZED and _first_nan(out):
            raise FloatingPointError(f"{name} produced a NaN")
        return out


@contextlib.contextmanager
def debug_nans(enable: bool = True):
    """Raise FloatingPointError at the first NaN a PyTorch operation
    produces, and detect NaNs in the backward pass (autograd's anomaly
    mode)."""
    if not enable:
        yield
        return
    with torch.autograd.set_detect_anomaly(True, check_nan=True), _NanCheck():
        yield


@contextlib.contextmanager
def eager_mode(enable: bool = True):
    """PyTorch runs op by op already; kept so that code written for the
    JAX package's ``eager_mode`` runs unchanged."""
    yield


@contextlib.contextmanager
def sanitize():
    """NaN checking and eager execution together."""
    with debug_nans(), eager_mode():
        yield

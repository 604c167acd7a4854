"""Spans of the port's layers, on the clock of ``torch.profiler``.

``span(name)`` opens ``record_function("pyrayt." + name)`` while a
profiler records (``torch.profiler.profile``, or
``torch.autograd.profiler.emit_nvtx`` for Nsight), and is one flag read
and a shared no-op object otherwise.  The profiler keeps each span's name,
start and end on the clock it shares with the device's activities, nests
them by time, and exports them with the rest of its trace
(``export_chrome_trace``).  The span names and what each covers are listed
in README.md, "Tracing".

Open spans with ``with tracing.span(...)`` inside a function's body: a
decorator would rebind the wrappers whose ``.launches`` counters callers
read.
"""

from __future__ import annotations

import contextlib

import torch

__all__ = ["span"]

_recording = torch._C._autograd._profiler_enabled
_OFF = contextlib.nullcontext()  # reentrant: one object serves every span


def span(name: str):
    """A ``pyrayt.<name>`` span around a ``with`` block while a profiler
    records; the same no-op object otherwise."""
    if _recording():
        return torch.profiler.record_function("pyrayt." + name)
    return _OFF

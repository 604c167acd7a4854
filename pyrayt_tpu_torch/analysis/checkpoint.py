"""Checkpoint / resume for optimization loops.

Counterpart of ``pyrayt_tpu.analysis.checkpoint``.  Optimization state is
tiny (parameters, optimizer and scheduler state, step, loss history), so a
checkpoint is one ``torch.save`` file written atomically: to a temp file in
the same directory, then ``os.replace``.  Reads use
``torch.load(weights_only=True)``, which loads tensors and plain
containers and runs no code from the file.
"""

from __future__ import annotations

import os
import tempfile

import torch

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step"]


def _to_cpu(state):
    if isinstance(state, torch.Tensor):
        return state.detach().cpu()
    if isinstance(state, dict):
        return {k: _to_cpu(v) for k, v in state.items()}
    if isinstance(state, (list, tuple)):
        return type(state)(_to_cpu(v) for v in state)
    return state


def save_checkpoint(path: str, state) -> None:
    """Write ``state`` (tensors, numbers and dict / list / tuple containers
    of them) to ``path`` atomically: a killed process never leaves a torn
    checkpoint.  Tensors are stored on the CPU."""
    directory = os.path.dirname(os.path.abspath(path))
    os.makedirs(directory, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=directory, suffix=".ckpt.tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            torch.save(_to_cpu(state), f)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def restore_checkpoint(path: str):
    """The state saved by :func:`save_checkpoint` at ``path``, or None when
    the file does not exist."""
    if not os.path.exists(path):
        return None
    return torch.load(path, weights_only=True)


def latest_step(path: str) -> int:
    """The ``step`` field of a checkpoint file, or -1 when absent."""
    state = restore_checkpoint(path)
    if state is None or "step" not in state:
        return -1
    return int(state["step"])

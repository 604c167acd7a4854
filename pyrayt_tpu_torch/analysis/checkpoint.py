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


def _place_like(state, like):
    """``state`` with each tensor that sits where ``like`` (the same
    structure, by key and index) has a tensor moved to that tensor's device
    and dtype."""
    if isinstance(state, torch.Tensor) and isinstance(like, torch.Tensor):
        return state.to(device=like.device, dtype=like.dtype)
    if isinstance(state, dict) and isinstance(like, dict):
        return {k: _place_like(v, like[k]) if k in like else v for k, v in state.items()}
    if isinstance(state, (list, tuple)) and isinstance(like, (list, tuple)):
        return type(state)(_place_like(v, like[i]) if i < len(like) else v
                           for i, v in enumerate(state))
    return state


def restore_checkpoint(path: str, like=None):
    """The state saved by :func:`save_checkpoint` at ``path``, or None when
    the file does not exist.  With ``like`` (a template of the same
    structure, as the JAX package's restore takes), each restored tensor
    where ``like`` has a tensor takes that tensor's device and dtype;
    without it, tensors stay on the CPU as saved."""
    if not os.path.exists(path):
        return None
    state = torch.load(path, weights_only=True)
    return state if like is None else _place_like(state, like)


def latest_step(path: str) -> int:
    """The ``step`` field of a checkpoint file, or -1 when absent."""
    state = restore_checkpoint(path)
    if state is None or "step" not in state:
        return -1
    return int(state["step"])

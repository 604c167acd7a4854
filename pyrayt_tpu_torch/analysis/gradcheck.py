"""Finite-difference gradient validation.

Counterpart of ``pyrayt_tpu.analysis.gradcheck``: compares the autograd
gradient of any scalar loss over a parameter tensor, or a dict / list /
tuple of tensors, against central finite differences, entry by entry.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

__all__ = ["finite_difference_grad", "check_gradients"]


def _flatten(params):
    """(leaves, rebuild) of a tensor or a dict / list / tuple of tensors."""
    if isinstance(params, dict):
        keys = list(params)
        return [params[k] for k in keys], lambda leaves: dict(zip(keys, leaves))
    if isinstance(params, (list, tuple)):
        kind = type(params)
        return list(params), lambda leaves: kind(leaves)
    return [params], lambda leaves: leaves[0]


def finite_difference_grad(fn: Callable, params, eps: float = 1e-5):
    """Central-difference gradient of scalar ``fn`` over ``params``, in
    float64 and with ``params``' structure.  O(2 * n_params) evaluations:
    meant for the tens of geometry / dispersion parameters of an optical
    system, not for large arrays."""
    leaves, rebuild = _flatten(params)
    flat = [torch.as_tensor(leaf).detach().to(torch.float64) for leaf in leaves]

    def eval_at(values):
        with torch.no_grad():
            return float(fn(rebuild(values)))

    grads = []
    for i, leaf in enumerate(flat):
        g = torch.zeros_like(leaf)
        for idx in np.ndindex(*leaf.shape):
            bumped = [v.clone() for v in flat]
            bumped[i][idx] += eps
            f_plus = eval_at(bumped)
            bumped[i][idx] -= 2 * eps
            f_minus = eval_at(bumped)
            g[idx] = (f_plus - f_minus) / (2 * eps)
        grads.append(g)
    return rebuild(grads)


def check_gradients(fn: Callable, params, eps: float = 1e-5, rtol: float = 1e-3,
                    atol: float = 1e-6):
    """Compare the autograd gradient of ``fn`` against finite differences.

    Returns ``(max_abs_err, max_rel_err)``; raises AssertionError with a
    per-leaf report when outside tolerance."""
    leaves, rebuild = _flatten(params)
    inputs = [torch.as_tensor(leaf).detach().clone().requires_grad_(True) for leaf in leaves]
    analytic = torch.autograd.grad(fn(rebuild(inputs)), inputs, allow_unused=True)
    numeric, _ = _flatten(finite_difference_grad(fn, params, eps=eps))

    max_abs = 0.0
    max_rel = 0.0
    failures = []
    for i, (a, n) in enumerate(zip(analytic, numeric)):
        a = np.zeros(tuple(inputs[i].shape)) if a is None else a.detach().cpu().double().numpy()
        n = n.cpu().numpy()
        if not np.all(np.isfinite(a)):
            failures.append(f"leaf {i}: analytic gradient is non-finite: {a}")
            continue
        if not np.all(np.isfinite(n)):
            failures.append(f"leaf {i}: FD gradient is non-finite: {n}")
            continue
        abs_err = np.abs(a - n)
        rel_err = abs_err / np.maximum(np.abs(n), atol / rtol)
        max_abs = max(max_abs, float(abs_err.max(initial=0.0)))
        max_rel = max(max_rel, float(rel_err.max(initial=0.0)))
        bad = abs_err > atol + rtol * np.abs(n)
        if np.any(bad):
            failures.append(
                f"leaf {i}: {int(bad.sum())}/{bad.size} entries outside "
                f"tolerance (max abs {abs_err.max():.3e}, "
                f"analytic {a.ravel()[np.argmax(abs_err)]:.6e} vs "
                f"numeric {n.ravel()[np.argmax(abs_err)]:.6e})"
            )
    if failures:
        raise AssertionError("gradient check failed:\n" + "\n".join(failures))
    return max_abs, max_rel

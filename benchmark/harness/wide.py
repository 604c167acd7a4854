"""Readers of the wide path's own kernels in a traced run: K2, the staged
backward K5-K7 and its table reduce, found in the device trace by name.

The names are the kernels' own in ``pyrayt_tpu_torch/csrc/``:
``fused_trace_wide_kernel`` (K2), ``staged_tail_kernel`` (K5) with its
``reduce_partials``, ``staged_fold_kernel`` (K6, K7) and the table reduce
of ``row_reduce.cuh``.  A trace with none of them reads None.
"""

from __future__ import annotations

from benchmark.harness.profiling import _short

KERNELS = frozenset({
    "fused_trace_wide_kernel", "staged_tail_kernel", "staged_fold_kernel", "reduce_partials",
    "sort_segments", "scan_rows", "plan_rows", "sum_pieces", "finish_rows"})


def _wide_seconds(ctx):
    trace = ctx.get("trace")
    if trace is None or not trace.calls:
        return None
    seconds = sum(a.end - a.start for a in trace.kernels() if _short(a.name) in KERNELS)
    return seconds if seconds > 0 else None


def wide_ms(ctx):
    """Device ms per step in the wide kernels."""
    seconds = _wide_seconds(ctx)
    return None if seconds is None else 1e3 * seconds / ctx["trace"].calls


def roofline_wide(ctx):
    """The least time of the step's functions over the device time of the
    wide kernels alone (PyTorch's own kernels left out), in %."""
    seconds = _wide_seconds(ctx)
    if seconds is None or ctx.get("bound_ms") is None:
        return None
    return 100.0 * ctx["bound_ms"] * 1e-3 * ctx["trace"].calls / seconds

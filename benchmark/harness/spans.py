"""Readers of the program's own spans.

The program opens ``pyrayt.<name>`` spans (``pyrayt_tpu_torch/tracing.py``)
while the profiler records; they reach ``Trace.host`` of the traced run on
the device trace's clock.  Each reader gives the host ms per step or call
during which some span it includes is open and no span it excludes is:
the union of their intervals, clipped to the profiled window, over
``trace.calls``.  It returns None where no included span falls in the
window, as in a program without the spans.  A name that ends in ``.*``
stands for every span below it (``ops.*``: each wrapper and the host
tables); any other name for that span alone.
"""

from __future__ import annotations

PREFIX = "pyrayt."


def _matches(name, names):
    if not name.startswith(PREFIX):
        return False
    name = name[len(PREFIX):]
    return any(name.startswith(n[:-1]) if n.endswith(".*") else name == n for n in names)


def _clipped(trace, names):
    lo, hi = trace.window
    return [(max(a.start, lo), min(a.end, hi)) for a in trace.host
            if _matches(a.name, names) and a.end > lo and a.start < hi]


def _covered(intervals):
    """Seconds covered by the union of ``intervals``."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e > end:
            total += e - max(s, end)
            end = e
    return total


def host_ms(ctx, include, exclude=()):
    """Host ms per step or call inside a span of ``include`` and outside
    every span of ``exclude``; None where no included span was recorded."""
    trace = ctx.get("trace")
    if trace is None or not trace.calls:
        return None
    inside = _clipped(trace, include)
    if not inside:
        return None
    outside = _clipped(trace, exclude) if exclude else []
    seconds = _covered(inside + outside) - _covered(outside)
    return 1e3 * seconds / trace.calls


def builders_ms(ctx):
    """The caller's build function inside ``build_objective``."""
    return host_ms(ctx, ["objective.build"])


def compile_ms(ctx):
    """``compile_scene``: builder objects to the scene's tables."""
    return host_ms(ctx, ["scene.compile"])


def sources_ms(ctx):
    """The sources' rays of a ``trace()`` or ``trace_device()`` call."""
    return host_ms(ctx, ["sources"])


def wrapper_ms(ctx):
    """The kernels' wrappers and their host tables."""
    return host_ms(ctx, ["ops.*"])


def autograd_ms(ctx):
    """``loss.backward()`` outside the backward kernels' wrappers."""
    return host_ms(ctx, ["optimize.backward"], ["ops.*"])


def update_ms(ctx):
    """The optimizer's step and the scheduler's."""
    return host_ms(ctx, ["optimize.update"])


def wait_ms(ctx):
    """The loss's read-back, where the host waits for the card."""
    return host_ms(ctx, ["optimize.readback"])


def frame_ms(ctx):
    """The results frame built on the host, outside the copies."""
    return host_ms(ctx, ["frame"], ["frame.copy"])

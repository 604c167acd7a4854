"""Readers the per-layer metrics share.  Each takes the traced run's
context (``trace``: a ``profiling.Trace`` of the profiled window;
``bound_ms``: the least time of one step's or call's functions; ``build_ms``)
and returns a number, or None where it finds nothing to read."""

from __future__ import annotations


def build_ms(ctx):
    return ctx.get("build_ms")


def launches(ctx):
    """Device kernels launched per step or call."""
    trace = ctx.get("trace")
    if trace is None or not trace.calls:
        return None
    return len(trace.kernels()) / trace.calls


def roofline(ctx):
    """The least time of the step's functions over the device time of all
    its kernels, in %."""
    trace = ctx.get("trace")
    if trace is None or ctx.get("bound_ms") is None:
        return None
    kernel_s = sum(a.end - a.start for a in trace.kernels())
    if kernel_s <= 0:
        return None
    return 100.0 * ctx["bound_ms"] * 1e-3 * trace.calls / kernel_s


def device_idle(ctx):
    """Share of the profiled window with no kernel, copy or fill running."""
    trace = ctx.get("trace")
    if trace is None or trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s() / trace.window_s)


def dtoh_ms(ctx):
    """Device ms of device-to-host copies per call."""
    trace = ctx.get("trace")
    if trace is None:
        return None
    copies = [a for a in trace.device if a.kind == "copy" and "dtoh" in a.name.lower()]
    if not copies:
        return None
    return 1e3 * sum(a.end - a.start for a in copies) / trace.calls

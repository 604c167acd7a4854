"""A short steady window under ``torch.profiler``, reduced to what the
per-layer readers need.

The window runs inside one ``record_function`` span of the benchmark's
own; from the profiler's raw activities it keeps the device intervals
(kernels, copies, fills) that fall inside that span and the host-side ops
and spans, in one clock.  A session that records no kernel is run again,
up to ``SESSIONS`` in all, then this raises: the profiler has been seen to
record nothing in a long process and once early in one, and a per-layer
number is never read from an empty trace.
"""

from __future__ import annotations

import bisect
import dataclasses
from typing import Callable, List, Tuple

import torch

SESSIONS = 3
WINDOW_SPAN = "bench.window"


@dataclasses.dataclass
class Activity:
    name: str
    start: float  # seconds, profiler clock
    end: float
    kind: str  # "kernel", "copy", "fill" on the device; "host" on the host


@dataclasses.dataclass
class Trace:
    calls: int  # steps or calls the window ran
    window: Tuple[float, float]
    device: List[Activity]
    host: List[Activity]
    spans: List[Activity]  # the benchmark's own spans (``bench.*``)

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def kernels(self):
        return [a for a in self.device if a.kind == "kernel"]

    def busy_s(self) -> float:
        """Seconds in which some device activity ran (their union)."""
        return sum(e - s for s, e in _union(self.device))

    def gaps(self) -> List[Tuple[float, float]]:
        """The idle intervals of the window, in order."""
        out, cursor = [], self.window[0]
        for s, e in _union(self.device):
            if s > cursor:
                out.append((cursor, s))
            cursor = max(cursor, e)
        if self.window[1] > cursor:
            out.append((cursor, self.window[1]))
        return out


def _union(acts):
    out = []
    for s, e in sorted((a.start, a.end) for a in acts):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _device_kind(name: str, activity: str) -> str:
    text = (activity + " " + name).lower()
    if "memcpy" in text:
        return "copy"
    if "memset" in text:
        return "fill"
    return "kernel"


def _is_annotation(event) -> bool:
    flag = getattr(event, "is_user_annotation", None)
    if callable(flag) and flag():
        return True
    activity = str(getattr(event, "activity_type", lambda: "")())
    return "annotation" in activity.lower() or event.name().startswith("bench.")


def _reduce(prof, calls) -> Trace:
    device, host, spans, window = [], [], [], None
    for ev in prof.profiler.kineto_results.events():
        start = ev.start_ns() * 1e-9
        end = start + ev.duration_ns() * 1e-9
        name = ev.name()
        on_device = ev.device_type() == torch.autograd.DeviceType.CUDA
        if on_device:
            if _is_annotation(ev):
                continue
            activity = str(getattr(ev, "activity_type", lambda: "")())
            device.append(Activity(name, start, end, _device_kind(name, activity)))
        elif name == WINDOW_SPAN:
            window = (start, end)
        elif name.startswith("bench."):
            spans.append(Activity(name, start, end, "host"))
        else:
            host.append(Activity(name, start, end, "host"))
    if window is None:
        raise RuntimeError("the profiler recorded no window span")
    inside = [a for a in device if a.end > window[0] and a.start < window[1]]
    for a in inside:
        a.start, a.end = max(a.start, window[0]), min(a.end, window[1])
    return Trace(calls, window, inside, host, spans)


def profile(run: Callable[[], int]) -> Trace:
    """Run ``run`` (which runs the window's steps or calls, synchronises,
    and returns how many it ran) under the profiler."""
    from torch.profiler import ProfilerActivity, record_function
    from torch.profiler import profile as torch_profile

    for _ in range(SESSIONS):
        torch.cuda.synchronize()
        with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            with record_function(WINDOW_SPAN):
                calls = run()
                torch.cuda.synchronize()
        trace = _reduce(prof, calls)
        if trace.kernels():
            return trace
    raise RuntimeError(f"torch.profiler recorded no device kernel in {SESSIONS} sessions")


def top_device_ops(trace: Trace, limit=10):
    """[[name, seconds]] of the device activities that took most time."""
    by_name = {}
    for a in trace.device:
        by_name[a.name] = by_name.get(a.name, 0.0) + (a.end - a.start)
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])[:limit]
    return [[_short(k), v] for k, v in ranked]


def idle_by_host(trace: Trace, limit=10):
    """[[what the host was doing, seconds]]: each idle gap's seconds given to
    the benchmark span and the innermost host op open at its midpoint, or,
    where the host ran Python between ops, to the op it started next."""
    by_label = {}
    spans = sorted(trace.spans, key=lambda a: a.start)
    host = sorted(trace.host, key=lambda a: a.start)
    span_starts, host_starts = [a.start for a in spans], [a.start for a in host]
    for s, e in trace.gaps():
        mid = (s + e) / 2
        span = _innermost(spans, span_starts, mid)
        op = _innermost(host, host_starts, mid)
        if not op:
            i = bisect.bisect_right(host_starts, mid)
            op = "python before " + _short(host[i].name) if i < len(host) else "python"
        label = " / ".join(x for x in (span, op) if x)
        by_label[label] = by_label.get(label, 0.0) + (e - s)
    ranked = sorted(by_label.items(), key=lambda kv: -kv[1])[:limit]
    return [[k, v] for k, v in ranked]


def _innermost(acts, starts, t, lookback=256):
    """The latest-started activity open at ``t`` (``acts`` sorted by start)."""
    i = bisect.bisect_right(starts, t)
    for a in reversed(acts[max(0, i - lookback):i]):
        if a.end >= t:
            return _short(a.name)
    return ""


def _short(name: str) -> str:
    name = name.replace("(anonymous namespace)::", "").replace("pyrayt::", "")
    return name.removeprefix("void ").split("(", 1)[0].split("<", 1)[0][:72]

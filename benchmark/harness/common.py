"""What every traffic kind shares: the cell's context, the comparison with
its limits, and the result the runner prints."""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import importlib
import sys
from typing import Any, Callable, Dict, List, Optional

import torch

from benchmark.harness import manifest


@dataclasses.dataclass
class Cell:
    """One run of one cell: its entries, numbers and modules."""

    name: str
    cfg: Dict[str, Any]
    traffic: Dict[str, Any]
    limits: Dict[str, float]
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    process_start: float  # time.perf_counter() value of the process's start
    port: Any = None  # configs/<config>_port.py
    ref: Any = None  # configs/<config>_reference.py
    # a broken copy of the timed path for the fault tests: fault(kind, value)
    fault: Optional[Callable] = None

    @classmethod
    def load(cls, name, seed, seconds, trace, device, process_start, traffic=None, fault=None,
             cfg=None):
        entry = manifest.workload(name)
        cfg = cfg or manifest.config_numbers(entry["config"])
        port = importlib.import_module(f"benchmark.configs.{entry['config']}_port")
        ref = importlib.import_module(f"benchmark.configs.{entry['config']}_reference")
        return cls(name, cfg, traffic or manifest.traffic(entry["traffic"]),
                   manifest.limits(name), seed, seconds, trace, torch.device(device),
                   process_start, port, ref, fault)

    def span(self, name):
        """A span of the benchmark's own around a call into one layer, in
        the traced run only (``bench.<name>`` in the profiler's trace)."""
        if not self.trace:
            return contextlib.nullcontext()
        return torch.profiler.record_function(f"bench.{name}")

    def altered(self, kind, value):
        """``value`` as the timed path produced it, or as a planted fault
        breaks it (tests only)."""
        return self.fault(kind, value) if self.fault is not None else value


@dataclasses.dataclass
class Result:
    correct: bool
    attempted: int
    failed: int
    metrics: Dict[str, Dict[str, Any]]
    device: Dict[str, Any]
    checks: List[List[Any]]  # [name, value, limit]
    breakdown: Optional[Dict[str, Any]] = None


def log(*parts):
    """A progress line on standard error."""
    print(*parts, file=sys.stderr, flush=True)


def judge(numbers: Dict[str, float], limits: Dict[str, float]):
    """(all within their limits, [[name, value, limit]])."""
    checks = [[k, v, limits[k]] for k, v in numbers.items()]
    ok = all(v == v and v <= lim for _, v, lim in checks)  # NaN fails
    return ok, checks


def release():
    """Drop the program's cached device memory before the reference runs."""
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def device_info(cell: Cell, peak: int, trace=None) -> Dict[str, Any]:
    if cell.device.type == "cuda":
        info = {"platform": "gpu", "kind": torch.cuda.get_device_name(cell.device),
                "count": 1, "memory_peak_bytes": int(peak)}
    else:  # the tests' CPU runs: never a device number
        info = {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    if trace is not None:
        info["busy_s"] = trace.busy_s()
        info["window_s"] = trace.window_s
    return info


def memory_peak(cell: Cell) -> int:
    if cell.device.type != "cuda":
        return 0
    torch.cuda.synchronize(cell.device)
    return torch.cuda.max_memory_allocated(cell.device)


def trace_context(cell: Cell, trace, records, masks, backward, **extra) -> Dict[str, Any]:
    """What the per-layer readers read in a traced run: the profiled window
    and the least time of one step's or call's functions, from the
    program's own records and masks at the cell's inputs."""
    from benchmark.harness import roofline

    leaves, glass, kinds = cell.ref.scene_counts(cell.cfg)
    ms, by, n_bytes, flops = roofline.step_bound(records, masks, leaves, glass, kinds,
                                                 records.element_size(), backward)
    log(f"least time of one {'step' if backward else 'call'}: {ms:.4f} ms, bound by {by} "
        f"({n_bytes} bytes, {flops} operations)")
    return dict(extra, trace=trace, bound_ms=ms, bound_by=by)


def per_layer(cell: Cell, ctx: Dict[str, Any]) -> Dict[str, Dict[str, Any]]:
    """Every per-layer metric this cell reports, read by its own reader; a
    reader that finds nothing returns None and the metric is left out."""
    out = {}
    for m in manifest.per_layer_metrics(cell.name):
        value = manifest.reader(m["name"])(ctx)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out

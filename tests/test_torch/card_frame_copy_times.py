"""What the results frame's copy to the host costs, by where its host
buffer comes from: the figures of PERF.md for ``tracer/frame.py``.

    python3 tests/test_torch/card_frame_copy_times.py [--calls N] [--seed S] [--out FILE]

The ``mla16.trace`` cell's scene (``benchmark/configs/mla16*``: the 16x16
freeform array detuned from the seed, the detector at focus) and its
2**20 grid rays, float32, traced with ``RayTracer`` three ways, ``N`` calls
each (default 20), in this order:

- ``pageable``: the selection on the card as ``records_to_dataframe`` makes
  it, then ``.cpu()`` of the gathered ``(15, rows)`` tensor, a fresh
  pageable buffer per frame, and each frame dropped;
- ``dropped``: ``trace()``, each frame dropped, so a dropped frame's
  page-locked block goes back to PyTorch's host cache for the next;
- ``kept``: ``trace()``, every frame kept in a list, from an emptied host
  cache, so every frame takes a fresh page-locked block.

Per case: ms per call on the host clock (each call ends in the copy's
wait), median and range; the device ms of the device-to-host copies per
call and their names (``torch.profiler`` over 3 more calls of the case);
and the host allocator's blocks created (``num_host_alloc``) and bytes held
(``allocated_bytes.current``) before and after, from
``torch.cuda.host_memory_stats()``.  Prints one JSON line per case and a
last line with all of them, the frame's rows and bytes and the card's name
and power limit; ``--out`` writes that line to a file too.  Needs one CUDA
device and ``nvcc``.
"""

from __future__ import annotations

import argparse
import gc
import json
import statistics
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parents[1]


def host_stats(torch):
    stats = torch.cuda.host_memory_stats()
    return {"num_host_alloc": stats.get("num_host_alloc"),
            "allocated_bytes": stats.get("allocated_bytes.current")}


def empty_host_cache(torch):
    """Hand the host cache's free page-locked blocks back to CUDA."""
    for release in (getattr(getattr(torch, "accelerator", None), "empty_host_cache", None),
                    getattr(torch._C, "_host_emptyCache", None)):
        if release is not None:
            release()
            return True
    return False


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--calls", type=int, default=20)
    parser.add_argument("--seed", type=int, default=1)
    parser.add_argument("--out", default=None)
    args = parser.parse_args()
    sys.path[:0] = [str(ROOT)]
    import chip_smoke as cs

    import numpy as np
    import pandas as pd
    import torch
    from torch.profiler import ProfilerActivity, profile

    from benchmark.configs import mla16_port as port
    from benchmark.configs import mla16_reference as ref
    from pyrayt_tpu_torch import RayTracer
    from pyrayt_tpu_torch.ops import fused_trace as ft
    from pyrayt_tpu_torch.scene.objects import fresh_ids
    from pyrayt_tpu_torch.tracer.frame import FRAME_COLUMNS, _live_columns, records_to_dataframe

    cfg = json.loads((ROOT / "benchmark/configs/mla16.json").read_text())
    traffic = json.loads((ROOT / "benchmark/traffic/frame2p20.json").read_text())
    ft.build_kernels()
    device = torch.device("cuda", 0)
    theta = ref.theta(cfg, traffic, np.random.default_rng(args.seed))
    with fresh_ids():
        system = port.components(cfg, theta)
    tracer = RayTracer(port.sources(cfg), system, rays_per_source=traffic["rays_per_source"],
                       generation_limit=cfg["generation_limit"], device=device,
                       dtype=getattr(torch, cfg["dtype"]))

    def pageable():
        result = tracer.trace_device()
        columns = _live_columns(result.records, result.record_mask).cpu().numpy()
        return pd.DataFrame(columns.T, columns=list(FRAME_COLUMNS), copy=False)

    kept = []
    cases = {"pageable": lambda: pageable(), "dropped": lambda: tracer.trace(),
             "kept": lambda: kept.append(tracer.trace())}
    for _ in range(2):  # the kernels' build and the first frames
        tracer.trace()
    rows = len(tracer.trace())
    results = {}
    for name, call in cases.items():
        tracer.reset()
        gc.collect()
        torch.cuda.synchronize()
        emptied = empty_host_cache(torch) if name == "kept" else None
        before = host_stats(torch)
        pinned, pageables = records_to_dataframe.pinned, records_to_dataframe.pageable
        ms = []
        for _ in range(args.calls):
            start = time.perf_counter()
            call()
            torch.cuda.synchronize()
            ms.append(1e3 * (time.perf_counter() - start))
        after = host_stats(torch)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                call()
            torch.cuda.synchronize()
        copies = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA and "dtoh" in e.key.lower()]
        results[name] = {
            "ms_per_call": {"median": statistics.median(ms), "min": min(ms), "max": max(ms),
                            "first": ms[0], "all": ms},
            "copy_device_ms": sum(cs.device_us(e) for e in copies) / 3 / 1e3,
            "copy_names": sorted({e.key for e in copies}),
            "host_cache_emptied": emptied,
            "host_before": before, "host_after": after,
            "frames_pinned": records_to_dataframe.pinned - pinned,
            "frames_pageable": records_to_dataframe.pageable - pageables,
        }
        print(json.dumps({name: results[name]}), flush=True)
        kept.clear()
    line = {"rows": rows, "bytes": rows * 4 * len(FRAME_COLUMNS), "seed": args.seed,
            "calls": args.calls, "torch": torch.__version__, "card": cs.card_line(),
            "cases": results}
    print(json.dumps(line), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())

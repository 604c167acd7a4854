"""One run of one cell: check the card, run the cell's traffic kind, check
that no JAX module was loaded, print the comparisons and the result line."""

from __future__ import annotations

import dataclasses
import importlib
import json
import sys

# top-level module names the run may not load (compared whole)
FORBIDDEN = ("jax", "jaxlib", "flax", "pyrayt_tpu")


def forbidden_modules():
    return sorted({name.split(".", 1)[0] for name in sys.modules} & set(FORBIDDEN))


def run_cell(name, seed, seconds, trace, device, process_start, traffic=None, fault=None,
             cfg=None):
    """The cell's result (``common.Result``); in the tests ``traffic`` and
    ``cfg`` replace the traffic mix and the configuration's numbers (smaller
    sizes) and ``fault`` breaks the timed path."""
    from benchmark.harness import common, manifest

    cell = common.Cell.load(name, seed, seconds, trace, device, process_start, traffic, fault,
                            cfg)
    kind = (traffic or manifest.traffic(manifest.workload(name)["traffic"]))["kind"]
    return importlib.import_module(f"benchmark.harness.{kind}").run(cell)


def main(args, process_start) -> int:
    import torch

    from benchmark.harness import manifest

    entry = manifest.workload(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < entry["chips"]:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{args.workload} needs {entry['chips']} CUDA device(s); found {found}",
              file=sys.stderr)
        return 1
    result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), "cuda",
                      process_start)
    loaded = forbidden_modules()
    if loaded:
        print(f"modules of JAX or of the JAX package are loaded: {loaded}", file=sys.stderr)
        return 1
    for name, value, limit in result.checks:
        print(f"check {name} = {value!r} (limit {limit!r})", file=sys.stderr)
    line = {k: v for k, v in dataclasses.asdict(result).items()
            if k != "checks" and not (k == "breakdown" and v is None)}
    line["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in result.checks}
    print(json.dumps(line))
    return 0

"""Readings that set a cell's limits: the program's over many seeds, the
control's and the planted faults' over a few, in one process.

    python3 benchmark/calibrate.py --workload <cell> --seeds 12 --control-seeds 3 --seconds 2

on the card, from the root of a checkout.  For each program seed it runs
the cell as ``run.py`` does (a short window, then the comparison) and
prints the compared numbers; for each control seed it puts the plain
reference computed in bfloat16 (the nearest precision below the
configuration's float32, which the port has no path of its own for) in
the program's place; for the optimize cells it reads the fault "half of
the batch left out" (the float64 reference over the first half of the
rays in the program's place).  Prints one JSON line per reading.  The
benchmark's own runs never run this.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from benchmark.harness import common, frame, optimize, runner  # noqa: E402
from benchmark.reference import solve  # noqa: E402

LOW = torch.bfloat16  # the control's precision


def _cell(name, seed, device, traffic=None, cfg=None):
    return common.Cell.load(name, seed, 0.0, False, device, time.perf_counter(), traffic,
                            cfg=cfg)


def _theta(cell, dtype):
    """The seed's parameters as the program receives them (in its dtype)."""
    drawn = cell.ref.theta(cell.cfg, cell.traffic, np.random.default_rng(cell.seed))
    return {k: torch.as_tensor(v).to(dtype).to(torch.float64) for k, v in drawn.items()}


def control(name, seed, device="cuda", traffic=None, cfg=None):
    """The cell's numbers with the bfloat16 reference in the program's place
    (``traffic`` and ``cfg`` replace the cell's sizes in the tests)."""
    cell = _cell(name, seed, device, traffic, cfg)
    kind = cell.traffic["kind"]
    if kind == "optimize":
        theta = _theta(cell, torch.float32)
        low = optimize.reference_readings(cell, theta, LOW)
        return optimize.numbers(optimize.reference_readings(cell, theta), [low])
    if kind == "frame":
        theta = cell.ref.theta(cell.cfg, cell.traffic, np.random.default_rng(seed))
        low = frame.reference_rows(cell, theta, LOW).astype(np.float32)
        return frame.frame_gaps(low, frame.reference_rows(cell, theta, torch.float64))
    theta = {k: torch.as_tensor(np.asarray(v, dtype=np.float64)) for k, v in
             cell.ref.theta(cell.cfg, cell.traffic, np.random.default_rng(seed)).items()}
    per_source, block = cell.traffic["rays_per_source"], cell.traffic["reference_block"]
    _, radius = solve.spot(cell.ref, cell.cfg, theta,
                              cell.ref.rays(cell.cfg, per_source, torch.float64, cell.device),
                              block)
    _, low_radius = solve.spot(cell.ref, cell.cfg,
                                      {k: v.to(LOW) for k, v in theta.items()},
                                      cell.ref.rays(cell.cfg, per_source, LOW, cell.device),
                                      block)
    return {"spot_gap": abs(low_radius - radius) / radius}


def half_batch(name, seed, device="cuda", traffic=None, cfg=None):
    """An optimize cell's numbers with the float64 reference over the first
    half of the rays in the program's place."""
    cell = _cell(name, seed, device, traffic, cfg)
    theta = _theta(cell, torch.float32)
    n = cell.traffic["rays_per_source"] * len(cell.cfg.get("source_wavelengths_um", [0]))
    half = optimize.reference_readings(cell, theta, n_rays=n // 2)
    return optimize.numbers(optimize.reference_readings(cell, theta), [half])


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--first-seed", type=int, default=3_000_000_001)
    parser.add_argument("--seeds", type=int, default=12)
    parser.add_argument("--control-seeds", type=int, default=3)
    parser.add_argument("--seconds", type=float, default=2.0)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("calibrate.py reads the card; no CUDA device found", file=sys.stderr)
        return 1
    card = torch.cuda.get_device_name()
    seeds = [args.first_seed + 7919 * i for i in range(args.seeds)]
    for seed in seeds:
        start = time.perf_counter()
        result = runner.run_cell(args.workload, seed, args.seconds, False, "cuda",
                                 time.perf_counter())
        print(json.dumps({"reading": "program", "cell": args.workload, "seed": seed,
                          "correct": result.correct, "attempted": result.attempted,
                          "numbers": {n: v for n, v, _ in result.checks}, "card": card,
                          "seconds": time.perf_counter() - start}), flush=True)
        common.release()
    readings = [("control", control)]
    if args.workload.endswith(".optimize"):
        readings.append(("half_batch", half_batch))
    for label, fn in readings:
        for seed in seeds[:args.control_seeds]:
            start = time.perf_counter()
            numbers = fn(args.workload, seed)
            print(json.dumps({"reading": label, "cell": args.workload, "seed": seed,
                              "numbers": numbers, "card": card,
                              "seconds": time.perf_counter() - start}), flush=True)
            common.release()
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""``BENCHMARK.json`` and the files it names, found by name.

A configuration is ``configs/<config>.json`` (its numbers) with
``configs/<config>_reference.py`` (its plain reference) and
``configs/<config>_port.py`` (its build with the program); a traffic mix is
``traffic/<traffic>.json``; a cell's limits are ``limits/<cell>.json``; a
per-layer metric is read by ``metrics/<metric>.py``'s ``read(ctx)``.
"""

from __future__ import annotations

import functools
import importlib.util
import json
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


@functools.lru_cache(maxsize=None)
def load():
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def workload(name):
    for w in load()["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config_entry(name):
    for c in load()["configs"]:
        if c["name"] == name:
            return c
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def config_numbers(name):
    with open(ROOT / config_entry(name)["file"]) as f:
        return json.load(f)


def traffic(name):
    with open(BENCH / "traffic" / f"{name}.json") as f:
        return json.load(f)


def limits(cell):
    with open(BENCH / "limits" / f"{cell}.json") as f:
        return json.load(f)["limits"]


def _reports(metric, cell):
    return cell in metric["workloads"] if "workloads" in metric else True


def end_to_end_metrics(cell):
    return [m for m in load()["end_to_end"] if _reports(m, cell)]


def per_layer_metrics(cell):
    """The per-layer metrics reported in ``cell``: those that list it, and
    those without a list whose end-to-end metric the cell reports."""
    reported = {m["name"] for m in end_to_end_metrics(cell)}
    return [m for m in load()["per_layer"]
            if (cell in m["workloads"] if "workloads" in m else m["moves"] in reported)]


@functools.lru_cache(maxsize=None)
def reader(metric):
    path = BENCH / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark.metrics.{metric}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read

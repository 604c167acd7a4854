"""BENCHMARK.json against the benchmark's contract, and the files it names."""

import ast
import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "benchmark"
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def test_keys_and_sizes():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs", "workloads",
                             "end_to_end", "per_layer"}
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= MANIFEST["run_seconds"] <= 51 and isinstance(MANIFEST["run_seconds"], int)
    assert 1 <= len(MANIFEST["configs"]) <= 24 and 1 <= len(MANIFEST["workloads"]) <= 24
    assert 1 <= len(MANIFEST["end_to_end"]) <= 16 and 1 <= len(MANIFEST["per_layer"]) <= 128
    cmd = MANIFEST["command"]
    assert len(cmd) <= 32 and all(1 <= len(w) <= 200 and "\n" not in w for w in cmd)
    for p in MANIFEST["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p) and not p.startswith("/")
        assert ".." not in p.split("/") and not p.endswith("_torch")
        assert (ROOT / p).is_dir()


def test_a_full_check_fits_with_24_cells():
    seconds = 2 + 14 * 24 * (MANIFEST["run_seconds"] + 60) + 24 * 2 * 90 + 1200
    assert seconds <= 43200


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_unique_and_well_formed(section):
    names = [e["name"] for e in MANIFEST[section]]
    assert len(set(names)) == len(names)
    assert all(NAME.match(n) for n in names)


def test_configs():
    used = {w["config"] for w in MANIFEST["workloads"]}
    files = set()
    for c in MANIFEST["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["name"] in used
        assert c["file"].startswith("benchmark/") and (ROOT / c["file"]).is_file()
        assert c["file"] not in files
        files.add(c["file"])
        numbers = json.loads((ROOT / c["file"]).read_text())
        assert numbers["reduced"] == c["reduced"] == []
        for text in (c["source"], c["why"]):
            assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text
        for side in ("port", "reference"):
            assert (BENCH / "configs" / f"{c['name']}_{side}.py").is_file()


def test_workloads():
    configs = {c["name"] for c in MANIFEST["configs"]}
    pairs = set()
    four = 0
    for w in MANIFEST["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in configs and w["chips"] in (1, 4)
        four += w["chips"] == 4
        assert NAME.match(w["traffic"]) and (BENCH / "traffic" / f"{w['traffic']}.json").is_file()
        assert (BENCH / "limits" / f"{w['name']}.json").is_file()
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
    assert four <= max(1, len(MANIFEST["workloads"]) // 4)


def _cells_of(metric):
    return set(metric.get("workloads", [w["name"] for w in MANIFEST["workloads"]]))


def test_metrics():
    cells = {w["name"] for w in MANIFEST["workloads"]}
    e2e = {m["name"]: m for m in MANIFEST["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in MANIFEST["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in {"host_clock", "device_trace"}
        assert 0.01 <= m["bound"] <= 0.25
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert _cells_of(m) <= cells
    for cell in cells:
        reported = [m for m in MANIFEST["end_to_end"] if cell in _cells_of(m)]
        assert "setup_s" in {m["name"] for m in reported} and len(reported) >= 2
        assert any(cell in _cells_of(m) for m in MANIFEST["per_layer"])
    layers = {}
    for m in MANIFEST["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in SOURCES and UNIT.match(m["unit"])
        assert 1 <= len(m["layer"]) <= 200 and "\n" not in m["layer"]
        assert m["moves"] in e2e
        # every cell that reads the metric reports the end-to-end metric it moves
        assert _cells_of(m) <= _cells_of(e2e[m["moves"]])
        assert (BENCH / "metrics" / f"{m['name']}.py").is_file()
        layers.setdefault(m["name"].split(".")[0], set()).add(m["layer"])
        if "roofline" in m["name"]:
            assert m["unit"] == "%"
    assert all(len(v) == 1 for v in layers.values())


def test_layers_are_those_of_perf_md():
    perf = (ROOT / "PERF.md").read_text()
    for m in MANIFEST["per_layer"]:
        assert f"| {m['layer']} |" in perf, m["layer"]


def test_limits_files_name_each_compared_number():
    for w in MANIFEST["workloads"]:
        limits = json.loads((BENCH / "limits" / f"{w['name']}.json").read_text())["limits"]
        assert limits and all(v >= 0 for v in limits.values())


def test_files_under_paths_are_named_from_name_characters():
    for path in BENCH.rglob("*"):
        if "__pycache__" in path.parts or path.is_dir():
            continue
        rel = path.relative_to(ROOT).as_posix()
        assert re.fullmatch(r"[A-Za-z0-9_./-]+", rel), rel


def test_traffic_and_config_files_are_data():
    for path in (BENCH / "traffic").iterdir():
        assert path.suffix in (".json", ".jsonl", ".toml", ".txt", ".csv")
        json.loads(path.read_text())
    ast.parse((BENCH / "run.py").read_text())

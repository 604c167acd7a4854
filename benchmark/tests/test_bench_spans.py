"""``harness/spans.py`` on synthetic traces: the host ms per step or call
inside the program's spans, each instant counted once, exclusions taken
out, spans clipped to the profiled window, and None where the program
recorded no span."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark.harness import manifest, spans  # noqa: E402
from benchmark.harness.profiling import Activity, Trace  # noqa: E402


def _trace(host, calls=1, window=(0.0, 1.0)):
    acts = [Activity(name, s, e, "host") for name, s, e in host]
    return {"trace": Trace(calls, window, [], acts, [])}


def test_one_span_over_calls():
    ctx = _trace([("pyrayt.scene.compile", 0.1, 0.3)], calls=2)
    assert spans.compile_ms(ctx) == pytest.approx(100.0)


@pytest.mark.parametrize("host, seconds", [
    ([("pyrayt.ops.staged_tail", 0.1, 0.3), ("pyrayt.ops.staged_tail", 0.2, 0.4)], 0.3),
    ([("pyrayt.ops.tables", 0.1, 0.5), ("pyrayt.ops.fused_trace", 0.2, 0.3)], 0.4),
    ([("pyrayt.ops.fused_trace", 0.1, 0.2), ("pyrayt.ops.fused_bwd", 0.3, 0.4)], 0.2),
], ids=["overlapping", "nested", "apart"])
def test_each_instant_counts_once(host, seconds):
    assert spans.wrapper_ms(_trace(host)) == pytest.approx(1e3 * seconds)


def test_exclusions_are_taken_out():
    host = [("pyrayt.optimize.backward", 0.0, 0.5), ("pyrayt.ops.staged_tail", 0.1, 0.2),
            ("pyrayt.ops.staged_group", 0.15, 0.3), ("pyrayt.ops.fused_trace", 0.6, 0.7)]
    assert spans.autograd_ms(_trace(host)) == pytest.approx(300.0)
    frame = [("pyrayt.frame", 0.2, 0.9), ("pyrayt.frame.copy", 0.2, 0.5),
             ("pyrayt.frame.rows", 0.5, 0.9)]
    assert spans.frame_ms(_trace(frame)) == pytest.approx(400.0)


def test_spans_are_clipped_to_the_window():
    host = [("pyrayt.sources", 0.5, 1.5), ("pyrayt.sources", 1.6, 1.9),
            ("pyrayt.sources", 2.5, 3.0)]
    assert spans.sources_ms(_trace(host, window=(1.0, 2.0))) == pytest.approx(800.0)


def test_names_match_whole():
    host = [("pyrayt.frame.copy", 0.0, 0.5), ("pyrayt.optimize.update_x", 0.0, 0.5),
            ("frame", 0.0, 0.5), ("bench.objective.build", 0.0, 0.5)]
    ctx = _trace(host)
    assert spans.frame_ms(ctx) is None
    assert spans.update_ms(ctx) is None
    assert spans.builders_ms(ctx) is None


@pytest.mark.parametrize("ctx", [{}, _trace([]), _trace([("aten::empty", 0.1, 0.2)]),
                                 _trace([("pyrayt.optimize.readback", 1.5, 1.6)]),
                                 _trace([("pyrayt.optimize.readback", 0.1, 0.2)], calls=0)],
                         ids=["no trace", "empty", "ops only", "outside", "no calls"])
def test_no_span_reads_none(ctx):
    assert spans.wait_ms(ctx) is None


def test_every_span_metric_reads_a_span_of_its_own():
    readers = {m["name"]: manifest.reader(m["name"]) for m in manifest.load()["per_layer"]
               if m["source"] == "program_span"}
    assert len(readers) == 13
    host = [("pyrayt." + name, 0.0, 0.1) for name in (
        "objective.build", "scene.compile", "sources", "ops.fused_trace", "optimize.backward",
        "optimize.update", "optimize.readback", "frame")]
    ctx = _trace(host)
    for name, read in readers.items():
        value = read(ctx)
        # the backward's span is also a wrapper's here, so nothing is left
        assert value == pytest.approx(0.0 if name.startswith("autograd") else 100.0), name

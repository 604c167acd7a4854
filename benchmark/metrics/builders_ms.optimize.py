"""Host ms per optimize step in the cell's build function, inside the
program's ``pyrayt.objective.build`` span."""

from benchmark.harness.spans import builders_ms as read  # noqa: F401

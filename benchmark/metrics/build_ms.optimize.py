"""Host ms per optimize step in the cell's build function (the program's
builders), timed by the benchmark over the traced run's window."""

from benchmark.harness.readers import build_ms as read  # noqa: F401

"""Host ms per trace() call to the frame generating the sources' rays (the
program's ``pyrayt.sources`` span)."""

from benchmark.harness.spans import sources_ms as read  # noqa: F401

"""Host ms per trace call generating the sources' rays (the program's
``pyrayt.sources`` span)."""

from benchmark.harness.spans import sources_ms as read  # noqa: F401

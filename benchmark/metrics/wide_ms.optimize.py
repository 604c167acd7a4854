"""Device ms per optimize step in the wide path's kernels: K2, the staged
backward K5-K7 and its table reduce (``harness/wide.py``)."""

from benchmark.harness.wide import wide_ms as read  # noqa: F401

"""Device kernels launched per optimize step, counted in the profiled window."""

from benchmark.harness.readers import launches as read  # noqa: F401

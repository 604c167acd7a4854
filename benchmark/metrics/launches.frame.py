"""Device kernels launched per trace() call to the frame, counted in the
profiled window."""

from benchmark.harness.readers import launches as read  # noqa: F401

"""Device kernels launched per sharded design step on rank 0's card,
counted in the profiled window."""

from benchmark.harness.readers import launches as read  # noqa: F401

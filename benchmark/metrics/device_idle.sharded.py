"""Share of the profiled sharded design steps in which no kernel, copy or
fill ran on rank 0's card, in %."""

from benchmark.harness.readers import device_idle as read  # noqa: F401

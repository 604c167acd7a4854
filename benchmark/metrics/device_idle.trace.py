"""Share of the profiled trace calls in which no kernel, copy or fill ran on
the device, in %."""

from benchmark.harness.readers import device_idle as read  # noqa: F401

"""Device ms of device-to-host copies per trace() call: the records' trip to
the host frame."""

from benchmark.harness.readers import dtoh_ms as read  # noqa: F401

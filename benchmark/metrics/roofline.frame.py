"""The least time of a trace() call's function (the forward trace, bytes
and operations at the published peaks) over the device time of all the
call's kernels, in %."""

from benchmark.harness.readers import roofline as read  # noqa: F401

"""The least time of an optimize step's functions (the forward trace and the
loss's backward, bytes and operations at the published peaks) over the
device time of all the step's kernels, in %."""

from benchmark.harness.readers import roofline as read  # noqa: F401

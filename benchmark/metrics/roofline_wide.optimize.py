"""The least time of an optimize step's functions (the forward trace and the
loss's backward, bytes and operations at the published peaks) over the
device time of the wide path's kernels alone, in %."""

from benchmark.harness.wide import roofline_wide as read  # noqa: F401

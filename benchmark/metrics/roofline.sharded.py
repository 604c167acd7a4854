"""The least time of a sharded design step's functions on rank 0's block
of rays (the forward trace and the loss's backward, bytes and operations
at the published peaks) over the device time of all the step's kernels on
rank 0's card, in %."""

from benchmark.harness.readers import roofline as read  # noqa: F401

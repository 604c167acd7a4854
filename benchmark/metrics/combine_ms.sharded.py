"""Host ms per sharded design step on rank 0 combining over the ranks: the
loss's partial sums (``pyrayt.parallel.partials``, with the wait for the
slowest rank) and the gradient's sum (``pyrayt.parallel.grad_sum``)."""

from benchmark.harness.spans import host_ms


def read(ctx):
    return host_ms(ctx, ["parallel.partials", "parallel.grad_sum"])

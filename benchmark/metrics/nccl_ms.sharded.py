"""Device ms per sharded design step in NCCL's kernels on rank 0's card
(their wait for the other ranks included)."""


def read(ctx):
    trace = ctx.get("trace")
    if trace is None or not trace.calls:
        return None
    kernels = [a for a in trace.kernels() if "nccl" in a.name.lower()]
    if not kernels:
        return None
    return 1e3 * sum(a.end - a.start for a in kernels) / trace.calls

"""Host ms per optimize step in the wide kernels' box pass, the program's
``pyrayt.ops.cull`` span (inside ``pyrayt.ops.tables``)."""

from benchmark.harness.spans import host_ms


def read(ctx):
    return host_ms(ctx, ["ops.cull"])

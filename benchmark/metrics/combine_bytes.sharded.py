"""Bytes per sharded design step in the buffers of rank 0's collectives
(the program's ``parallel.mesh.all_reduce.bytes`` counter over the profiled
steps); None where the program counts none."""


def read(ctx):
    return ctx.get("combine_bytes")

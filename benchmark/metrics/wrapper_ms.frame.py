"""Host ms per trace() call to the frame in the kernels' wrappers and host
tables (the program's ``pyrayt.ops.*`` spans)."""

from benchmark.harness.spans import wrapper_ms as read  # noqa: F401

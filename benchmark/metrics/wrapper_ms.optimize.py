"""Host ms per optimize step in the kernels' wrappers and host tables (the
program's ``pyrayt.ops.*`` spans)."""

from benchmark.harness.spans import wrapper_ms as read  # noqa: F401

"""Host ms per optimize step in ``compile_scene`` (the program's
``pyrayt.scene.compile`` span)."""

from benchmark.harness.spans import compile_ms as read  # noqa: F401

"""Host ms per trace() call building the results frame outside its copies
(``pyrayt.frame`` less ``pyrayt.frame.copy``)."""

from benchmark.harness.spans import frame_ms as read  # noqa: F401

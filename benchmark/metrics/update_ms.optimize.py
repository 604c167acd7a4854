"""Host ms per optimize step in the optimizer's and the scheduler's steps
(the program's ``pyrayt.optimize.update`` span)."""

from benchmark.harness.spans import update_ms as read  # noqa: F401

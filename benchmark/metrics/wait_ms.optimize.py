"""Host ms per optimize step reading the loss back, where the host waits
for the card (the program's ``pyrayt.optimize.readback`` span)."""

from benchmark.harness.spans import wait_ms as read  # noqa: F401

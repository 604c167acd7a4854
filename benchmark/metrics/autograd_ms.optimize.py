"""Host ms per optimize step in ``loss.backward()`` outside the backward
kernels' wrappers (``pyrayt.optimize.backward`` less ``pyrayt.ops.*``)."""

from benchmark.harness.spans import autograd_ms as read  # noqa: F401

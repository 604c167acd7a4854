"""The ``mla32`` configuration built with ``pyrayt_tpu_torch``: the
``mla16`` configuration's builders, grid source and lenslet blur
(``mla16_port.py``), which take the array's size from ``n`` of
``mla32.json``."""

from __future__ import annotations

from benchmark.configs.mla16_port import components, loss, rays, sources  # noqa: F401

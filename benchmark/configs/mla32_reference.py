"""Plain reference of the ``mla32`` configuration (``mla32.json``).

The ``mla16`` configuration's scene, rays and lenslet blur
(``mla16_reference.py``), which take the array's size from ``n``: a
32 x 32 array of the same lenslets, its detector and a grid of rays over
0.95 of it.  Imports nothing of the program.
"""

from __future__ import annotations

from benchmark.configs.mla16_reference import (  # noqa: F401
    focus,
    groups,
    loss_parts,
    loss_value,
    rays,
    scene_counts,
    surface_id,
    theta,
)

"""The ``doublet4`` configuration built with ``pyrayt_tpu_torch``: the
``doublet`` configuration's builders and loss (``doublet_port.py``), with
each rank's block of the six lines of rays generated on its own card
(``parallel.shard_sources``)."""

from __future__ import annotations

from benchmark.configs.doublet_port import components, loss, sources  # noqa: F401


def rays(cfg, n_per_source, mesh, dtype):
    """This rank's block of the six lines, ids over the whole set, padded
    with dead rays to the same count on every rank."""
    from pyrayt_tpu_torch.parallel import shard_sources

    return shard_sources(sources(cfg), n_per_source, mesh, dtype)

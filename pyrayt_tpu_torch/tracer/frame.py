"""Host-edge conversion of trace records to the results DataFrame.

Counterpart of ``pyrayt_tpu.tracer.frame``.  The ``(G, 15, n)`` record
buffer and its ``(G, n)`` mask become the 15-column float32 frame: rows
ordered generation by generation, and within a generation by ray.  The
compact default slices the live generations and casts to float32 on the
device before the copy to the host, so the copy moves the fewest bytes.
"""

from __future__ import annotations

import pandas as pd
import torch

from pyrayt_tpu_torch import tracing

__all__ = ["FRAME_COLUMNS", "records_to_dataframe", "live_generations"]

FRAME_COLUMNS = (
    "generation",
    "intensity",
    "wavelength",
    "index",
    "id",
    "surface",
    "x0",
    "y0",
    "z0",
    "x1",
    "y1",
    "z1",
    "x_tilt",
    "y_tilt",
    "z_tilt",
)


def live_generations(record_mask) -> int:
    """Number of leading generations with at least one recorded ray."""
    return int(record_mask.any(dim=1).sum())


def records_to_dataframe(records, record_mask, compact=None) -> pd.DataFrame:
    """Build the results frame from the record buffer.

    ``compact=None`` resolves to the sliced float32 copy; ``False`` copies
    the whole buffer and selects on the host.
    """
    if compact is None:
        compact = True
    with tracing.span("frame"):
        # the host waits for the trace at the first read, then copies
        with tracing.span("frame.copy"):
            if compact:
                g = max(live_generations(record_mask), 1)
                records, record_mask = records[:g], record_mask[:g]
            records = records.to(torch.float32).cpu().numpy()  # (g, 15, n)
            record_mask = record_mask.cpu().numpy()  # (g, n)
        with tracing.span("frame.rows"):
            rows = records.transpose(0, 2, 1)[record_mask]
            return pd.DataFrame(rows, columns=list(FRAME_COLUMNS), dtype="float32")

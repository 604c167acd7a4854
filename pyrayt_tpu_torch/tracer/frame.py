"""Host-edge conversion of trace records to the results DataFrame.

Counterpart of ``pyrayt_tpu.tracer.frame``.  The ``(G, 15, n)`` record
buffer and its ``(G, n)`` mask become the 15-column float32 frame: rows
ordered generation by generation, and within a generation by ray.

The compact default selects the live rows where the records are.
``nonzero`` of the flat mask (the one wait for the device) gives the
slots in frame order, one gather reads their 15 values into a fresh
``(15, rows)`` buffer and casts it to float32, and one copy moves only
those bytes to the host (span ``frame.copy``).  From a CUDA device that
copy lands in page-locked memory from PyTorch's caching host allocator,
so the copy engine writes the frame's own buffer directly; the copy runs
on the current stream, and the host waits for that stream once.  pandas
then takes that column-major buffer as its block without copying it
(span ``frame.rows``).  Each frame owns its buffer: its NumPy view keeps
the tensor alive, and a dropped frame's block goes back to the host cache
for the next frame of a similar size (the cache rounds a block up to a
power of two).  Where the page-locked allocation raises, that frame's copy
is pageable, as from ``.cpu()``.  ``compact=False`` copies the whole buffer
and selects on the host, the plain twin that the tests hold the default
against.
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

    ``compact=None`` resolves to the selection on the records' device,
    counted in ``records_to_dataframe.rows`` (rows selected) and
    ``records_to_dataframe.slots`` (the ``G * n`` slots they were selected
    from), and for records on a CUDA device in ``.pinned`` (frames built
    on a page-locked buffer) or ``.pageable`` (frames whose page-locked
    allocation raised); ``False`` copies the whole buffer and selects on
    the host.
    """
    if compact is None:
        compact = True
    with tracing.span("frame"):
        # the host waits for the trace at the first read, then copies
        with tracing.span("frame.copy"):
            if compact:
                columns = _to_host(_live_columns(records, record_mask)).numpy()  # (15, rows)
            else:
                records = records.to(torch.float32).cpu().numpy()  # (G, 15, n)
                record_mask = record_mask.cpu().numpy()  # (G, n)
        with tracing.span("frame.rows"):
            if compact:
                # the transpose is pandas' column-major block itself
                return pd.DataFrame(columns.T, columns=list(FRAME_COLUMNS), copy=False)
            rows = records.transpose(0, 2, 1)[record_mask]
            return pd.DataFrame(rows, columns=list(FRAME_COLUMNS), dtype="float32")


def _live_columns(records, record_mask):
    """The live slots' records as a fresh float32 ``(15, rows)`` tensor on
    the records' device, rows in frame order."""
    g, n = record_mask.shape
    slots = torch.nonzero(record_mask.reshape(-1)).squeeze(1)  # ascending: frame order
    # two index tensors of one shape: CUDA's indexing would make
    # broadcast (15, rows) copies of indices whose strides differ
    columns = records.transpose(0, 1)[:, slots // n, slots % n].to(torch.float32)
    records_to_dataframe.rows += slots.numel()
    records_to_dataframe.slots += g * n
    return columns


def _to_host(columns):
    """``columns`` in host memory: from a CUDA device, one copy into a
    page-locked tensor of the caching host allocator, waited for on the
    current stream; on the host, ``columns`` itself."""
    if not columns.is_cuda:
        return columns
    try:
        host = torch.empty(columns.shape, dtype=columns.dtype, pin_memory=True)
    except RuntimeError:
        records_to_dataframe.pageable += 1
        return columns.cpu()
    host.copy_(columns, non_blocking=True)
    torch.cuda.current_stream(columns.device).synchronize()
    records_to_dataframe.pinned += 1
    return host


records_to_dataframe.rows = 0
records_to_dataframe.slots = 0
records_to_dataframe.pinned = 0
records_to_dataframe.pageable = 0

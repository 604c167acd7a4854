"""Trace engine, ray storage, and the user-facing RayTracer."""

from pyrayt_tpu_torch.tracer.rayset import RaySet, concatenate
from pyrayt_tpu_torch.tracer.engine import TraceResult, build_trace_fn, trace_rays
from pyrayt_tpu_torch.tracer.frame import FRAME_COLUMNS, records_to_dataframe
from pyrayt_tpu_torch.tracer.tracer import RayTracer, pin

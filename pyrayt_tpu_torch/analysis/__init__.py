"""Analysis: aberration curves, differentiable metrics, gradient
validation, checkpoints and gradient-based lens optimization (counterpart
of ``pyrayt_tpu.analysis``)."""

from pyrayt_tpu_torch.analysis.aberrations import chromatic_aberration, coma, spherical_aberration
from pyrayt_tpu_torch.analysis.checkpoint import latest_step, restore_checkpoint, save_checkpoint
from pyrayt_tpu_torch.analysis.gradcheck import check_gradients, finite_difference_grad
from pyrayt_tpu_torch.analysis.metrics import (
    COL,
    FocusError,
    RmsSpotRadius,
    SoftFocusError,
    axis_intercepts,
    detector_weights,
    focus_error,
    last_generation_mask,
    masked_mean,
    rms_spot_radius,
    smoothstep,
    soft_focus_error,
    soft_rms_spot_radius,
    spot_diagram_points,
    surface_mask,
    weighted_mean,
    window_weights,
)
from pyrayt_tpu_torch.analysis.optimize import build_objective, optimize

__all__ = [
    "chromatic_aberration",
    "coma",
    "spherical_aberration",
    "latest_step",
    "restore_checkpoint",
    "save_checkpoint",
    "check_gradients",
    "finite_difference_grad",
    "COL",
    "FocusError",
    "RmsSpotRadius",
    "SoftFocusError",
    "axis_intercepts",
    "detector_weights",
    "focus_error",
    "last_generation_mask",
    "masked_mean",
    "rms_spot_radius",
    "smoothstep",
    "soft_focus_error",
    "soft_rms_spot_radius",
    "spot_diagram_points",
    "surface_mask",
    "weighted_mean",
    "window_weights",
    "build_objective",
    "optimize",
]

"""Viewport rendering: orthographic edge and Gooch-shaded renderers and
``draw()`` (counterpart of ``pyrayt_tpu.render``).

The nearest-hit pass runs on the device through the plain engine's
``scene_nearest_hit``, the search the tracer runs; shading and edge
extraction are host-side viewport work.
"""

from pyrayt_tpu_torch.render import color, gooch, renderers
from pyrayt_tpu_torch.render.camera import OrthographicCamera
from pyrayt_tpu_torch.render.color import RGBAColor
from pyrayt_tpu_torch.render.gooch import GoochMaterial
from pyrayt_tpu_torch.render.renderers import EdgeRender, ShadedRenderer, draw

__all__ = [
    "color",
    "gooch",
    "renderers",
    "OrthographicCamera",
    "RGBAColor",
    "GoochMaterial",
    "EdgeRender",
    "ShadedRenderer",
    "draw",
]

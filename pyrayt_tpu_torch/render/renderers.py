"""Orthographic viewport renderers (edge and Gooch-shaded) and ``draw()``
(counterpart of ``pyrayt_tpu.render.renderers``).

The whole pixel grid is one batched nearest-hit pass through the plain
engine's ``scene_nearest_hit``, the search the tracer runs, on the device
the caller names (None: the CUDA card); edge extraction and Gooch shading
are cheap host-side NumPy post-processing.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from pyrayt_tpu_torch.config import default_device
from pyrayt_tpu_torch.render.camera import OrthographicCamera
from pyrayt_tpu_torch.scene.compile import compile_scene
from pyrayt_tpu_torch.tracer.engine import scene_nearest_hit, scene_tables

__all__ = ["EdgeRender", "ShadedRenderer", "draw"]


def _propagate(camera: OrthographicCamera, shapes, device, dtype):
    """One device pass: per-pixel rays, nearest hit distance and public
    surface id (-1: no hit), as host NumPy arrays."""
    scene = compile_scene(shapes, require_materials=False, device=device, dtype=dtype)
    rays = camera.generate_rays(device=device, dtype=dtype)
    with torch.no_grad():
        hit_distances, hit_leaf = scene_nearest_hit(scene.spec, scene_tables(scene.params), rays)
    leaf_ids = torch.as_tensor(scene.spec.leaf_ids, dtype=torch.int64, device=rays.device)
    surface_ids = torch.where(hit_leaf >= 0, leaf_ids[hit_leaf.clamp(min=0).long()], -1)
    return rays.cpu().numpy(), hit_distances.cpu().numpy(), surface_ids.cpu().numpy()


def _binary_dilation(image: np.ndarray, iterations: int) -> np.ndarray:
    """8-connected binary dilation via shifted maxima."""
    out = image.astype(bool)
    for _ in range(max(iterations, 0)):
        padded = np.pad(out, 1)
        acc = np.zeros_like(out)
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                acc |= padded[1 + dy:padded.shape[0] - 1 + dy, 1 + dx:padded.shape[1] - 1 + dx]
        out = acc
    return out


class _RendererBase:
    """Camera and scene plumbing shared by the renderers: ``render()`` is
    one nearest-hit pass, then the subclass's ``_interact``."""

    def __init__(self, camera: OrthographicCamera, surfaces: list, device=None,
                 dtype: torch.dtype = torch.float32):
        self._camera = camera
        self._shapes = surfaces if hasattr(surfaces, "__iter__") else (surfaces,)
        self._device = default_device(device)
        self._dtype = dtype
        self._results = None
        self._simulation_complete = False

    def reset(self):
        self._results = None
        self._simulation_complete = False

    def render(self):
        rays, hit_distances, hit_surfaces = _propagate(self._camera, self._shapes, self._device,
                                                       self._dtype)
        self._results = self._interact(rays, hit_distances, hit_surfaces)
        self._simulation_complete = True
        return self._results


class EdgeRender(_RendererBase):
    """Silhouette render: edges where the per-pixel surface id changes."""

    ray_offset_value = 1e-6

    def _interact(self, rays, hit_distances, hit_surfaces):
        hit_matrix = hit_surfaces.reshape(self._camera.get_resolution()[-1], -1)
        h_diffs = np.abs(np.diff(hit_matrix, axis=-1, prepend=-1))
        v_diffs = np.abs(np.diff(hit_matrix, axis=0, prepend=-1))
        edges = _binary_dilation((h_diffs + v_diffs) > 0,
                                 iterations=max(1, int(max(hit_matrix.shape) / 300)))
        canvas = np.zeros((*hit_matrix.shape, 4), dtype=float)
        canvas[...] = np.logical_not(edges)[..., np.newaxis]
        canvas[..., 3] = edges
        return canvas


class ShadedRenderer(_RendererBase):
    """Gooch-shaded render: each surface shades the pixels it was hit at."""

    def __init__(self, camera: OrthographicCamera, shapes: list, light_position, device=None,
                 dtype: torch.dtype = torch.float32):
        super().__init__(camera, shapes, device, dtype)
        self._light = np.asarray(light_position)
        self._surface_lut = tuple()
        for shape in self._shapes:
            self._surface_lut += shape.surface_ids

    def _interact(self, rays, hit_distances, hit_surfaces):
        canvas = np.zeros((4, rays.shape[-1]))
        for surface_id, surface in self._surface_lut:
            surface_mask = hit_surfaces == surface_id
            if np.any(surface_mask):
                canvas[:, surface_mask] = surface.shade(
                    rays[..., surface_mask], hit_distances[surface_mask],
                    light_positions=self._light)
        return canvas.T.reshape(*self._camera.get_resolution()[::-1], 4)


def draw(surfaces, view: str = "xy", axis=None, shaded: bool = True, bounds=None,
         resolution: int = 640, device=None, dtype: torch.dtype = torch.float32):
    """Render components into a matplotlib axis with world-extent mapping;
    the nearest-hit pass runs on ``device`` (None: the CUDA card)."""
    import matplotlib.pyplot as plt

    if not hasattr(surfaces, "__iter__"):
        surfaces = (surfaces,)

    if bounds is not None:
        mins = np.asarray(bounds[0])
        maxes = np.asarray(bounds[1])
    else:
        spans = np.stack([np.asarray(surface.bounding_box) for surface in surfaces])  # (k, 3, 2)
        mins = spans[..., 0].min(axis=0)
        maxes = spans[..., 1].max(axis=0)

    if axis is None:
        axis = plt.gca()

    if view not in ("xy", "xz"):
        raise ValueError(f"view {view!r} is not one of ('xy', 'xz')")
    _draw_projection(surfaces, axis, shaded, resolution, maxes, mins, view, device, dtype)


def _draw_projection(surfaces: List, axis, shaded, resolution, maxes, mins, plane: str, device,
                     dtype):
    camera_origin = (maxes + mins) / 2
    if plane == "xy":
        camera_origin[2] = 1.5 * maxes[2]
        h_span, v_span = 1.5 * (maxes[:2] - mins[:2])
    else:
        camera_origin[1] = 1.5 * maxes[1]
        h_span, v_span = 1.5 * (maxes[[0, 2]] - mins[[0, 2]])
    h_span = max(h_span, 1e-6)
    v_span = max(v_span, 1e-6)
    resolution = resolution if h_span > v_span else int(resolution * h_span / v_span)

    camera = OrthographicCamera(resolution, h_span, v_span / h_span)
    light_position = np.append(maxes.astype(float), 1.0)
    if plane == "xy":
        camera.rotate_y(90).rotate_z(90).move(*camera_origin[:3])
        light_position[2] *= 3
    else:
        camera.rotate_z(90).move(*camera_origin[:3])
        light_position[1] *= -3

    if shaded:
        renderer = ShadedRenderer(camera, surfaces, light_position=light_position, device=device,
                                  dtype=dtype)
    else:
        renderer = EdgeRender(camera, surfaces, device=device, dtype=dtype)
    image = renderer.render()

    a0 = camera_origin[0]
    a1 = camera_origin[1] if plane == "xy" else camera_origin[2]
    axis.imshow(image, extent=[a0 - h_span / 2, a0 + h_span / 2, a1 - v_span / 2,
                               a1 + v_span / 2])
    axis.set_axisbelow(True)

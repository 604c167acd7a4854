"""User-facing RayTracer and the ``pin`` context manager.

Counterpart of ``pyrayt_tpu.tracer.tracer``: same constructor, ``trace()``
returning the 15-column results DataFrame, getters/setters and
``calculate_source_ids``.  The trace runs on the CUDA card unless the
caller passes ``device="cpu"``: on the card through the CUDA kernel
(ops/fused_trace.py) when the scene supports it, otherwise through the
plain engine.

Extras: ``trace_device()`` keeps the results on the device (a
TraceResult); ``trace_fn()`` returns the plain ``(params, rays) ->
TraceResult`` function with the current params and initial rays.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from pyrayt_tpu_torch import tracing
from pyrayt_tpu_torch.config import TraceConfig, default_device
from pyrayt_tpu_torch.core.operations import affine_inverse
from pyrayt_tpu_torch.scene._backend import as_tensor_like
from pyrayt_tpu_torch.scene._factors import mat4_mul
from pyrayt_tpu_torch.scene.compile import compile_scene
from pyrayt_tpu_torch.tracer import engine
from pyrayt_tpu_torch.tracer.frame import records_to_dataframe
from pyrayt_tpu_torch.tracer.rayset import concatenate

__all__ = ["RayTracer", "pin"]


class RayTracer:
    ray_offset_value = 1e-6
    """How far rays are offset from intersected surfaces between generations."""

    ray_intensity_threshold = 0.1
    """Intensity threshold below which rays are killed (opt-in; see
    TraceConfig.apply_intensity_threshold)."""

    def __init__(
        self,
        sources,
        components,
        rays_per_source=10,
        generation_limit=10,
        config: Optional[TraceConfig] = None,
        device=None,
        dtype: torch.dtype = torch.float32,
    ):
        """A simulator that traces rays from ``sources`` through ``components``.

        :param sources: a single source or an iterable of sources
        :param components: a single component or an iterable of components
        :param rays_per_source: rays generated per source
        :param generation_limit: maximum bounce count per ray
        :param config: optional :class:`TraceConfig` (``use_fused``,
            ``world_index``, ``apply_intensity_threshold``, ...).  The
            tracer's own state wins for ``generation_limit``, ``ray_offset``
            and ``intensity_threshold``
        :param device: where rays and scene params live.  None means
            ``"cuda"``, and raises when no CUDA device is present; pass
            ``device="cpu"`` to run the plain engine on the CPU
        :param dtype: float32 (production) or float64
        """
        self._sources = sources if hasattr(sources, "__iter__") else (sources,)
        self._components = components if hasattr(components, "__iter__") else (components,)
        self._rays_per_source = rays_per_source
        self._generation_limit = generation_limit
        self._base_config = config if config is not None else TraceConfig()
        self._world_index = self._base_config.world_index
        self._device = default_device(device)
        self._dtype = dtype
        self._frame_data = None
        self._result = None
        self._simulation_complete = False

        # flattened (surface_id, surface) lookup table
        self._surface_lut = tuple()
        for shape in self._components:
            self._surface_lut += shape.surface_ids

    # -- configuration -------------------------------------------------------

    def reset(self):
        """Destroy current results."""
        self._frame_data = None
        self._result = None
        self._simulation_complete = False

    def set_rays_per_source(self, n_rays: int) -> None:
        self._rays_per_source = n_rays

    def get_rays_per_source(self) -> int:
        return self._rays_per_source

    def set_generation_limit(self, limit):
        self._generation_limit = limit

    def get_generation_limit(self):
        return self._generation_limit

    def load_components(self, components) -> None:
        self._components = components if hasattr(components, "__iter__") else (components,)
        self._surface_lut = tuple()
        for shape in self._components:
            self._surface_lut += shape.surface_ids

    def get_system(self):
        """The current component list."""
        return self._components

    def set_config(self, config: TraceConfig) -> None:
        """Replace the base engine configuration (see ``__init__``)."""
        self._base_config = config
        self._world_index = config.world_index

    def get_config(self) -> TraceConfig:
        """The effective TraceConfig the next ``trace()`` will run with."""
        return self._config()

    def _config(self, fixed_loop=False) -> TraceConfig:
        return dataclasses.replace(
            self._base_config,
            generation_limit=self._generation_limit,
            ray_offset=self.ray_offset_value,
            intensity_threshold=self.ray_intensity_threshold,
            world_index=self._world_index,
            fixed_loop=fixed_loop,
        )

    def _scene(self):
        return compile_scene(self._components, device=self._device, dtype=self._dtype)

    def _initial_rays(self):
        with tracing.span("sources"):
            ray_set = concatenate(
                [
                    source.generate_rays(self._rays_per_source, device=self._device,
                                         dtype=self._dtype)
                    for source in self._sources
                ]
            )
            # unique ids across sources
            return ray_set.replace(
                id=torch.arange(ray_set.n_rays, dtype=self._dtype, device=self._device)
            )

    # -- tracing -------------------------------------------------------------

    def trace(self):
        """Run the simulation; returns the results DataFrame."""
        with tracing.span("trace"):
            result = self.trace_device()
            self._frame_data = records_to_dataframe(result.records, result.record_mask)
            return self._frame_data

    def trace_device(self, fixed_loop: bool = False) -> engine.TraceResult:
        """Run the trace and keep the results on the device."""
        with tracing.span("trace_device"):
            self._result = engine.trace_rays(
                self._scene(), self._initial_rays(), self._config(fixed_loop)
            )
            self._simulation_complete = True
            return self._result

    def trace_fn(self, fixed_loop: bool = False):
        """``(plain_fn, params, initial_rays)`` of the plain engine."""
        scene = self._scene()
        fn = engine.build_trace_fn(scene.spec, scene.materials, self._config(fixed_loop))
        return fn, scene.params, self._initial_rays()

    def get_results(self):
        """The results DataFrame from the last trace."""
        if self._frame_data is None and self._result is not None:
            self._frame_data = records_to_dataframe(
                self._result.records, self._result.record_mask
            )
        return self._frame_data

    def calculate_source_ids(self):
        """Add a ``source_id`` column derived from ray ids."""
        frame = self.get_results()
        frame["source_id"] = (frame["id"] / self._rays_per_source).astype(int)

    def show(self, view="xy", axis=None, color_function=None, ray_width=0.01, **kwargs) -> None:
        """Plot the components (``render.draw``, its nearest-hit pass on the
        tracer's device) and the traced ray segments, projected on the
        ``view`` plane; ``color_function`` "wavelength" or "source" colors
        the segments."""
        import matplotlib.pyplot as plt

        from pyrayt_tpu_torch.render import renderers
        from pyrayt_tpu_torch.utils import wavelength_to_rgb

        frame = self.get_results()

        color = "C0"
        if frame is not None and color_function == "wavelength":
            color = wavelength_to_rgb(frame["wavelength"].to_numpy())
        elif frame is not None and color_function == "source":
            n_colors = len(self._sources)
            colors = wavelength_to_rgb(np.linspace(0.45, 0.65, n_colors))
            color = np.empty((3, frame.shape[0]))
            ids = frame["id"].to_numpy()
            for n, this_color in enumerate(colors):
                in_source = (ids >= n * self._rays_per_source) & (
                    ids < (n + 1) * self._rays_per_source)
                color = np.where(in_source, np.atleast_2d(this_color).T, color)
            color = color.T

        shaded = kwargs.pop("shaded", False)
        show_at_end = False
        if axis is None:
            axis = plt.gca()
            show_at_end = True

        renderers.draw(self._components, view=view, axis=axis, shaded=shaded,
                       device=self._device, dtype=self._dtype, **kwargs)

        ax0, ax1 = ("x", "y") if view == "xy" else ("x", "z")
        if self._simulation_complete and frame is not None:
            u = frame[ax0 + "1"] - frame[ax0 + "0"]
            v = frame[ax1 + "1"] - frame[ax1 + "0"]
            axis.set_aspect("equal")
            axis.quiver(frame[ax0 + "0"], frame[ax1 + "0"], u, v, color=color, scale=1,
                        units="x", width=ray_width)

        if show_at_end:
            plt.show()


class pin:
    """Context manager pinning components' poses; restores them on exit."""

    _starting_matrices: List

    def __init__(self, *objects_to_pin):
        self._obj_set = objects_to_pin

    def __enter__(self):
        self._starting_matrices = [surface.get_world_transform() for surface in self._obj_set]
        return self._obj_set

    def __exit__(self, exception_type, exception_value, traceback):
        for this_object, starting_matrix in zip(self._obj_set, self._starting_matrices):
            final_matrix = this_object.get_world_transform()
            if isinstance(final_matrix, torch.Tensor) or isinstance(starting_matrix, torch.Tensor):
                # a traced pose: the same restore with tensor ops
                start_inv = (affine_inverse(starting_matrix)
                             if isinstance(starting_matrix, torch.Tensor)
                             else as_tensor_like(np.linalg.inv(starting_matrix), final_matrix))
                matrix_change = mat4_mul(final_matrix, start_inv)
                this_object.transform(affine_inverse(matrix_change))
                continue
            matrix_change = final_matrix @ np.linalg.inv(starting_matrix)
            this_object.transform(np.linalg.inv(matrix_change))

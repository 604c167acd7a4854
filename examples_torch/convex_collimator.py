"""Collimating a point source with a biconvex lens.

Port of the reference example (PyRayT's examples/convex_collimator.py)
onto the PyTorch port: a cone of rays from the lens's focal point exits
the lens collimated and lands on a baffle at x = 1.  On the CUDA card the
trace is one launch of the narrow kernel.

Run:  python examples_torch/convex_collimator.py [--show]
"""

import sys

import numpy as np
import torch

import pyrayt_tpu_torch as pyrayt
from pyrayt_tpu_torch import components
from pyrayt_tpu_torch.config import default_device


def main(show: bool = False, *, device=None, dtype=torch.float32) -> None:
    device = default_device(device)
    r1 = 2  # radius of curvature of the first surface
    r2 = 2  # radius of curvature of the second surface
    thickness = 0.25
    aperture = 1  # circular aperture, diameter 1

    lens = components.biconvex_lens(r1, r2, thickness, aperture=aperture)
    focus = pyrayt.lensmakers_equation(r1, -r2, 1.5, thickness)

    source = components.ConeOfRays(cone_angle=6).move_x(-focus)
    baffle = components.baffle((1, 1)).move_x(1)

    tracer = pyrayt.RayTracer(
        source, [lens, baffle], rays_per_source=50, generation_limit=100,
        device=device, dtype=dtype,
    )
    results = tracer.trace()

    collimated = results[results["generation"] == 2]
    print(f"traced {len(results)} segments; focal length {focus:.4f}")
    print(
        "collimated rays reach x=1 with x_tilt ~ 1:",
        bool(np.allclose(collimated["x1"], 1.0))
        and bool(np.allclose(collimated["x_tilt"], 1.0, atol=1e-3)),
    )
    if show:
        tracer.show()


if __name__ == "__main__":
    main(show="--show" in sys.argv)

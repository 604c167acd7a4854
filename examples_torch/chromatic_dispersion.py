"""White light dispersing through an equilateral prism.

Port of the reference example (PyRayT's examples/chromatic_dispersion.py)
onto the PyTorch port: 11 monochromatic rays spanning 0.44-0.75 um refract
through a BK7 prism; normal dispersion fans them out across a baffle,
shortest wavelengths deflected furthest.  On the CUDA card the trace is
one launch of the narrow kernel.

Run:  python examples_torch/chromatic_dispersion.py [--show]
"""

import sys

import numpy as np
import torch

import pyrayt_tpu_torch as pyrayt
from pyrayt_tpu_torch import components
from pyrayt_tpu_torch.config import default_device


def main(show: bool = False, *, device=None, dtype=torch.float32) -> None:
    device = default_device(device)
    prism_size = 1
    prism = components.equilateral_prism(prism_size, prism_size)
    prism.move_x(prism_size / 4)

    # a baffle catches the refracted rays so they appear in the results
    baffle = components.baffle((1, 1)).rotate_y(90).move(1, 0, -0.5)

    # one source per wavelength (sources are monochromatic)
    sources = [
        components.LineOfRays(spacing=0.1, wavelength=x)
        .move_x(-prism_size / 2)
        .rotate_y(-3)
        for x in np.linspace(0.44, 0.75, 11)
    ]

    tracer = pyrayt.RayTracer(sources, [prism, baffle], rays_per_source=1,
                              device=device, dtype=dtype)
    results = tracer.trace()

    final = results[results["generation"] == results["generation"].max()]
    spread = final.sort_values("wavelength")[["wavelength", "x1"]]
    print("landing position by wavelength (um -> x):")
    for _, row in spread.iterrows():
        print(f"  {row['wavelength']:.3f} -> {row['x1']:+.4f}")
    if show:
        tracer.show(color_function="wavelength", ray_width=0.005, view="xz")


if __name__ == "__main__":
    main(show="--show" in sys.argv)

"""All-reflective beam expander from two confocal OFF-AXIS parabolas.

A mirror-only system the reference's examples never cover (PyRayT's
example set is refractive): two parabolic mirror segments sharing a focus
form an afocal telescope — a collimated beam reflected by the small
segment converges through the common focus, the large segment
re-collimates it, and the output beam is expanded by the ratio of focal
lengths.  Off-axis segments keep the optical path unobstructed (an on-axis
pair would shadow its own input), exactly how laboratory OAP expanders are
built.

This exercises: parabolic_mirror with off_axis, multi-bounce mirror
physics, and beam metrics on the result frame.  On the CUDA card the
trace is one launch of the narrow kernel.

Run:  python examples_torch/reflective_beam_expander.py [--show]
"""

import sys

import numpy as np
import torch

import pyrayt_tpu_torch as pyrayt
from pyrayt_tpu_torch import components
from pyrayt_tpu_torch.config import default_device


F_SMALL = 0.5  # focal length of the input mirror
F_LARGE = 2.0  # focal length of the output mirror -> 4x expansion


def build_system():
    # both segments share the focus at the origin.  The small one catches
    # the input at y ~ +0.5; the large one (rotated to face the diverging
    # light) re-collimates at y ~ -2.0 — input, crossover, and output
    # paths never overlap.
    small = components.parabolic_mirror(
        focus=F_SMALL, thickness=0.1, aperture=0.8, off_axis=(0.5, 0.0)
    )
    large = (
        components.parabolic_mirror(
            focus=F_LARGE, thickness=0.1, aperture=3.2, off_axis=(2.0, 0.0)
        )
        .rotate_z(180)  # face -X; the segment lands at y = -2, focus stays
    )
    detector = components.baffle((8.0, 8.0)).move_x(-4.0)
    return small, large, detector


def main(show: bool = False, *, device=None, dtype=torch.float32) -> None:
    device = default_device(device)
    small, large, detector = build_system()
    beam_diameter = 0.6
    source = (
        components.LineOfRays(beam_diameter).rotate_z(180).move_x(4.0).move_y(0.5)
    )

    tracer = pyrayt.RayTracer(
        source, [small, large, detector], rays_per_source=21, generation_limit=8,
        device=device, dtype=dtype,
    )
    results = tracer.trace()

    final = results[results["surface"] == float(detector.get_id())]
    assert len(final) > 0, "no rays reached the detector"

    # output beam is collimated along -X ...
    tilts = final[["x_tilt", "y_tilt", "z_tilt"]].to_numpy()
    assert np.allclose(tilts[:, 0], -1.0, atol=1e-9), "output not collimated"
    # ... and expanded by f_large / f_small
    y_in = beam_diameter
    y_out = final["y1"].max() - final["y1"].min()
    expansion = y_out / y_in
    print(f"rays traced: {len(results)} rows")
    print(f"beam expansion: {expansion:.3f}x (expected {F_LARGE / F_SMALL:.1f}x)")
    assert abs(expansion - F_LARGE / F_SMALL) < 0.05

    if show:
        import matplotlib.pyplot as plt

        tracer.show(view="xy")
        plt.show()


if __name__ == "__main__":
    main(show="--show" in sys.argv[1:])

"""The benchmark's plain reference against the port's plain path at float64
on the CPU, at small sizes, for each traffic mix; and the copied byte
counts against ``chip_smoke.py``'s on the same inputs.

These catch a wrong reference before the card spends time on it.  The
port's side here is the plain engine (no CUDA kernel runs on the CPU)."""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark.configs import doublet_port, doublet_reference  # noqa: E402
from benchmark.configs import mla16_port, mla16_reference  # noqa: E402
from benchmark.harness import frame, manifest, roofline  # noqa: E402
from benchmark.reference import solve  # noqa: E402

F64 = torch.float64
CONFIGS = {
    "doublet": (doublet_port, doublet_reference, manifest.config_numbers("doublet")),
    # the array's every width as configured; 4 x 4 lenslets keep the CPU quick
    "mla4": (mla16_port, mla16_reference, dict(manifest.config_numbers("mla16"), n=4)),
    "mla16": (mla16_port, mla16_reference, manifest.config_numbers("mla16")),
}


def _port_trace(port, cfg, theta, per_source, fixed_loop=True):
    from pyrayt_tpu_torch.config import TraceConfig
    from pyrayt_tpu_torch.scene.compile import compile_scene
    from pyrayt_tpu_torch.scene.objects import fresh_ids
    from pyrayt_tpu_torch.tracer import engine

    with fresh_ids():
        parts = port.components(cfg, theta)
    scene = compile_scene(parts, device="cpu", dtype=F64)
    rays = port.rays(cfg, per_source, "cpu", F64)
    config = TraceConfig(generation_limit=cfg["generation_limit"], fixed_loop=fixed_loop)
    return engine.trace_rays(scene, rays, config), parts[-1].get_id()


def _draw(ref, cfg, traffic, seed=2**31 + 5):
    return ref.theta(cfg, manifest.traffic(traffic), np.random.default_rng(seed))


@pytest.mark.parametrize("name,per_source", [("doublet", 300), ("mla4", 4096), ("mla16", 8192)])
def test_records_equal_the_port_plain_trace(name, per_source):
    port, ref, cfg = CONFIGS[name]
    traffic = "design300_cosine" if name == "doublet" else "design30"
    theta = _draw(ref, cfg, traffic)
    result, surface_id = _port_trace(port, cfg, theta, per_source)
    assert surface_id == ref.surface_id(cfg)
    th = {k: torch.as_tensor(v) for k, v in theta.items()}
    rays = ref.rays(cfg, per_source, F64, "cpu")
    records, masks = solve.trace_records(ref, cfg, th, rays, F64, block=1000)
    assert torch.equal(masks, result.record_mask)
    assert int(masks.sum()) > per_source
    gap = (records - result.records).abs().permute(1, 0, 2)[:, masks]
    assert float(gap.max()) <= 1e-9


@pytest.mark.parametrize("name,traffic,per_source", [
    ("doublet", "design300_cosine", 200),
    ("mla4", "design30", 4096),
])
def test_loss_gradient_and_adam_steps_equal_the_port_objective(name, traffic, per_source):
    """The optimize mixes: three Adam steps of the reference against the
    port's build_objective and optimize on the CPU's plain engine."""
    from pyrayt_tpu_torch.analysis import build_objective, optimize
    from pyrayt_tpu_torch.config import TraceConfig
    from pyrayt_tpu_torch.scene.objects import fresh_ids

    port, ref, cfg = CONFIGS[name]
    mix = manifest.traffic(traffic)
    theta = {k: torch.as_tensor(v, dtype=F64) for k, v in _draw(ref, cfg, traffic).items()}
    rays = port.rays(cfg, per_source, "cpu", F64)
    with fresh_ids():
        surface_id = port.components(cfg, theta)[-1].get_id()
    objective = build_objective(lambda th: port.components(cfg, th), rays,
                                port.loss(cfg, surface_id),
                                TraceConfig(generation_limit=cfg["generation_limit"]))
    cosine = mix.get("schedule") == "cosine"
    sched = ((lambda o: torch.optim.lr_scheduler.CosineAnnealingLR(o, T_max=mix["steps"]))
             if cosine else None)
    # the port's gradient at theta, then three steps of its optimize
    params = {k: v.clone().requires_grad_(True) for k, v in theta.items()}
    objective(params).backward()
    best, history = optimize(objective, theta, steps=4, learning_rate=mix["learning_rate"],
                             scheduler=sched)
    ref_rays = ref.rays(cfg, per_source, F64, "cpu")
    losses, grad, _ = solve.adam_steps(ref, cfg, theta, ref_rays, mix["learning_rate"],
                                       mix["steps"] if cosine else None, 3, block=1024)
    np.testing.assert_allclose(losses, history[:3], rtol=1e-9)
    for k in theta:
        np.testing.assert_allclose(grad[k].numpy(), params[k].grad.numpy(), rtol=1e-7,
                                   atol=1e-12 * float(grad[k].abs().max()))


def test_frame_rows_equal_the_port_frame():
    """The frame mix: the reference's rows against RayTracer.trace()."""
    from pyrayt_tpu_torch import RayTracer
    from pyrayt_tpu_torch.scene.objects import fresh_ids

    port, ref, cfg = CONFIGS["mla4"]
    theta = _draw(ref, cfg, "frame2p20")
    with fresh_ids():
        system = port.components(cfg, theta)
    tracer = RayTracer(port.sources(cfg), system, rays_per_source=4096,
                       generation_limit=cfg["generation_limit"], device="cpu", dtype=F64)
    program = tracer.trace().to_numpy()

    class Cell:
        pass

    cell = Cell()
    cell.ref, cell.cfg, cell.device = ref, cfg, torch.device("cpu")
    cell.traffic = dict(manifest.traffic("frame2p20"), rays_per_source=4096)
    rows = frame.reference_rows(cell, theta, F64)
    assert program.shape == rows.shape
    assert frame.frame_gaps(program, rows) == {"rows_unmatched": 0.0, "rows_off": 0.0}
    # the frame is float32: rows differ from the float64 reference in rounding only
    np.testing.assert_allclose(program, rows, rtol=1e-6, atol=1e-6)


def test_spot_equals_the_port_metric():
    """The tolerance mix: hits and RMS spot radius of a drawn design."""
    from pyrayt_tpu_torch import RayTracer
    from pyrayt_tpu_torch.analysis.metrics import rms_spot_radius, surface_mask
    from pyrayt_tpu_torch.scene.objects import fresh_ids

    port, ref, cfg = CONFIGS["doublet"]
    theta = _draw(ref, cfg, "tolerance16m")
    with fresh_ids():
        system = port.components(cfg, theta)
    tracer = RayTracer(port.sources(cfg), system, rays_per_source=500,
                       generation_limit=cfg["generation_limit"], device="cpu", dtype=F64)
    result = tracer.trace_device()
    sid = system[-1].get_id()
    th = {k: torch.as_tensor(v) for k, v in theta.items()}
    hits, radius = solve.spot(ref, cfg, th, ref.rays(cfg, 500, F64, "cpu"), block=700)
    assert hits == int(surface_mask(result, sid).sum()) > 0
    assert radius == pytest.approx(float(rms_spot_radius(result, sid)), rel=1e-9)


def test_design_radii_equal_the_example():
    sys.path.insert(0, str(ROOT / "examples_torch"))
    import lens_design

    cfg = CONFIGS["doublet"][2]
    np.testing.assert_allclose(doublet_reference.design_radii(cfg),
                               lens_design.doublet_radii_initial(), rtol=1e-12)


def test_byte_counts_equal_chip_smoke():
    import chip_smoke

    port, ref, cfg = CONFIGS["doublet"]
    result, _ = _port_trace(port, cfg, _draw(ref, cfg, "tolerance16m"), 700)
    records, masks = result.records.float(), result.record_mask
    leaves, glass, kinds = ref.scene_counts(cfg)
    run = roofline.generations_ran(records, masks)
    k3, _, ran, _ = chip_smoke.narrow_bwd_bytes(records, masks, run, leaves, glass, 4)
    assert roofline.backward_bytes(records, masks, leaves, glass, 4) == k3
    assert roofline.ray_generations(records, masks) == ran
    g, n = masks.shape  # chip_smoke.py's K1 count (its kernels line)
    table = 4 * (22 * leaves + 7 * glass) * 2
    assert roofline.forward_bytes(masks, leaves, glass, 4) == 4 * (15 * g * n + 2 * 13 * n) \
        + g * n + table
    assert roofline.bound(1e9, 1e12) == chip_smoke.bound(1e9, 1e12)
    assert roofline.bound(1e6, 1e13) == chip_smoke.bound(1e6, 1e13)

    class Spec:
        leaf_types = (4, 0, 0, 4, 0, 0, 2)  # cylinder, sphere, sphere, ..., plane

    assert roofline.forward_flops(ran, kinds) == ran * chip_smoke.flops_per_ray_generation(
        Spec, backward=False)
    assert roofline.backward_flops(ran, kinds) == ran * chip_smoke.flops_per_ray_generation(
        Spec, backward=True)

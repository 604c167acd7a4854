"""The 32 x 32 freeform microlens array (the benchmark's ``mla32``
configuration: 1,024 lenslets, 2,049 leaves, 1,025 parameters) on the CPU.

The port's normal path, ``build_objective`` and ``optimize`` over the
configuration's build (``benchmark/configs/mla32_port.py``), runs the plain
engine here and is held at float64 to the benchmark's plain reference
(``mla32_reference.py``): the loss at the first two iterates, the gradient
over every parameter and the change after two Adam steps.  Then the wide
box pass's counters and its ``ops.cull`` span, on the route the card takes.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark.configs import (  # noqa: E402
    doublet_port,
    doublet_reference,
    mla16_port,
    mla16_reference,
    mla32_port,
    mla32_reference,
)
from benchmark.harness import manifest  # noqa: E402
from benchmark.reference import solve  # noqa: E402

from pyrayt_tpu_torch.analysis import build_objective, optimize  # noqa: E402
from pyrayt_tpu_torch.config import TraceConfig  # noqa: E402
from pyrayt_tpu_torch.ops import fused_trace as ft  # noqa: E402
from pyrayt_tpu_torch.scene.compile import compile_scene  # noqa: E402
from pyrayt_tpu_torch.scene.objects import fresh_ids  # noqa: E402

F64 = torch.float64
# each configuration's build, reference and design traffic
CONFIGS = {"mla32": (mla32_port, mla32_reference, "design30_2p22"),
           "mla16": (mla16_port, mla16_reference, "design30"),
           "doublet": (doublet_port, doublet_reference, "design300_cosine")}
CFG = manifest.config_numbers("mla32")
MIX = manifest.traffic("design30_2p22")
# a 32 x 32 grid, a ray through each lenslet: every radius takes part in the loss
RAYS = 32 * 32
BETA1 = 0.9  # torch.optim.Adam's default, which optimize() uses
# Both sides compute in float64 from the same numbers; they differ only in
# the order of their sums (the port's plain engine and the reference's own
# tracer), which moves a loss or a gradient by about 1e-16 of itself
# (measured on this test's seed: the losses and the changes equal, the
# gradients 3.3e-16 apart).  The limits leave a millionfold of room for
# that or more; the reference in float32 misses them by 5,000 (loss,
# 5.0e-7) and 39,000 (gradient, 3.9e-4) times, which
# test_a_float32_reference_misses_the_limits holds to at least tenfold.
LOSS_RTOL = 1e-10
GRAD_RTOL = 1e-8  # of each parameter's gradient, or of 1e-3 of the largest
CHANGE_RTOL = 1e-10  # of each parameter's change


def _theta(name="mla32", seed=2**31 + 7):
    _, ref, traffic = CONFIGS[name]
    drawn = ref.theta(manifest.config_numbers(name), manifest.traffic(traffic),
                      np.random.default_rng(seed))
    return {k: torch.as_tensor(v, dtype=F64) for k, v in drawn.items()}


def _objective(name, n_rays):
    """The configuration's ``build_objective`` as the benchmark's optimize
    traffic builds it, on ``n_rays`` rays (a source each) on the CPU."""
    port = CONFIGS[name][0]
    cfg = manifest.config_numbers(name)
    rays = port.rays(cfg, n_rays, "cpu", F64)
    with fresh_ids():
        sid = port.components(cfg, _theta(name))[-1].get_id()
    return build_objective(lambda th: port.components(cfg, th), rays, port.loss(cfg, sid),
                           TraceConfig(generation_limit=cfg["generation_limit"], fixed_loop=True))


def _loss_gap(losses, ref):
    return max(abs(a - b) / abs(b) for a, b in zip(losses, ref))


def _grad_gap(grad, ref):
    """The worst parameter's gap, over its own gradient or 1e-3 of its
    leaf's largest, whichever is larger."""
    return max(float(((grad[k].double() - ref[k]).abs()
                      / torch.clamp(ref[k].abs(), min=1e-3 * float(ref[k].abs().max()))).max())
               for k in ref)


@pytest.fixture(scope="module")
def port_run():
    """Two Adam steps of ``optimize`` at lr 2e-2 on the port's objective:
    the losses, the first gradient (Adam's first moment over 1 - beta1,
    read at the second call) and the parameters' change."""
    theta0 = _theta()
    objective = _objective("mla32", RAYS)
    seen = {}

    def factory(params):
        seen["params"] = params
        seen["opt"] = torch.optim.Adam(params, lr=MIX["learning_rate"])
        return seen["opt"]

    def recorded(theta):
        if "grad" not in seen and seen["opt"].state:
            seen["grad"] = [seen["opt"].state[p]["exp_avg"] / (1 - BETA1) for p in seen["params"]]
        return objective(theta)

    _, history = optimize(recorded, theta0, steps=2, optimizer=factory)
    names = list(theta0)
    grad = dict(zip(names, seen["grad"]))
    change = {k: p.detach() - theta0[k] for k, p in zip(names, seen["params"])}
    return theta0, history, grad, change


@pytest.fixture(scope="module")
def reference_run(port_run):
    theta0 = port_run[0]
    rays = mla32_reference.rays(CFG, RAYS, F64, "cpu")
    losses, grad, theta2 = solve.adam_steps(mla32_reference, CFG, theta0, rays,
                                            MIX["learning_rate"], None, 2, block=RAYS)
    return losses, grad, {k: theta2[k] - theta0[k] for k in theta0}


def test_the_port_equals_the_reference_at_float64(port_run, reference_run):
    theta0, history, grad, change = port_run
    assert grad["radii"].shape == (1024,) and grad["det_x"].shape == ()
    # every lenslet's radius moves the loss, and every parameter moved
    assert bool((reference_run[1]["radii"] != 0).all())
    assert all(bool((c != 0).all()) for c in reference_run[2].values())
    ref_losses, ref_grad, ref_change = reference_run
    loss, g = _loss_gap(history, ref_losses), _grad_gap(grad, ref_grad)
    c = max(float(((change[k] - ref_change[k]).abs() / ref_change[k].abs()).max())
            for k in ref_change)
    assert loss <= LOSS_RTOL, loss
    assert g <= GRAD_RTOL, g
    assert c <= CHANGE_RTOL, c


def test_a_float32_reference_misses_the_limits(port_run):
    """The limits are tight enough to tell a float32 reference: its first
    loss and gradient, against the port's float64."""
    theta0, history, grad, _ = port_run
    rays = mla32_reference.rays(CFG, RAYS, torch.float32, "cpu")
    theta = {k: v.to(torch.float32).requires_grad_(True) for k, v in theta0.items()}
    value, g32 = solve.value_and_grad(mla32_reference, CFG, theta, rays, RAYS)
    loss, gap = _loss_gap([float(value)], history), _grad_gap(g32, grad)
    assert loss > 10 * LOSS_RTOL, loss
    assert gap > 10 * GRAD_RTOL, gap


@pytest.fixture()
def card_route(monkeypatch):
    """The objective takes the route a card takes (on CPU tensors its
    wrappers run their plain versions): K1/K3 for a narrow scene, K2 and
    the staged backward for a wide one."""
    monkeypatch.setattr(ft, "pick_fused", lambda spec, config, device: (
        ft.supports_fused(spec) or ft.supports_fused_wide(spec)))


@pytest.mark.parametrize("name, trees, chunks", [
    ("mla32", 1024, 64),
    ("mla16", 256, 16),
    ("doublet", 0, 0),
])
def test_the_counters_read_the_trees_and_chunks_of_a_step(card_route, name, trees, chunks):
    objective = _objective(name, 64)
    params = {k: v.clone().requires_grad_(True) for k, v in _theta(name).items()}
    before = ft.wide_cull_tables.trees, ft.wide_cull_tables.chunks
    objective(params).backward()
    assert (ft.wide_cull_tables.trees - before[0],
            ft.wide_cull_tables.chunks - before[1]) == (trees, chunks)


def _cull_spans(run):
    """(``ops.cull`` spans, ``ops.tables`` spans) recorded while ``run`` ran
    under the CPU profiler, as (start, end)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run()
    found = {"pyrayt.ops.cull": [], "pyrayt.ops.tables": []}
    for ev in prof.profiler.kineto_results.events():
        if ev.name() in found:
            found[ev.name()].append((ev.start_ns(), ev.start_ns() + ev.duration_ns()))
    return found["pyrayt.ops.cull"], found["pyrayt.ops.tables"]


def test_the_cull_span_opens_once_per_table_build_inside_the_tables_span(monkeypatch):
    with fresh_ids():
        scene = compile_scene(mla32_port.components(CFG, _theta()), device="cpu", dtype=F64)
    build = lambda: ft.wide_cull_tables(scene.spec, scene.params, F64)  # noqa: E731
    cull, tables = _cull_spans(lambda: (build(), build()))
    assert len(cull) == len(tables) == 2
    for (cs, ce), (ts, te) in zip(sorted(cull), sorted(tables)):
        assert ts <= cs and ce <= te

    def refuse(name):
        raise AssertionError(f"record_function({name!r}) with no profiler recording")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    before = ft.wide_cull_tables.trees
    build()
    assert ft.wide_cull_tables.trees == before + 1024

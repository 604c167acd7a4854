"""Rank workers of the port's parallel tests, free of any JAX import.

``World(task, world_size, workdir)`` starts one process per rank
(``python torch_parallel_worlds.py TASK RANK WORLD WORKDIR BACKEND
DEVICE``), each joining a ``torch.distributed`` group through a
``file://`` store in ``workdir`` and running ``TASKS[task](mesh,
inputs)`` on the NumPy inputs the parent saved as ``workdir/inputs.pt``.
Each rank saves what it computed to ``workdir/<task>.rank<r>.pt``; the
parent loads the list (``wait``).  The world has a deadline: past it every rank is
killed and the spawn raises, so a hung collective cannot stall a suite.

The parent (a test process, which imports JAX) computes the JAX package's
references; the ranks import only torch, NumPy and the port.
"""

from __future__ import annotations

import os
import pathlib
import subprocess
import sys
import time

import numpy as np
import torch

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parents[1]

DEADLINE_S = 240.0


class World:
    """One spawned world: ``world_size`` rank processes running ``task``
    (:meth:`wait` collects them)."""

    def __init__(self, task, world_size, workdir, backend="gloo", device="cpu",
                 timeout=DEADLINE_S):
        self.task, self.workdir = task, pathlib.Path(workdir)
        self.deadline = time.monotonic() + timeout
        env = dict(os.environ, OMP_NUM_THREADS="1")
        self.procs, self.logs = [], []
        for rank in range(world_size):
            log = open(self.workdir / f"{task}.rank{rank}.log", "w")
            self.logs.append(log)
            self.procs.append(subprocess.Popen(
                [sys.executable, str(HERE / "torch_parallel_worlds.py"), task, str(rank),
                 str(world_size), str(self.workdir), backend, device],
                stdout=log, stderr=subprocess.STDOUT, env=env, cwd=str(ROOT)))

    def wait(self):
        """Each rank's saved dict, in rank order.  Raises with the ranks'
        logs on a failure or past the deadline (every rank killed)."""
        try:
            for p in self.procs:
                p.wait(timeout=max(self.deadline - time.monotonic(), 0.1))
        except subprocess.TimeoutExpired:
            pass
        finally:
            for p in self.procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
            for log in self.logs:
                log.close()
        failed = [(r, p.returncode) for r, p in enumerate(self.procs) if p.returncode != 0]
        if failed:
            tails = "\n".join(
                f"--- rank {r} (rc {rc}) ---\n"
                + (self.workdir / f"{self.task}.rank{r}.log").read_text()[-3000:]
                for r, rc in failed)
            raise RuntimeError(
                f"world {self.task!r} of {len(self.procs)} ranks failed:\n{tails}")
        return [torch.load(self.workdir / f"{self.task}.rank{r}.pt", weights_only=False)
                for r in range(len(self.procs))]


# ---------------------------------------------------------------------------
# scenes and losses shared with the parent (built with either package's
# builders, ``m`` a namespace as in torch_parity_scenes)
# ---------------------------------------------------------------------------


def lens_system(m):
    """tests/test_parallel/test_sharding.py:24-31: a BK7 thick lens and a
    detector baffle."""
    lens = m.comp.thick_lens(r1=1.0, r2=-1.0, thickness=0.25, aperture=0.5,
                             material=m.matl.glass["BK7"])
    return [lens, m.comp.baffle((1.0, 1.0)).move_x(1.0)]


def mla_system(m, n):
    """tests/test_parallel/test_wide_fused_sharding.py:24-34 and
    test_wide_sharded_trace.py:24-28: an n x n microlens array and a
    detector at its focal plane (4.0)."""
    lenslets = m.comp.microlens_array(2.0, 0.25, n, n, 1.0)
    return lenslets + [m.comp.baffle((2.0 * n, 2.0 * n)).move_x(4.0)]


def rms_spot(result):
    """test_sharding.py:93-97: RMS final position of the rays that left a
    record."""
    y = result.final_rays.positions[1]
    z = result.final_rays.positions[2]
    w = result.record_mask.any(dim=0).to(y.dtype)
    return (w * (y**2 + z**2)).sum() / torch.clamp(w.sum(), min=1.0)


def y_hits_loss(result):
    """test_wide_sharded_trace.py:63-67: the sum of squared record y1 over
    the masked rows."""
    y = result.records[:, 10, :]
    return (torch.where(result.record_mask, y, 0.0) ** 2).sum()


# ---------------------------------------------------------------------------
# tasks: fn(mesh, inputs) -> dict of tensors and numbers
# ---------------------------------------------------------------------------


def ray_arrays(rays):
    """``{"pos", "dirs", "meta"}`` NumPy copies of either package's RaySet."""
    meta = np.stack([np.asarray(getattr(rays, f)) for f in
                     ("generation", "intensity", "wavelength", "index", "id")])
    return {"pos": np.array(rays.positions), "dirs": np.array(rays.directions), "meta": meta}


def _torch_ns():
    sys.path.insert(0, str(HERE))
    from torch_parity_scenes import TORCH_NS

    return TORCH_NS


def port_scene(build, device, dtype=torch.float64):
    m = _torch_ns()
    with m.fresh_ids():
        return m.compile(build(m), device=device, dtype=dtype)


def port_rays(arrays, device, dtype=torch.float64):
    from pyrayt_tpu_torch import interop

    return interop.rays_from_numpy(arrays["pos"], arrays["dirs"], arrays["meta"], device=device,
                                   dtype=dtype)


def _result_dict(result):
    return {"records": result.records.detach().cpu(), "mask": result.record_mask.cpu(),
            "final_positions": result.final_rays.positions.detach().cpu(),
            "generations_run": int(result.generations_run)}


def task_trace(mesh, inputs):
    """The ray-axis sharded trace on a (hosts, rays) mesh: the narrow lens
    system at 64 and 13 rays, the 5x5 microlens array at 256, each
    gathered; the mesh's own layout."""
    from pyrayt_tpu_torch.config import TraceConfig
    from pyrayt_tpu_torch.parallel import default_mesh, pad_rayset, shard_rayset, sharded_trace
    from pyrayt_tpu_torch.parallel.trace import gather_result

    mesh = default_mesh(n_hosts=inputs["n_hosts"], device=mesh.device)
    out = {"shape": mesh.shape, "size": mesh.size, "rank": mesh.rank,
           "hosts_index": mesh.index("hosts"), "rays_index": mesh.index("rays")}
    narrow = port_scene(lens_system, mesh.device)
    for key, gens in (("cond64", 4), ("cond13", 3)):
        config = TraceConfig(generation_limit=gens, fixed_loop=True)
        rays = port_rays(inputs[key], mesh.device)
        local = sharded_trace(narrow, rays, config, mesh)
        out[key] = _result_dict(gather_result(local, mesh))
        out[key + "_local_ids"] = shard_rayset(pad_rayset(rays, mesh.size)[0], mesh).id.cpu()
    wide = port_scene(lambda m: mla_system(m, 5), mesh.device)
    config = TraceConfig(generation_limit=4, fixed_loop=True)
    local = sharded_trace(wide, port_rays(inputs["mla256"], mesh.device), config, mesh)
    out["mla256"] = _result_dict(gather_result(local, mesh))
    return out


def task_train(mesh, inputs):
    """``build_train_step`` on the narrow lens system (two steps of
    ``rms_spot``, one of ``metrics.rms_spot_radius``) and on the 5x5
    microlens array (one step of ``rms_spot_radius(det_id)``)."""
    from pyrayt_tpu_torch.analysis import metrics
    from pyrayt_tpu_torch.config import TraceConfig
    from pyrayt_tpu_torch.parallel import build_train_step, pad_rayset, shard_rayset

    def local_rays(key):
        return shard_rayset(pad_rayset(port_rays(inputs[key], mesh.device), mesh.size)[0], mesh)

    def cpu(params):
        return {k: v.cpu() for k, v in params.items()}

    config = TraceConfig(generation_limit=4, fixed_loop=True)
    out = {}
    narrow = port_scene(lens_system, mesh.device)
    rays = local_rays("cond64")
    step = build_train_step(narrow, config, mesh, rms_spot, learning_rate=1e-2)
    params1, loss1 = step(narrow.params, rays)
    params2, loss2 = step(params1, rays)
    out["rms_spot"] = {"params1": cpu(params1), "loss1": float(loss1),
                       "params2": cpu(params2), "loss2": float(loss2)}
    step = build_train_step(narrow, config, mesh, metrics.rms_spot_radius, learning_rate=1e-2)
    params, loss = step(narrow.params, rays)
    out["rms_spot_radius"] = {"params": cpu(params), "loss": float(loss)}

    wide = port_scene(lambda m: mla_system(m, 5), mesh.device)
    det_id = float(wide.spec.leaf_ids[-1])
    step = build_train_step(wide, config, mesh, lambda r: metrics.rms_spot_radius(r, det_id),
                            learning_rate=1e-2)
    params, loss = step(wide.params, local_rays("mla256"))
    out["mla_rms_spot_radius"] = {"params": cpu(params), "loss": float(loss)}
    return out


def task_surfaces(mesh, inputs):
    """The surface axis over two ranks: the sphere-grid fold (16 leaves;
    9 padded to 16; 8 coincident spheres), the wide sharded trace of the
    4x4 microlens array with its gradient, and both ValueError cases."""
    from pyrayt_tpu_torch.config import TraceConfig
    from pyrayt_tpu_torch.core import primitives as prim
    from pyrayt_tpu_torch.parallel import (
        build_surface_sharded_nearest_hit,
        build_wide_sharded_trace_fn,
        pad_leaf_tables,
    )
    from pyrayt_tpu_torch.parallel.mesh import Mesh

    mesh = Mesh({"surfaces": mesh.size}, mesh.device)
    dev = mesh.device

    def t(x):
        return torch.as_tensor(x, dtype=torch.float64, device=dev)

    fn = build_surface_sharded_nearest_hit(prim.SPHERE, mesh)
    out = {}
    for key in ("grid16", "grid9", "ties"):
        world, params, rays = (t(inputs[key][k]) for k in ("world", "params", "rays"))
        if key == "grid9":
            world, params, _ = pad_leaf_tables(world, params, 8)
        d, leaf = fn(world, params, rays)
        out[key] = {"dist": d.cpu(), "leaf": leaf.cpu()}

    scene = port_scene(lambda m: mla_system(m, 4), dev)
    config = TraceConfig(generation_limit=4, fixed_loop=True)
    fn = build_wide_sharded_trace_fn(scene, config, mesh)
    result = fn(scene.params, port_rays(inputs["mla512"], dev))
    out["mla512"] = _result_dict(result)
    config = TraceConfig(generation_limit=3, fixed_loop=True)
    fn = build_wide_sharded_trace_fn(scene, config, mesh)
    for key in ("mla128", "mla_random128"):
        params = {k: v.detach().requires_grad_(True) for k, v in scene.params.items()}
        loss = y_hits_loss(fn(params, port_rays(inputs[key], dev)))
        loss.backward()
        out[key + "_grad"] = {"loss": float(loss),
                              **{k: v.grad.cpu() for k, v in params.items()}}

    errors = {}
    for label, build in (("indivisible", lambda m: mla_system(m, 3)), ("narrow", lens_system)):
        try:
            build_wide_sharded_trace_fn(port_scene(build, dev), config, mesh)
        except ValueError as e:
            errors[label] = str(e)
    out["errors"] = errors
    return out


# ---------------------------------------------------------------------------
# the padded-ray contract (pad_rayset's dead rays through every route)
# ---------------------------------------------------------------------------

KERNEL_COUNTERS = ("fused_trace", "fused_trace_wide", "fused_bwd", "staged_tail", "staged_group",
                   "staged_singles", "fused_bwd_wide")


def launch_counts():
    """Every launch counter of the trace and train-step routes."""
    from pyrayt_tpu_torch.ops import fused_grad as fg
    from pyrayt_tpu_torch.ops import fused_trace as ft

    return {name: getattr(ft if hasattr(ft, name) else fg, name).launches
            for name in KERNEL_COUNTERS}


def padded_ray_contract(route, device, dtype=torch.float64, n=61, multiple=64):
    """Trace ``n`` rays padded to ``multiple`` (``pad_rayset``) through the
    route's autograd Function (``ops.fused_grad.build_fused_vjp_trace_fn``:
    on CUDA tensors "narrow" runs K1 + K4, "staged" K2 + K5/K6/K7, "fused"
    K2 + K8; on CPU tensors their plain versions) and backward from a loss
    of the masked records and of the final positions of rays that left a
    record, as the train step's losses are.  Returns the padded rays'
    records, masks and cotangents, and the parameter gradients beside
    those of the same trace without the padding."""
    sys.path.insert(0, str(HERE))
    from torch_parity_scenes import grid_rays, numpy_rays

    from pyrayt_tpu_torch.config import TraceConfig
    from pyrayt_tpu_torch.ops import fused_grad as fg
    from pyrayt_tpu_torch.parallel import pad_rayset

    if route == "narrow":
        scene = port_scene(lens_system, device, dtype)
        arrays = dict(zip(("pos", "dirs", "meta"), numpy_rays((-0.5, 0.0, 0.0), 10.0, n)))
    else:
        scene = port_scene(lambda m: mla_system(m, 5), device, dtype)
        arrays = dict(zip(("pos", "dirs", "meta"), grid_rays(4.5, 4.5, -1.0, n)))
    config = TraceConfig(generation_limit=4, fixed_loop=True,
                         wide_grad="fused" if route == "fused" else None)
    assert fg.wide_grad_mode(scene.spec, config) == route
    fn = fg.build_fused_vjp_trace_fn(scene.spec, scene.materials, config)
    gen = torch.Generator().manual_seed(0)
    weights = torch.rand((config.generation_limit, 15, n), generator=gen, dtype=dtype)

    def run(rays):
        params = {k: v.detach().requires_grad_(True) for k, v in scene.params.items()}
        rays = rays.replace(positions=rays.positions.detach().requires_grad_(True),
                            directions=rays.directions.detach().requires_grad_(True))
        result = fn(params, rays)
        k = rays.n_rays
        w = torch.nn.functional.pad(weights, (0, k - n)).to(device)
        mask = result.record_mask
        final = result.final_rays.positions[:3] * mask.any(dim=0).to(dtype)
        loss = (result.records * w * mask[:, None]).sum() + (final ** 2).sum()
        loss.backward()
        return result, {k_: v.grad for k_, v in params.items()}, rays

    rays = port_rays(arrays, device, dtype)
    padded, n_valid = pad_rayset(rays, multiple)
    result, grads, leaves = run(padded)
    _, plain_grads, _ = run(rays)
    pad = slice(n_valid, None)
    return {
        "n_padded": padded.n_rays - n_valid,
        "pad_records": result.records[..., pad].detach().cpu(),
        "pad_masks": result.record_mask[:, pad].cpu(),
        "pad_d_positions": leaves.positions.grad[:, pad].cpu(),
        "pad_d_directions": leaves.directions.grad[:, pad].cpu(),
        "valid_masks": int(result.record_mask[:, :n_valid].sum()),
        "grads": {k: v.cpu() for k, v in grads.items()},
        "unpadded_grads": {k: v.cpu() for k, v in plain_grads.items()},
    }


def task_card_trace(mesh, inputs):
    """Each rank's K1 (the lens system) and K2 (the 5x5 array) on the
    card, float64 and float32: the gathered result against one launch
    over every (padded) ray, and the kernels each rank launched."""
    from pyrayt_tpu_torch.config import TraceConfig
    from pyrayt_tpu_torch.parallel import default_mesh, pad_rayset, sharded_trace
    from pyrayt_tpu_torch.parallel.trace import gather_result
    from pyrayt_tpu_torch.tracer import engine

    ray_mesh = default_mesh(device=mesh.device)
    out = {}
    for key, build, gens in (("narrow", lens_system, 6), ("wide", lambda m: mla_system(m, 5), 4)):
        for dtype in (torch.float64, torch.float32):
            scene = port_scene(build, mesh.device, dtype)
            rays = port_rays(inputs[key], mesh.device, dtype)
            config = TraceConfig(generation_limit=gens)
            before = launch_counts()
            got = gather_result(sharded_trace(scene, rays, config, ray_mesh), mesh)
            after = launch_counts()
            ref = engine.trace_rays(scene, pad_rayset(rays, mesh.size)[0], config)
            out[f"{key}_{str(dtype)[6:]}"] = {
                "launched": {k: after[k] - before[k] for k in after},
                "equal": bool(torch.equal(got.record_mask, ref.record_mask)
                              and torch.equal(got.records, ref.records)
                              and torch.equal(got.final_rays.positions, ref.final_rays.positions)
                              and int(got.generations_run) == int(ref.generations_run)),
                "records": int(ref.record_mask.sum()),
            }
    return out


TASKS = {"trace": task_trace, "train": task_train, "surfaces": task_surfaces,
         "card_trace": task_card_trace}


def main(argv):
    task, rank, world, workdir, backend, device = argv
    sys.path.insert(0, str(ROOT))
    torch.set_num_threads(1)
    from pyrayt_tpu_torch.parallel import initialize_distributed
    from pyrayt_tpu_torch.parallel.mesh import Mesh

    workdir = pathlib.Path(workdir)
    initialize_distributed(f"file://{workdir / (task + '.store')}", int(world), int(rank),
                           initialization_timeout=60, backend=backend)
    inputs = torch.load(workdir / "inputs.pt", weights_only=False)
    out = TASKS[task](Mesh({"ranks": int(world)}, device), inputs)
    if "jax" in sys.modules or "pyrayt_tpu" in sys.modules:
        raise RuntimeError("a rank imported jax or pyrayt_tpu")
    torch.save(out, workdir / f"{task}.rank{rank}.pt")
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1:])

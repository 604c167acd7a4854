"""The narrow forward kernel's plain version, scene program and dispatch.

``fused_trace_plain`` (what the CUDA kernel is held against on the card)
must reproduce the JAX package's XLA engine at float64 on five scenes:
masks exactly, masked records and final rays within rtol = atol = 1e-9.
The scene program the kernel interprets is checked here by interpreting
it in Python, ray by ray, exactly as csrc/fused_trace.cu does.  The kernel
itself runs only on a CUDA device (test_torch_cuda.py).
"""

import math

import numpy as np
import pytest
import torch

from pyrayt_tpu.config import TraceConfig as JConfig
from pyrayt_tpu.tracer import engine as j_engine
from pyrayt_tpu_torch import materials as t_matl
from pyrayt_tpu_torch.config import TraceConfig
from pyrayt_tpu_torch.ops import fused_trace as ft
from pyrayt_tpu_torch.tracer import engine

SCENES = ["condenser", "all_primitives", "prism_tir", "mirrors", "union"]
TOL = dict(rtol=1e-9, atol=1e-9)
FINAL_FIELDS = ("positions", "directions", "generation", "intensity", "index")


def assert_matches_jax(result, j_result):
    mask = result.record_mask.numpy()
    j_mask = np.asarray(j_result.record_mask)
    np.testing.assert_array_equal(mask, j_mask)
    assert int(result.generations_run) == int(j_result.generations_run)
    np.testing.assert_allclose(
        result.records.numpy() * mask[:, None], np.asarray(j_result.records) * j_mask[:, None],
        **TOL,
    )
    for field in FINAL_FIELDS:
        np.testing.assert_allclose(
            getattr(result.final_rays, field).numpy(),
            np.asarray(getattr(j_result.final_rays, field)),
            err_msg=f"final_rays.{field}",
            **TOL,
        )


@pytest.mark.parametrize("name", SCENES)
def test_plain_kernel_matches_jax_engine(twins, name):
    j_scene, t_scene, j_rays, t_rays, gens = twins.inputs(name)
    j_cfg = JConfig(generation_limit=gens, fixed_loop=True)
    j_res = j_engine.build_trace_fn(j_scene.spec, j_scene.materials, j_cfg)(
        j_scene.params, j_rays
    )
    fn = ft.build_fused_trace_fn(
        t_scene.spec, t_scene.materials, TraceConfig(generation_limit=gens)
    )
    before = ft.fused_trace.launches
    result = fn(t_scene.params, t_rays)  # CPU tensors: the wrapper runs the plain version
    assert ft.fused_trace.launches == before
    assert_matches_jax(result, j_res)
    assert result.record_mask.dtype == torch.bool
    assert result.record_mask.any()


def test_records_of_generations_not_run_are_zero(twins):
    _, t_scene, _, t_rays, gens = twins.inputs("condenser")
    config = TraceConfig(generation_limit=gens)
    records, masks, fstate = ft.fused_trace_plain(
        t_scene.spec, config, *ft.kernel_inputs(t_scene.params, t_rays)
    )
    # a ray that was dead after generation g - 1 does not run generation g
    for g in range(1, gens):
        assert (records[g][:, ~masks[g - 1]] == 0).all()
    assert masks[:3].any() and not masks[4:].any()
    assert (records[4:] == 0).all()
    np.testing.assert_array_equal(fstate[3].numpy(), 1.0)
    np.testing.assert_array_equal(fstate[7].numpy(), 0.0)


# ---------------------------------------------------------------------------
# the scene program, interpreted the way the kernel interprets it
# ---------------------------------------------------------------------------


def _net_combine(keys, ids, op, m1, m2, pairs):
    m = m1 + m2
    signs = []
    for r in range(m):
        even = (r if r < m1 else r - m1) % 2 == 0
        subtracted = op == 3 and r >= m1
        signs.append(1 if even != subtracted else -1)

    def network(keys, ids, signs):
        rank = list(range(m))
        for a, b in pairs:
            if keys[b] < keys[a] or (keys[b] == keys[a] and rank[b] < rank[a]):
                for lst in (keys, rank, ids) + ((signs,) if signs else ()):
                    lst[a], lst[b] = lst[b], lst[a]

    network(keys, ids, signs)
    counts = list(np.cumsum(signs) + (1 if op == 3 else 0))
    keep = [
        ((counts[r] != 0) != (counts[r - 1] != 0)) if op == 1
        else (counts[r] == 2 or counts[r - 1] == 2)
        for r in range(m)
    ]
    for r in range(m):
        if not keep[r]:
            keys[r] = math.inf
    network(keys, ids, None)


def interpret_program(program, pair_of):
    """Nearest positive hit ``(distance, leaf)`` of one ray; ``pair_of(s)``
    is leaf s's sorted (entry, exit) pair."""
    s_leaves, n_mats, n_instr, pairs_off = (int(v) for v in program[:4])
    start = 4 + 5 * s_leaves + n_mats
    instrs = program[start : start + 6 * n_instr].reshape(n_instr, 6)
    all_pairs = program[pairs_off:].reshape(-1, 2)
    best, leaf = math.inf, -1
    ivs, keys, ids = [], [], []

    def fold(cand, i):
        nonlocal best, leaf
        cand = cand if cand > 0 else math.inf
        if cand < best:
            best, leaf = cand, i

    for op, a, b, c, d, e in instrs.tolist():
        if op == ft.IV_LOAD:
            lo, hi = pair_of(a)
            ivs = [(lo, hi, a, a)]
        elif op == ft.IV_AND:
            b0, b1 = pair_of(a)
            new = []
            for a0, a1, i0, i1 in ivs:
                lo, hi = max(a0, b0), min(a1, b1)
                lid, hid = (a if b0 > a0 else i0), (a if b1 < a1 else i1)
                new.append((math.inf, math.inf, lid, hid) if lo > hi else (lo, hi, lid, hid))
            ivs = new
        elif op == ft.IV_SUB:
            b0, b1 = pair_of(a)
            new = []
            for a0, a1, i0, i1 in ivs:
                p1_hi, p1_id = min(a1, b0), (a if b0 < a1 else i1)
                p2_lo, p2_id = max(a0, b1), (a if b1 > a0 else i0)
                e1, e2 = a0 > p1_hi, p2_lo > a1
                new.append((math.inf, math.inf, i0, p1_id) if e1 else (a0, p1_hi, i0, p1_id))
                new.append((math.inf, math.inf, p2_id, i1) if e2 else (p2_lo, a1, p2_id, i1))
            ivs = new
        elif op == ft.IV_FOLD:
            for lo, hi, lid, hid in ivs:
                fold(lo, lid)
                fold(hi, hid)
        elif op == ft.NET_PUSH:
            lo, hi = pair_of(a)
            keys += [lo, hi]
            ids += [a, a]
        elif op == ft.NET_COMBINE:
            m = b + c
            k_top, i_top = keys[-m:], ids[-m:]
            _net_combine(k_top, i_top, a, b, c, [tuple(p) for p in all_pairs[d : d + e]])
            keys[-m:], ids[-m:] = k_top, i_top
        else:
            for k, i in zip(keys, ids):
                fold(k, i)
            keys, ids = [], []
    return best, leaf


@pytest.mark.parametrize("name", SCENES)
def test_scene_program_reproduces_nearest_hit(twins, name):
    _, t_scene, _, t_rays, _ = twins.inputs(name, seed=11)
    spec = t_scene.spec
    tables = engine.scene_tables(t_scene.params)
    rays = t_rays.rays
    pairs = {
        s: engine._sorted_pair(
            engine.prim.leaf_intersect(
                spec.leaf_types[s], engine._local_xyz_rays(tables["obj_tx"][s], rays),
                tables["prim"][s],
            )
        ).numpy()
        for s in range(spec.n_leaves)
    }
    dist, leaf = engine.scene_nearest_hit(spec, tables, rays)
    program = ft.scene_program(spec)
    for i in range(rays.shape[-1]):
        d_i, l_i = interpret_program(program, lambda s: (pairs[s][0, i], pairs[s][1, i]))
        assert l_i == int(leaf[i]) and (d_i == float(dist[i])), (i, d_i, l_i)


def test_scene_program_layout(twins):
    _, cond = twins.scene("condenser")
    prog = ft.scene_program(cond.spec)
    s, m, k, off = prog[:4]
    assert (s, m) == (4, 2) and off == len(prog)  # interval trees only: no pairs
    ops = prog[4 + 5 * s + m : 4 + 5 * s + m + 6 * k].reshape(k, 6)[:, 0].tolist()
    # the biconvex lens is cylinder ∩ sphere ∩ sphere; the baffle one leaf
    assert ops == [ft.IV_LOAD, ft.IV_AND, ft.IV_AND, ft.IV_FOLD, ft.IV_LOAD, ft.IV_FOLD]
    leaf_rows = prog[4 : 4 + 5 * s].reshape(s, 5)
    assert leaf_rows[:, 4].tolist() == list(cond.spec.leaf_ids)
    assert leaf_rows[:, 3].tolist() == [1, 1, 1, 0]  # the baffle absorbs: no normal
    _, union = twins.scene("union")
    ops = ft.scene_program(union.spec)[4 + 5 * 3 + 2 :][::6][:4].tolist()
    assert ops == [ft.NET_PUSH, ft.NET_PUSH, ft.NET_COMBINE, ft.NET_FOLD]


def test_device_program_is_cached_per_spec_and_device(twins):
    """K1, K3 and K4 read the scene program from one device tensor per
    (spec, device): a later call, or a rebuilt scene of the same structure
    (a training step), makes no host-to-device copy."""
    _, cond = twins.scene("condenser")
    _, again = twins.scene("condenser")  # rebuilt: an equal, distinct spec
    assert again.spec is not cond.spec and again.spec == cond.spec
    cpu = torch.device("cpu")
    program = ft.device_program(cond.spec, cpu)
    assert ft.device_program(cond.spec, cpu) is program
    assert ft.device_program(again.spec, cpu) is program
    assert program.dtype == torch.int32
    np.testing.assert_array_equal(program.numpy(), ft.scene_program(cond.spec))
    _, union = twins.scene("union")
    assert ft.device_program(union.spec, cpu) is not program


def test_scene_program_capacity_is_checked(twins):
    from pyrayt_tpu_torch.scene.compile import compile_scene
    from pyrayt_tpu_torch.scene.surfaces import Cuboid, Sphere
    from pyrayt_tpu_torch.scene.csg import difference, union

    solid = Cuboid(material=t_matl.mirror)
    for k in range(5):  # 2**5 intervals > 16
        solid = difference(solid, Sphere(0.1, material=t_matl.mirror).move_x(0.3 * k))
    with pytest.raises(ValueError, match="intervals"):
        ft.scene_program(compile_scene([solid], device="cpu").spec)
    blob = Sphere(1.0, material=t_matl.mirror)
    for k in range(8):  # 18 event rows > 16
        blob = union(blob, Sphere(1.0, material=t_matl.mirror).move_x(k + 1.0))
    with pytest.raises(ValueError, match="event rows"):
        ft.scene_program(compile_scene([blob], device="cpu").spec)


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------


def test_dispatch_rules(twins):
    _, t_scene = twins.scene("condenser")
    spec = t_scene.spec
    assert not ft.pick_fused(spec, TraceConfig(), "cpu")
    assert ft.pick_fused(spec, TraceConfig(), "cuda")
    assert not ft.pick_fused(spec, TraceConfig(use_fused=False), "cuda")
    with pytest.raises(ValueError, match="CUDA tensors"):
        ft.pick_fused(spec, TraceConfig(use_fused=True), "cpu")


def test_custom_material_takes_the_plain_engine():
    from pyrayt_tpu_torch import components as comp
    from pyrayt_tpu_torch.scene.compile import compile_scene

    class Weird(t_matl.TracableMaterial):
        kind = t_matl.KIND_GLASS

        def trace(self, surface, ray_set):
            return ray_set

        def pure_trace(self, directions, normals, wavelength, index, intensity):
            return directions, index, intensity

    lens = comp.thick_lens(1.0, -1.0, 0.25, aperture=0.5, material=Weird())
    spec = compile_scene([lens], device="cpu").spec
    assert not ft.supports_fused(spec)
    assert not ft.pick_fused(spec, TraceConfig(), "cuda")
    with pytest.raises(ValueError, match="non-packed"):
        ft.pick_fused(spec, TraceConfig(use_fused=True), "cuda")
    with pytest.raises(ValueError, match="non-packed"):
        ft.scene_program(spec)


def test_wide_scenes_raise_not_implemented():
    """Wide scenes no longer raise: a 40-leaf array takes the wide kernel K2
    on CUDA tensors and the plain engine on the CPU; only ``use_fused=True``
    off the card raises."""
    from pyrayt_tpu_torch import components as comp
    from pyrayt_tpu_torch.scene.compile import compile_scene

    spec = compile_scene(comp.microlens_array(1.0, 0.2, 5, 4, 0.5), device="cpu").spec  # 40 leaves
    assert spec.n_leaves == 40 and ft.supports_fused_wide(spec)
    assert not ft.pick_fused(spec, TraceConfig(use_fused=False), "cpu")
    assert not ft.pick_fused(spec, TraceConfig(), "cpu")
    assert ft.pick_fused(spec, TraceConfig(), "cuda")
    with pytest.raises(ValueError, match="CUDA"):
        ft.pick_fused(spec, TraceConfig(use_fused=True), "cpu")
    assert callable(engine.build_trace_fn(spec, (), TraceConfig()))
    assert callable(ft.build_fused_trace_fn(spec, (), TraceConfig()))

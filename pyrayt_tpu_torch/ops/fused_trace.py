"""The narrow forward trace kernel (K1) on CUDA, its wrapper and its plain
PyTorch version.

The kernel (``csrc/fused_trace.cu``) replaces the Pallas kernel built by
``pyrayt_tpu/ops/fused_trace.py:_make_step`` and driven by
``_run_while_kernel``: the whole bounce loop of a narrow scene (at most 32
leaf surfaces, packed materials only) in one launch, one thread per ray.
The scene is runtime data: a host-side "scene program" built once per
``SceneSpec`` (:func:`scene_program`) lists the leaves and, per tree, the
interval ops or the comparator-network steps, so one build of the kernel
serves every scene and moving a lens never rebuilds it.

Three functions share one signature ``(spec, config, state, obj_tx, prim,
glass) -> (records (G, 15, n), masks (G, n) bool, final state (13, n))``:

* :func:`fused_trace` — the wrapper: CUDA tensors launch the kernel (or
  raise); CPU tensors run the plain version;
* :func:`fused_trace_plain` — the plain version, built on the plain
  engine's generation step (tracer/engine.py);
* the kernel itself, reached only through the wrapper.

Contract, shared by both versions (the per-ray exit):

* a ray runs generation g when it was alive after generation g-1 (every
  ray runs generation 0); it stops after the generation in which it died
  or was absorbed (its new direction is zero);
* masks, masked records, the final state and ``generations_run`` equal
  those of the JAX engine, whose loop instead steps every ray until all
  are dead; unmasked record rows of generations a ray did not run are
  zero, and a stopped ray keeps its state;
* a global loop keeps stepping dead rays, so the final state differs
  where a dead ray still moves: with ``apply_intensity_threshold=True`` a
  threshold-killed ray keeps advancing there, and a zero-direction ray
  inside a glass paraboloid's volume "hits" it and refracts to a nonzero
  direction.  Here both keep their last state.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from functools import lru_cache
from pathlib import Path

import numpy as np
import torch

from pyrayt_tpu_torch import materials as matl
from pyrayt_tpu_torch.config import TraceConfig
from pyrayt_tpu_torch.core.intervals import tree_supports_intervals
from pyrayt_tpu_torch.core.operations import _sum_rows, affine_inverse
from pyrayt_tpu_torch.ops.sortnet import batcher_pairs
from pyrayt_tpu_torch.scene.compile import LEAF, OP_BY_NAME, SceneSpec
from pyrayt_tpu_torch.tracer import engine
from pyrayt_tpu_torch.tracer.rayset import RaySet

__all__ = [
    "supports_fused",
    "pick_fused",
    "scene_program",
    "build_kernels",
    "KERNEL_SOURCES",
    "fused_trace",
    "fused_trace_plain",
    "kernel_inputs",
    "build_fused_trace_fn",
]

_PACKED_KINDS = (matl.KIND_ABSORB, matl.KIND_MIRROR, matl.KIND_GLASS)

# capacities of the kernel's per-thread CSG lists; keep equal to
# kMaxIntervals / kMaxRows in csrc/fused_trace.cu
MAX_INTERVALS = 16
MAX_NET_ROWS = 16

# scene-program opcodes; keep equal to the Opcode enum in csrc/fused_trace.cu
IV_LOAD, IV_AND, IV_SUB, IV_FOLD, NET_PUSH, NET_COMBINE, NET_FOLD = range(7)

_CSRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
# one shared library per kernel source; every source includes the header
KERNEL_SOURCES = ("fused_trace.cu", "fused_grad.cu")
_HEADERS = ("trace_common.cuh",)
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"


def supports_fused(spec: SceneSpec) -> bool:
    """The kernel covers narrow scenes whose materials are all packed
    (absorber / mirror / glass); custom Python materials run the plain
    engine, as in the JAX package."""
    return (
        0 < spec.n_leaves <= engine.MAX_NARROW_LEAVES
        and all(spec.mat_packed)
        and all(k in _PACKED_KINDS for k in spec.mat_kinds)
    )


def pick_fused(spec: SceneSpec, config: TraceConfig, device) -> bool:
    """The kernel-vs-plain dispatch rule of ``trace_rays`` and
    ``analysis.build_objective``.

    ``use_fused=None`` picks the kernels for CUDA tensors when the scene is
    supported; ``True`` demands them and raises for an unsupported scene or
    for tensors that are not on a CUDA device; ``False`` never picks them.
    Scenes past 32 leaves raise in every mode (wide engine not ported).
    The backward kernels (K3/K4) cover every scene the forward kernel
    covers, so one rule serves the trace and the gradient (the TPU rule's
    VMEM budgets have no counterpart here).
    """
    engine.check_narrow(spec)
    device = torch.device(device)
    use = config.use_fused
    supported = supports_fused(spec)
    if use is True:
        if not supported:
            raise ValueError(
                "use_fused=True, but the scene has non-packed materials or no leaves"
            )
        if device.type != "cuda":
            raise ValueError(f"use_fused=True needs CUDA tensors, got device {device}")
        return True
    return use is None and supported and device.type == "cuda"


# ---------------------------------------------------------------------------
# the scene program
# ---------------------------------------------------------------------------


def _interval_chain(tree):
    """Left-deep interval tree -> [(opcode, leaf slot), ...]."""
    if tree[0] == LEAF:
        return [(IV_LOAD, tree[1])]
    op_name, l_tree, r_tree = tree
    op = IV_AND if op_name == "intersect" else IV_SUB
    return _interval_chain(l_tree) + [(op, r_tree[1])]


@lru_cache(maxsize=64)
def scene_program(spec: SceneSpec) -> np.ndarray:
    """The int32 scene program the kernel interprets.

    Layout: header ``[n_leaves, n_mats, n_instr, pairs_offset]``; per leaf
    ``[type, mat_slot, normal_scale, needs_normal, public_id]``; per
    material slot its kind; ``n_instr`` instructions of 6 ints
    ``[opcode, a, b, c, d, e]``; then the comparator pairs.  Trees emit in
    scene order.  An interval tree is ``IV_LOAD leaf, (IV_AND|IV_SUB
    leaf)..., IV_FOLD``; a general tree is its postfix walk ``NET_PUSH
    leaf`` / ``NET_COMBINE op m1 m2 pair_offset n_pairs``, then
    ``NET_FOLD``.  Raises ValueError when a tree exceeds the kernel's list
    capacities.
    """
    if not supports_fused(spec):
        raise ValueError("scene has non-packed materials or no leaves; use the plain engine")
    instrs = []
    pairs = []
    pair_offset_of = {}

    def pair_table(m):
        if m not in pair_offset_of:
            pair_offset_of[m] = len(pairs) // 2
            for i, j in batcher_pairs(m):
                pairs.extend((i, j))
        return pair_offset_of[m], len(batcher_pairs(m))

    def emit_network(tree):
        if tree[0] == LEAF:
            instrs.append((NET_PUSH, tree[1], 0, 0, 0, 0))
            return 2
        op_name, l_tree, r_tree = tree
        m1 = emit_network(l_tree)
        m2 = emit_network(r_tree)
        offset, count = pair_table(m1 + m2)
        instrs.append((NET_COMBINE, OP_BY_NAME[op_name].value, m1, m2, offset, count))
        return m1 + m2

    for tree in spec.trees:
        if tree_supports_intervals(tree):
            chain = _interval_chain(tree)
            n_iv = 2 ** sum(op == IV_SUB for op, _ in chain)
            if n_iv > MAX_INTERVALS:
                raise ValueError(
                    f"an interval tree yields {n_iv} intervals; the kernel holds "
                    f"{MAX_INTERVALS}"
                )
            instrs.extend((op, slot, 0, 0, 0, 0) for op, slot in chain)
            instrs.append((IV_FOLD, 0, 0, 0, 0, 0))
        else:
            rows = emit_network(tree)
            if rows > MAX_NET_ROWS:
                raise ValueError(
                    f"a CSG tree yields {rows} event rows; the kernel holds {MAX_NET_ROWS}"
                )
            instrs.append((NET_FOLD, 0, 0, 0, 0, 0))

    leaves = []
    for s in range(spec.n_leaves):
        leaves.extend(
            (
                spec.leaf_types[s],
                spec.leaf_mat_slot[s],
                spec.leaf_normal_scale[s],
                int(engine.leaf_needs_normal(spec, s)),
                spec.leaf_ids[s],
            )
        )
    body = leaves + list(spec.mat_kinds) + [v for ins in instrs for v in ins]
    header = [spec.n_leaves, len(spec.mat_kinds), len(instrs), 4 + len(body)]
    program = np.asarray(header + body + pairs, dtype=np.int64)
    if program.max() >= 2**31:
        raise ValueError("surface ids past int32 cannot be encoded")
    return program.astype(np.int32)


# ---------------------------------------------------------------------------
# build and bind
# ---------------------------------------------------------------------------


def _nvcc() -> str:
    for candidate in (
        os.environ.get("CUDA_HOME") and os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"),
        shutil.which("nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ):
        if candidate and os.path.exists(candidate):
            return candidate
    raise RuntimeError("nvcc not found: the CUDA kernels are built with the CUDA toolkit")


def _build_one(name: str, digest: str):
    """Start nvcc on one source; returns ``(lib_path, process or None, tmp)``."""
    lib_path = _BUILD_DIR / f"libpyrayt_{Path(name).stem}_{digest}.so"
    if lib_path.exists():
        return lib_path, None, None
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
    os.close(fd)
    cmd = [
        _nvcc(),
        "-gencode", "arch=compute_90a,code=sm_90a",
        "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
        "-Xptxas", "-v",
        "-o", tmp, str(_CSRC_DIR / name),
    ]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return lib_path, proc, tmp


@lru_cache(maxsize=None)
def build_kernels():
    """Compile every source of ``KERNEL_SOURCES`` for sm_90a into
    ``build/torch_kernels`` (once per version of the sources and the shared
    header), one nvcc process per source, all started together.  Returns
    ``{source stem: (library path, seconds, compiler log)}``; raises if a
    build fails."""
    header = b"".join((_CSRC_DIR / h).read_bytes() for h in _HEADERS)
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    start = time.perf_counter()
    started = {}
    for name in KERNEL_SOURCES:
        digest = hashlib.sha256(header + (_CSRC_DIR / name).read_bytes()).hexdigest()[:16]
        started[name] = _build_one(name, digest)
    built = {}
    failures = []
    for name, (lib_path, proc, tmp) in started.items():
        if proc is None:
            built[Path(name).stem] = (str(lib_path), 0.0, "cached")
            continue
        log, _ = proc.communicate()
        seconds = time.perf_counter() - start
        if proc.returncode != 0:
            os.unlink(tmp)
            failures.append(f"nvcc failed on {name} ({proc.returncode}):\n{log}")
            continue
        os.replace(tmp, lib_path)
        built[Path(name).stem] = (str(lib_path), seconds, log)
    if failures:
        raise RuntimeError("\n".join(failures))
    return built


@lru_cache(maxsize=None)
def _library():
    lib = ctypes.CDLL(build_kernels()["fused_trace"][0])
    args = (
        [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int]  # state, n, generations
        + [ctypes.c_void_p] * 4  # obj_tx, prim, glass, program
        + [ctypes.c_int] * 3  # program_len, n_leaves, n_glass
        + [ctypes.c_void_p] * 3  # records, masks, final state
        + [ctypes.c_double] * 3  # ray_offset, world_index, intensity_threshold
        + [ctypes.c_int, ctypes.c_void_p]  # apply_threshold, stream
    )
    for name in ("pyrayt_fused_trace_f32", "pyrayt_fused_trace_f64"):
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = ctypes.c_int
    lib.pyrayt_error_string.argtypes = [ctypes.c_int]
    lib.pyrayt_error_string.restype = ctypes.c_char_p
    return lib


@lru_cache(maxsize=64)
def device_program(spec: SceneSpec, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(scene_program(spec), device=device)


# ---------------------------------------------------------------------------
# the wrapper and its plain version
# ---------------------------------------------------------------------------


def check_inputs(spec, state, obj_tx, prim, glass):
    tensors = {"state": state, "obj_tx": obj_tx, "prim": prim, "glass": glass}
    for name, t in tensors.items():
        if t.device != state.device or t.dtype != state.dtype:
            raise ValueError(f"{name} must be {state.dtype} on {state.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if state.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"the kernel runs float32 or float64, got {state.dtype}")
    s = spec.n_leaves
    shapes = (
        (state, (13, state.shape[-1])),
        (obj_tx, (s, 16)),
        (prim, (s, 6)),
        (glass, (len(spec.mat_kinds), matl.N_GLASS_COEFFS)),
    )
    for t, shape in shapes:
        if tuple(t.shape) != shape:
            raise ValueError(f"expected shape {shape}, got {tuple(t.shape)}")


def fused_trace(spec: SceneSpec, config: TraceConfig, state, obj_tx, prim, glass):
    """Trace ``state`` (13, n) through a narrow scene: ``(records (G, 15,
    n), masks (G, n) bool, final state (13, n))``.

    ``obj_tx`` (S, 16) is the row-major inverse of each leaf's world
    transform, ``prim`` (S, 6) and ``glass`` (M, 7) the scene params.  On
    CUDA tensors this launches the kernel and counts the launch in
    ``fused_trace.launches``; on CPU tensors it runs
    :func:`fused_trace_plain`.
    """
    if state.device.type == "cpu":
        return fused_trace_plain(spec, config, state, obj_tx, prim, glass)
    if state.device.type != "cuda":
        raise ValueError(f"the kernel runs on CUDA tensors, got {state.device}")
    check_inputs(spec, state, obj_tx, prim, glass)
    program = device_program(spec, state.device)
    n = state.shape[1]
    g = config.generation_limit
    records = torch.empty((g, engine.N_RECORD_COLS, n), dtype=state.dtype, device=state.device)
    masks = torch.empty((g, n), dtype=torch.bool, device=state.device)
    fstate = torch.empty_like(state)
    if n == 0:
        return records, masks, fstate
    lib = _library()
    launch = (
        lib.pyrayt_fused_trace_f32 if state.dtype == torch.float32 else lib.pyrayt_fused_trace_f64
    )
    with torch.cuda.device(state.device):
        err = launch(
            state.data_ptr(), n, g,
            obj_tx.data_ptr(), prim.data_ptr(), glass.data_ptr(), program.data_ptr(),
            program.numel(), spec.n_leaves, glass.shape[0],
            records.data_ptr(), masks.data_ptr(), fstate.data_ptr(),
            config.ray_offset, config.world_index, config.intensity_threshold,
            int(config.apply_intensity_threshold),
            torch.cuda.current_stream(state.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(
            f"fused_trace kernel launch failed: {lib.pyrayt_error_string(err).decode()}"
        )
    fused_trace.launches += 1
    return records, masks, fstate


fused_trace.launches = 0


def rays_from_state(state) -> RaySet:
    return RaySet(
        positions=state[0:4],
        directions=state[4:8],
        generation=state[8],
        intensity=state[9],
        wavelength=state[10],
        index=state[11],
        id=state[12],
    )


def fused_trace_plain(spec: SceneSpec, config: TraceConfig, state, obj_tx, prim, glass):
    """Plain PyTorch version of :func:`fused_trace` (same signature, same
    outputs, the per-ray exit contract of the module docstring), built on
    the plain engine's generation step."""
    if not supports_fused(spec):
        raise ValueError("scene has non-packed materials or no leaves; use the plain engine")
    check_inputs(spec, state, obj_tx, prim, glass)
    n = state.shape[1]
    g_limit = config.generation_limit
    tables = {"obj_tx": obj_tx.reshape(-1, 4, 4), "prim": prim, "glass": glass}
    records = torch.zeros(
        (g_limit, engine.N_RECORD_COLS, n), dtype=state.dtype, device=state.device
    )
    masks = torch.zeros((g_limit, n), dtype=torch.bool, device=state.device)
    rays = rays_from_state(state)
    running = torch.ones(n, dtype=torch.bool, device=state.device)
    for g in range(g_limit):
        if not bool(running.any()):
            break
        (nxt, living), record, masks[g] = engine.generation_step(
            spec, None, config, tables, (rays, running)
        )
        records[g] = torch.where(running, record, 0.0)
        rays = RaySet(
            **{
                f: torch.where(running, getattr(nxt, f), getattr(rays, f))
                for f in ("positions", "directions") + RaySet.fields
            }
        )
        running = living & (_sum_rows(nxt.directions * nxt.directions) != 0)
    fstate = torch.cat((rays.positions, rays.directions, rays.metadata))
    fstate[3] = 1.0  # homogeneous w rows, as the kernel writes them
    fstate[7] = 0.0
    return records, masks, fstate


def kernel_inputs(params, rays: RaySet):
    """The kernel's inputs from scene params and rays, in the rays' dtype:
    ``(state (13, n), obj_tx (S, 16), prim (S, 6), glass (M, 7))``, each
    contiguous.  ``obj_tx`` is the inverse of each leaf's world transform."""
    dtype = rays.dtype
    state = torch.cat((rays.positions, rays.directions, rays.metadata))
    obj_tx = affine_inverse(params["world"]).reshape(-1, 16)
    return tuple(
        t.to(dtype).contiguous() for t in (state, obj_tx, params["prim"], params["glass"])
    )


@lru_cache(maxsize=64)
def build_fused_trace_fn(spec: SceneSpec, materials, config: TraceConfig):
    """``fn(params, initial_rays) -> TraceResult`` through :func:`fused_trace`
    (the kernel on CUDA tensors).  Same contract as
    ``engine.build_trace_fn``; ``materials`` is accepted for its signature."""
    del materials  # packed kinds are read from the spec and the glass rows
    if not supports_fused(spec):
        raise ValueError("scene has non-packed materials or no leaves; use the plain engine")

    def trace(params, initial_rays: RaySet) -> engine.TraceResult:
        records, masks, fstate = fused_trace(
            spec, config, *kernel_inputs(params, initial_rays)
        )
        return engine.TraceResult(
            records=records,
            record_mask=masks,
            final_rays=rays_from_state(fstate),
            generations_run=masks.any(dim=1).sum(),
        )

    return trace

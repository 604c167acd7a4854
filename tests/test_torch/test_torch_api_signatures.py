"""The port accepts every call the JAX package's public API accepts.

For each module of ``pyrayt_tpu``, its public names (``__all__``, or the
functions and classes defined in it) and the public methods and properties
of its classes: the port's counterpart exists, takes every parameter of
the JAX signature (by name, and by position where the JAX one is
positional), and has no extra parameter a JAX call would have to fill.
A deliberate difference is named in ``ALLOWED`` and explained in API.md's
"Differences from `pyrayt_tpu`"; nothing else may differ.  The F4 calls
are then run against the JAX package at float64 on the CPU.
"""

import importlib
import inspect
import pathlib
import pkgutil
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pyrayt_tpu
import pyrayt_tpu_torch
from pyrayt_tpu.analysis import checkpoint as j_checkpoint
from pyrayt_tpu.config import TraceConfig as JConfig
from pyrayt_tpu.core import operations as j_ops
from pyrayt_tpu.tracer import engine as j_engine
from pyrayt_tpu_torch import components
from pyrayt_tpu_torch.analysis import checkpoint
from pyrayt_tpu_torch.config import TraceConfig
from pyrayt_tpu_torch.tracer import engine

P = inspect.Parameter
POSITIONAL = (P.POSITIONAL_ONLY, P.POSITIONAL_OR_KEYWORD)
DOC = pathlib.Path(pyrayt_tpu_torch.__file__).resolve().parent / "API.md"

# "<module of the JAX object>:<qualname>" for a name the port leaves out,
# "...:<qualname>(<parameter>)" for a parameter it leaves out or adds
ALLOWED = {
    "pyrayt_tpu.components:Lamp.prng_key": "the port's Lamp keeps rng_state",
    "pyrayt_tpu.core.operations:TRANSFORM_PRECISION": "TPU matmul precision",
    "pyrayt_tpu.ops.fused_trace:LANE": "TPU lane width",
    "pyrayt_tpu.ops.fused_trace:on_tpu": "TPU helper",
    "pyrayt_tpu.ops.fused_trace:fused_block_rays": "TPU block sizer",
    "pyrayt_tpu.ops.fused_grad:bwd_block_rays": "TPU block sizer",
    "pyrayt_tpu.scene._backend:asarray": "TPU helper",
    "pyrayt_tpu.ops.fused_trace:build_fused_trace_fn(interpret)": "Pallas interpreter",
    "pyrayt_tpu.ops.fused_trace:build_fused_trace_fn(static_loop)": "TPU loop drivers",
    "pyrayt_tpu.ops.fused_grad:build_fused_vjp_trace_fn(interpret)": "Pallas interpreter",
    "pyrayt_tpu.ops.fused_grad:build_fused_value_and_grad_fn(interpret)": "Pallas interpreter",
    "pyrayt_tpu.ops.fused_trace:pick_fused(itemsize)": "the port dispatches by device",
    "pyrayt_tpu.ops.fused_trace:pick_fused(need_grad)": "the port dispatches by device",
    "pyrayt_tpu.ops.fused_trace:pick_fused(device)": "the port dispatches by device",
    "pyrayt_tpu.parallel.mesh:default_mesh(devices)": "one device per rank",
}


def jax_modules():
    names = ["pyrayt_tpu"]
    names += [info.name for info in pkgutil.walk_packages(pyrayt_tpu.__path__, "pyrayt_tpu.")]
    return names


def public_names(module):
    if hasattr(module, "__all__"):
        return list(module.__all__)
    return [name for name, obj in vars(module).items()
            if not name.startswith("_") and (inspect.isfunction(obj) or inspect.isclass(obj))
            and obj.__module__ == module.__name__]


def key_of(module_name, obj, qualname):
    """The allow-list key: the JAX object's defining module, so a name
    re-exported in several modules has one entry."""
    home = getattr(obj, "__module__", None) if callable(obj) else None
    return f"{home or module_name}:{qualname}"


def signature(fn):
    try:
        return inspect.signature(fn)
    except (TypeError, ValueError):
        return None


def signature_faults(key, j_fn, t_fn):
    """The parameters of ``j_fn`` that ``t_fn`` does not accept, and the
    extra parameters of ``t_fn`` that a JAX call would leave unfilled."""
    j_sig, t_sig = signature(j_fn), signature(t_fn)
    if j_sig is None:
        return []
    if t_sig is None:
        return [f"{key}: no signature"]
    j_params = list(j_sig.parameters.values())
    t_params = list(t_sig.parameters.values())
    t_by_name = {p.name: p for p in t_params}
    t_kinds = {p.kind for p in t_params}
    t_positional = [p for p in t_params if p.kind in POSITIONAL]
    faults = []
    for i, p in enumerate(j_params):
        if p.kind in (P.VAR_POSITIONAL, P.VAR_KEYWORD):
            if p.kind not in t_kinds:
                faults.append(f"{key}({p.name})")
            continue
        by_name = (p.kind == P.POSITIONAL_ONLY or P.VAR_KEYWORD in t_kinds
                   or (p.name in t_by_name and t_by_name[p.name].kind != P.POSITIONAL_ONLY))
        # past a parameter the port leaves out (itself a fault), positions
        # cannot line up: the later ones are checked by name only
        by_position = (p.kind not in POSITIONAL or P.VAR_POSITIONAL in t_kinds
                       or i < len(t_positional) or faults)
        if not (by_name and by_position):
            faults.append(f"{key}({p.name})")
    j_names = {p.name for p in j_params}
    for p in t_params:
        if (p.name not in j_names and p.kind in POSITIONAL and p.default is P.empty):
            faults.append(f"{key}({p.name})")
    return faults


def module_faults(module_name):
    j_mod = importlib.import_module(module_name)
    t_mod = importlib.import_module("pyrayt_tpu_torch" + module_name[len("pyrayt_tpu"):])
    faults = []
    for name in public_names(j_mod):
        j_obj = getattr(j_mod, name)
        key = key_of(module_name, j_obj, name)
        if not hasattr(t_mod, name):
            faults.append(key)
            continue
        t_obj = getattr(t_mod, name)
        if not callable(j_obj):
            continue
        faults += signature_faults(key, j_obj, t_obj)
        if not inspect.isclass(j_obj):
            continue
        for attr, value in vars(j_obj).items():
            if attr.startswith("_"):
                continue
            attr_key = f"{key}.{attr}"
            if not hasattr(t_obj, attr):
                faults.append(attr_key)
            elif inspect.isfunction(value) or isinstance(value, (staticmethod, classmethod)):
                faults += signature_faults(attr_key, getattr(j_obj, attr), getattr(t_obj, attr))
    return faults


@pytest.mark.parametrize("module_name", jax_modules())
def test_the_port_accepts_every_jax_call(module_name):
    unexpected = [f for f in module_faults(module_name) if f not in ALLOWED]
    assert not unexpected, f"the port refuses: {unexpected}"


def test_every_allowed_difference_is_found_and_documented():
    """No stale entry, and API.md's section names each one."""
    found = {f for name in jax_modules() for f in module_faults(name)}
    assert set(ALLOWED) <= found, sorted(set(ALLOWED) - found)
    (section,) = [part for part in DOC.read_text().split("\n## ")
                  if part.startswith("Differences from `pyrayt_tpu`")]
    for entry in ALLOWED:
        for word in re.findall(r"[A-Za-z_]\w*", entry.split(":", 1)[1]):
            assert re.search(r"\b" + word + r"\b", section), (entry, word)


def test_the_walk_checks_methods_and_parameters():
    """The walk sees a class's methods and a parameter's position: a port
    that dropped one would fail."""

    class JaxLike:
        def replace(self, **changes):
            return changes

    def j_fn(vectors, axis=0):
        return vectors

    def t_fn(vectors, *, axis=0):
        return vectors

    assert signature_faults("k", j_fn, t_fn) == ["k(axis)"]
    assert signature_faults("k", t_fn, j_fn) == []
    assert signature_faults("k", j_fn, lambda vectors, dim=0, *, axis=None: vectors) == []
    assert signature_faults("k", j_fn, lambda vectors, axis=0, extra=1: vectors) == []
    assert signature_faults("k", j_fn, lambda vectors, axis, extra: vectors) == ["k(extra)"]
    assert signature_faults("k", JaxLike.replace, lambda self: None) == ["k(changes)"]


# --- the F4 calls, against the JAX package at float64 -------------------


AXIS_SITES = [
    ("core", "safe_normalize"), ("core", "element_wise_dot"),
    ("core.operations", "safe_normalize"), ("core.operations", "element_wise_dot"),
    ("core.primitives", "element_wise_dot"), ("ops.fused_trace", "safe_normalize"),
    ("tracer.engine", "safe_normalize"),
]


@pytest.mark.parametrize("site,name", AXIS_SITES)
@pytest.mark.parametrize("axis", [0, 1])
def test_axis_is_an_alias_of_dim(site, name, axis):
    rng = np.random.default_rng(11)
    a, b = rng.normal(size=(2, 3, 5))
    a[:, 2] = 0.0  # a zero column stays zero
    fn = getattr(importlib.import_module("pyrayt_tpu_torch." + site), name)
    args = (a,) if name == "safe_normalize" else (a, b)
    expected = np.asarray(getattr(j_ops, name)(*map(jnp.asarray, args), axis=axis))
    t_args = [torch.as_tensor(x) for x in args]
    got = fn(*t_args, axis=axis)
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), expected, rtol=1e-15, atol=0)
    np.testing.assert_array_equal(got.numpy(), fn(*t_args, axis).numpy())
    np.testing.assert_array_equal(got.numpy(), fn(*t_args, dim=axis).numpy())
    with pytest.raises(TypeError):
        fn(*t_args, dim=axis, axis=axis)


def test_restore_checkpoint_takes_a_template(tmp_path):
    theta = np.array([2.5, -1.25])
    history = np.arange(4.0) / 3.0
    j_path, t_path = str(tmp_path / "jax.ckpt"), str(tmp_path / "torch.ckpt")
    j_checkpoint.save_checkpoint(j_path, {"theta": jnp.asarray(theta), "step": 7,
                                          "history": jnp.asarray(history)})
    j_state = j_checkpoint.restore_checkpoint(
        j_path, {"theta": jnp.zeros(2), "step": 0, "history": jnp.zeros(4)})
    checkpoint.save_checkpoint(t_path, {"theta": torch.as_tensor(theta), "step": 7,
                                        "history": [torch.as_tensor(h) for h in history]})
    like = {"theta": torch.zeros(2, dtype=torch.float32), "step": 0,
            "history": [torch.zeros((), dtype=torch.float64)] * 4}
    state = checkpoint.restore_checkpoint(t_path, like)
    assert state["theta"].dtype == torch.float32 and state["theta"].device.type == "cpu"
    np.testing.assert_array_equal(state["theta"].numpy(),
                                  np.asarray(j_state["theta"]).astype(np.float32))
    assert state["step"] == int(j_state["step"]) == 7
    np.testing.assert_array_equal([float(h) for h in state["history"]],
                                  np.asarray(j_state["history"]))
    plain = checkpoint.restore_checkpoint(t_path)
    assert plain["theta"].dtype == torch.float64  # without a template, as saved
    assert checkpoint.restore_checkpoint(str(tmp_path / "none.ckpt"), like) is None
    assert checkpoint.latest_step(t_path) == j_checkpoint.latest_step(j_path) == 7


def test_trace_result_replace_matches_jax(twins):
    j_scene, t_scene, j_rays, t_rays, gens = twins.inputs("condenser")
    j_res = j_engine.build_trace_fn(j_scene.spec, j_scene.materials,
                                    JConfig(generation_limit=gens))(j_scene.params, j_rays)
    res = engine.build_trace_fn(t_scene.spec, t_scene.materials,
                                TraceConfig(generation_limit=gens))(t_scene.params, t_rays)
    j_new = j_res.replace(records=j_res.records * 2, generations_run=j_res.generations_run - 1)
    new = res.replace(records=res.records * 2, generations_run=res.generations_run - 1)
    assert isinstance(new, engine.TraceResult) and new is not res
    np.testing.assert_allclose(new.records.numpy(), np.asarray(j_new.records),
                               rtol=1e-12, atol=1e-12)
    assert int(new.generations_run) == int(j_new.generations_run)
    assert new.record_mask is res.record_mask and new.final_rays is res.final_rays
    with pytest.raises(TypeError):
        res.replace(not_a_field=1)


def test_lamp_keeps_rng_state_in_place_of_prng_key():
    """A JAX key has no torch meaning: the difference is allowed and the
    port's lamp replays from its generator state instead."""
    assert "pyrayt_tpu.components:Lamp.prng_key" in ALLOWED
    assert "rng_state" in DOC.read_text()
    lamp = components.Lamp(0.5, 0.5, seed=3)
    state = lamp.rng_state
    first = lamp.generate_rays(16, device="cpu", dtype=torch.float64)
    lamp.rng_state = state
    again = lamp.generate_rays(16, device="cpu", dtype=torch.float64)
    assert torch.equal(first.directions, again.directions)


def test_leaf_normal_raw3_takes_a_table_row_as_jax_does():
    from pyrayt_tpu.core import primitives as j_prim

    from pyrayt_tpu_torch.core import primitives as prim

    rng = np.random.default_rng(3)
    pts = rng.normal(size=(3, 7))
    table = np.array([[0.5, 1.0, 0.0, 0.0, 0.0, 0.0], [-1.0, 1.0, -1.0, 1.0, -1.0, 1.0],
                      [1.0, -1.0, 1.0, 1.0, 0.0, 0.0]])
    pts[2, :2] = 1.0  # on a cap / face
    for code, s in ((prim.PARABOLOID, 0), (prim.CUBE, 1), (prim.CYLINDER, 2)):
        expected = j_prim.leaf_normal_raw3(code, list(jnp.asarray(pts)), jnp.asarray(table), s)
        t_pts = list(torch.as_tensor(pts))
        by_row = prim.leaf_normal_raw3(code, t_pts, torch.as_tensor(table), s)
        packed = prim.leaf_normal_raw3(code, t_pts, torch.as_tensor(table[s]))
        for a, b, c in zip(by_row, packed, expected):
            np.testing.assert_array_equal(a.numpy(), b.numpy())
            np.testing.assert_array_equal(a.numpy(), np.broadcast_to(np.asarray(c), a.shape))


def test_build_fused_trace_fn_saves_the_fold_of_a_wide_scene(twins):
    from pyrayt_tpu_torch.ops import fused_trace as ft

    _, t_scene, _, t_rays, gens = twins.wide_inputs("mla5")
    config = TraceConfig(generation_limit=gens)
    spec, params = t_scene.spec, t_scene.params
    result, fold5, win = ft.build_fused_trace_fn(spec, t_scene.materials, config,
                                                 save_fold=True)(params, t_rays)
    plain = ft.build_fused_trace_fn(spec, t_scene.materials, config)(params, t_rays)
    assert torch.equal(result.records, plain.records)
    inputs = ft.wide_kernel_inputs(spec, params, t_rays)
    *_, k_fold5, k_win = ft.fused_trace_wide(spec, config, *inputs, save_fold=True)
    assert torch.equal(fold5, k_fold5) and torch.equal(win, k_win)
    narrow = twins.scene("condenser")[1]
    with pytest.raises(ValueError, match="save_fold"):
        ft.build_fused_trace_fn(narrow.spec, narrow.materials, config, save_fold=True)

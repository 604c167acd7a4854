"""Shared scenes and inputs for the PyTorch port's parity tests.

Every scene is built twice, once with each package's builders, under
``fresh_ids()`` so the surface ids agree.  Rays are made with NumPy from a
seed and handed to both packages (``pyrayt_tpu_torch.interop`` on the
torch side), so any difference comes from the engines.
"""

import types

import jax.numpy as jnp
import pytest
import torch

import pyrayt_tpu.components as j_comp
import pyrayt_tpu.materials as j_matl
import pyrayt_tpu.scene.csg as j_csg
from pyrayt_tpu.scene import fresh_ids as j_fresh_ids
from pyrayt_tpu.scene.compile import compile_scene as j_compile
from pyrayt_tpu.scene.surfaces import Sphere as j_Sphere
from pyrayt_tpu.tracer.rayset import RaySet as JRaySet
from pyrayt_tpu_torch import interop
from torch_parity_scenes import GRAD_SCENES, SCENES, TORCH_NS, grad_rays, numpy_rays

JAX_NS = types.SimpleNamespace(
    comp=j_comp, matl=j_matl, csg=j_csg, Sphere=j_Sphere, fresh_ids=j_fresh_ids,
    compile=j_compile,
)


def twin_scene(name):
    """The named scene built by both packages: ``(jax CompiledScene, torch
    CompiledScene)``, the torch params at float64 on the CPU."""
    build = SCENES[name][0]
    with JAX_NS.fresh_ids():
        j_scene = JAX_NS.compile(build(JAX_NS))
    with TORCH_NS.fresh_ids():
        t_scene = TORCH_NS.compile(build(TORCH_NS), device="cpu", dtype=torch.float64)
    return j_scene, t_scene


def _twin_rays(pos, dirs, meta):
    j_rays = JRaySet(
        positions=jnp.asarray(pos),
        directions=jnp.asarray(dirs),
        generation=jnp.asarray(meta[0]),
        intensity=jnp.asarray(meta[1]),
        wavelength=jnp.asarray(meta[2]),
        index=jnp.asarray(meta[3]),
        id=jnp.asarray(meta[4]),
    )
    return j_rays, interop.rays_from_numpy(pos, dirs, meta, device="cpu", dtype=torch.float64)


def grad_inputs(name, seed=5):
    """A gradient scene (torch_parity_scenes.GRAD_SCENES) built by both
    packages plus one NumPy ray set: ``(j_scene, t_scene, j_rays, t_rays,
    generation_limit)``."""
    build, _, _, gens, _ = GRAD_SCENES[name]
    with JAX_NS.fresh_ids():
        j_scene = JAX_NS.compile(build(JAX_NS))
    with TORCH_NS.fresh_ids():
        t_scene = TORCH_NS.compile(build(TORCH_NS), device="cpu", dtype=torch.float64)
    return (j_scene, t_scene) + _twin_rays(*grad_rays(name, seed)) + (gens,)


def twin_inputs(name, seed=7):
    """Scenes plus one NumPy ray set handed to both packages:
    ``(j_scene, t_scene, j_rays, t_rays, generation_limit)``."""
    _, origin, angle, n, gens = SCENES[name]
    j_scene, t_scene = twin_scene(name)
    pos, dirs, meta = numpy_rays(origin, angle, n, seed)
    j_rays = JRaySet(
        positions=jnp.asarray(pos),
        directions=jnp.asarray(dirs),
        generation=jnp.asarray(meta[0]),
        intensity=jnp.asarray(meta[1]),
        wavelength=jnp.asarray(meta[2]),
        index=jnp.asarray(meta[3]),
        id=jnp.asarray(meta[4]),
    )
    t_rays = interop.rays_from_numpy(pos, dirs, meta, device="cpu", dtype=torch.float64)
    return j_scene, t_scene, j_rays, t_rays, gens


@pytest.fixture()
def twins():
    return types.SimpleNamespace(
        scene=twin_scene, inputs=twin_inputs, grad_inputs=grad_inputs, numpy_rays=numpy_rays,
        jax=JAX_NS, torch=TORCH_NS, rays=_twin_rays,
    )

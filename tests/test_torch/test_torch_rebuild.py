"""The traced scene rebuild (scene/_factors.py) against the plain build and
the JAX package (float64, CPU).

A rebuild from tensors that require grad records each transform's factor
and composes every leaf's chain in ``compile_scene`` with a few batched
ops per chain signature.  Held here: the same SceneSpec as the plain build;
params equal to the plain build's and to the JAX package's
``compile_scene`` of the same builders; the vector-Jacobian product of the
params with respect to theta against ``jax.vjp`` of the JAX rebuild; the
getters of a traced object against the eager values; and the rebuild's
size, counted in aten ops with a ``TorchDispatchMode``.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import pyrayt_tpu as j_pyrayt
import pyrayt_tpu.components as j_comp
import pyrayt_tpu.materials as j_matl
from pyrayt_tpu.scene import ObjectGroup as JObjectGroup
from pyrayt_tpu.scene import fresh_ids as j_fresh_ids
from pyrayt_tpu.scene.compile import compile_scene as j_compile
import pyrayt_tpu_torch as t_pyrayt
import pyrayt_tpu_torch.components as t_comp
import pyrayt_tpu_torch.materials as t_matl
from pyrayt_tpu_torch.scene import ObjectGroup as TObjectGroup
from pyrayt_tpu_torch.scene import fresh_ids as t_fresh_ids
from pyrayt_tpu_torch.scene.compile import compile_scene as t_compile

NAMES = ("world", "prim", "glass")
RTOL = ATOL = 1e-14  # traced against plain: the same products, another order
VJP_RTOL = 1e-12

TORCH = types.SimpleNamespace(comp=t_comp, matl=t_matl, pin=t_pyrayt.pin, exp=torch.exp,
                              asarray=lambda x: torch.tensor(x, dtype=torch.float64),
                              group=TObjectGroup)
PLAIN = types.SimpleNamespace(comp=t_comp, matl=t_matl, pin=t_pyrayt.pin, exp=np.exp,
                              asarray=np.asarray, group=TObjectGroup)
JAX = types.SimpleNamespace(comp=j_comp, matl=j_matl, pin=j_pyrayt.pin, exp=jnp.exp,
                            asarray=jnp.asarray, group=JObjectGroup)

# examples/microlens_array.py: lenslets of radius 2.0, 0.25 thick, pitch 1.0,
# a detector at the focal plane
MLA_FOCUS = 4.0
# examples/lens_design.py: the achromatic doublet (mm)
LENS_DIAMETER, L1_THICKNESS, L2_THICKNESS = 25.4, 8.0, 2.0
DOUBLET_SIGNS = np.array([1.0, -1.0, -1.0, -1.0])


def mla(m, r, n):
    lenslets = m.comp.microlens_array(r, 0.25, n, n, 1.0)
    return lenslets + [m.comp.baffle((2.0 * n, 2.0 * n)).move_x(MLA_FOCUS)]


def doublet(m, log_mags):
    """examples/lens_design.py:build_doublet of ``signs * exp(theta)``."""
    radii = m.asarray(DOUBLET_SIGNS) * m.exp(log_mags)
    l1 = m.comp.thick_lens(radii[0], radii[1], L1_THICKNESS, aperture=LENS_DIAMETER,
                           material=m.matl.glass["BK7"], r1_sign=1, r2_sign=-1)
    l2 = m.comp.thick_lens(radii[2], radii[3], L2_THICKNESS, aperture=LENS_DIAMETER,
                           material=m.matl.glass["SF2"], r1_sign=-1, r2_sign=-1,
                           ).move_x(1.01 * (L1_THICKNESS + L2_THICKNESS) / 2)
    imager = m.comp.baffle((LENS_DIAMETER, LENS_DIAMETER)).move_x(50.0)
    return [l1, l2, imager]


def mixed(m, theta):
    """test_torch_scene.py's traced scene, with a traced rotation, a CSG
    difference moved as a whole, a group moved as a whole and a pinned move
    restored."""
    r, t = theta[0], theta[1]
    lens = m.comp.thick_lens(r, -r, t, aperture=0.8, material=m.matl.glass["BK7"],
                             r1_sign=1, r2_sign=-1)
    mirror = m.comp.spherical_mirror(2 * r, t, aperture=0.5, radius_sign=1).move_x(3.0)
    box = m.comp.Cuboid.from_sides(t, 2 * t, 0.5).rotate_z(10 * r).move_y(t)
    pair = m.group([mirror, box]).move_z(0.5 * t).rotate_x(5 * r)
    stop = m.comp.aperture((2.0, 2.0), 0.5).rotate_y(3 * t).move_x(2.5 + r).move_z(t)
    with m.pin(lens, stop):
        lens.move_x(r).rotate_x(20 * t)
        stop.move_y(t)
    return [lens, pair, stop, m.comp.baffle((3.0, 3.0)).move_x(2.0 + r)]


SCENES = {
    "mla16_shared": (lambda m, th: mla(m, th, 16), np.float64(2.1)),
    "mla16_radii": (lambda m, th: mla(m, th, 16),
                    2.0 + 0.2 * np.random.default_rng(3).standard_normal(256)),
    "mla4_shared": (lambda m, th: mla(m, th, 4), np.float64(2.1)),
    "mla4_radii": (lambda m, th: mla(m, th, 4),
                   2.0 + 0.2 * np.random.default_rng(5).standard_normal(16)),
    "doublet": (doublet, np.log(np.array([30.47, 30.47, 30.47, 104.7]))),
    "mixed": (mixed, np.array([1.7, 0.2])),
}


def t_build(name, theta):
    build, _ = SCENES[name]
    ns = PLAIN if not isinstance(theta, torch.Tensor) else TORCH
    with t_fresh_ids():
        return t_compile(build(ns, theta), device="cpu", dtype=torch.float64)


def j_build(name, theta):
    build, _ = SCENES[name]
    with j_fresh_ids():
        return j_compile(build(JAX, theta))


def traced(theta0):
    return torch.tensor(theta0, dtype=torch.float64, requires_grad=True)


@pytest.mark.parametrize("name", list(SCENES))
def test_traced_rebuild_equals_plain_and_jax(name):
    theta0 = SCENES[name][1]
    rebuilt = t_build(name, traced(theta0))
    plain = t_build(name, theta0)
    j_scene = j_build(name, jnp.asarray(theta0))
    assert rebuilt.spec == plain.spec
    assert tuple(rebuilt.spec.leaf_ids) == tuple(j_scene.spec.leaf_ids)
    assert rebuilt.params["world"].grad_fn is not None
    for key in NAMES:
        got = rebuilt.params[key].detach()
        torch.testing.assert_close(got, plain.params[key], rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(got.numpy(), np.asarray(j_scene.params[key]), rtol=RTOL,
                                   atol=ATOL, err_msg=key)


def t_vjp(name, theta0, rng):
    """The port's vjp of ``world`` and ``prim`` at seeded random cotangents:
    ``(d theta, cotangents)``."""
    theta = traced(theta0)
    params = t_build(name, theta).params
    cotangents = {k: rng.standard_normal(tuple(params[k].shape)) for k in ("world", "prim")}
    (got,) = torch.autograd.grad(
        [params[k] for k in cotangents], theta, [torch.as_tensor(c) for c in cotangents.values()])
    return got.numpy(), cotangents


@pytest.mark.parametrize("name", ["mla4_shared", "mla4_radii", "doublet", "mixed"])
def test_traced_rebuild_vjp_equals_jax(name):
    theta0 = SCENES[name][1]
    got, cotangents = t_vjp(name, theta0, np.random.default_rng(11))

    def j_params(th):
        p = j_build(name, th).params
        return {k: p[k] for k in cotangents}

    _, vjp = jax.vjp(jax.jit(j_params), jnp.asarray(theta0))
    (want,) = vjp({k: jnp.asarray(c) for k, c in cotangents.items()})
    np.testing.assert_allclose(got, np.asarray(want), rtol=VJP_RTOL, atol=1e-12)
    assert np.all(np.asarray(want) != 0)


def j_lenslet(r, y, z):
    """One lenslet of the JAX package's microlens_array at (y, z): its
    sphere's and its cylinder's world and prim rows."""
    with j_fresh_ids():
        lens = j_comp.plano_convex_lens(r, 0.25, aperture=1.0, material=j_matl.glass["ideal"])
        params = j_compile([lens.move_y(y).move_z(z)]).params
    return params["world"], params["prim"]


@pytest.mark.parametrize("name", ["mla16_shared", "mla16_radii"])
def test_traced_16x16_rebuild_vjp_equals_jax_per_lenslet(name):
    """The 16x16 array's vjp against ``jax.vjp`` of the JAX package's
    lenslets, one vmapped call over the 256 (a jit of the whole JAX rebuild
    takes minutes to compile): lenslet i's radius reaches its own two
    leaves only, slots 2i and 2i + 1, and a shared radius sums them."""
    theta0 = SCENES[name][1]
    got, cotangents = t_vjp(name, theta0, np.random.default_rng(13))
    n = 16
    y = np.repeat((np.arange(n) - (n - 1) / 2.0), n)
    z = np.tile((np.arange(n) - (n - 1) / 2.0), n)
    radii = np.broadcast_to(theta0, (n * n,))
    cw = cotangents["world"][: 2 * n * n].reshape(n * n, 2, 4, 4)
    cp = cotangents["prim"][: 2 * n * n].reshape(n * n, 2, 6)

    def d_radius(r, y, z, cw, cp):
        return jax.vjp(lambda r: j_lenslet(r, y, z), r)[1]((cw, cp))[0]

    want = np.asarray(jax.jit(jax.vmap(d_radius))(
        jnp.asarray(radii), jnp.asarray(y), jnp.asarray(z), jnp.asarray(cw), jnp.asarray(cp)))
    if np.ndim(theta0) == 0:
        want = want.sum()
    np.testing.assert_allclose(got, want, rtol=VJP_RTOL, atol=1e-12)
    assert np.all(want != 0)


def moved(m, theta):
    """A CSG lens and a surface under a chain of traced moves, scales and
    rotations, and a group moved as a whole."""
    lens = m.comp.thick_lens(1.0, -1.0, 0.25, aperture=0.5, material=m.matl.glass["BK7"])
    lens.move(theta[0], 0.5, theta[1]).rotate_z(30 * theta[2]).move_y(theta[0])
    sphere = m.comp.Sphere(theta[1]).scale(1.0, theta[2], 2.0).rotate_x(theta[0], units="rad")
    sphere.move_z(-theta[2]).transform(np.diag([1.0, 1.0, 1.5, 1.0]))
    return lens, sphere


def test_getters_after_traced_moves_equal_the_eager_values():
    theta0 = np.array([0.3, 0.7, 1.2])
    with t_fresh_ids():
        t_objs = moved(TORCH, traced(theta0))
    with t_fresh_ids():
        p_objs = moved(PLAIN, theta0)
    with j_fresh_ids():
        j_objs = moved(JAX, jnp.asarray(theta0))
    leaves = [
        (t_objs[0].l_child.r_child, p_objs[0].l_child.r_child, j_objs[0].l_child.r_child),
        (t_objs[1], p_objs[1], j_objs[1]),
        (t_objs[0], p_objs[0], j_objs[0]),
    ]
    for t_obj, p_obj, j_obj in leaves:
        for getter in ("get_position", "get_orientation", "get_world_transform",
                       "get_object_transform"):
            got = getattr(t_obj, getter)()
            assert isinstance(got, torch.Tensor) and got.requires_grad, getter
            want = getattr(p_obj, getter)()
            np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-13, atol=1e-13,
                                       err_msg=getter)
            np.testing.assert_allclose(want, np.asarray(getattr(j_obj, getter)()), rtol=1e-13,
                                       atol=1e-13, err_msg=getter)
        np.testing.assert_allclose(t_obj.bounding_box, p_obj.bounding_box, rtol=1e-13,
                                   atol=1e-13)
        np.testing.assert_allclose(p_obj.bounding_box, np.asarray(j_obj.bounding_box),
                                   rtol=1e-13, atol=1e-13)
    # a later move invalidates what was read
    t_objs[1].move_x(2.0)
    p_objs[1].move_x(2.0)
    np.testing.assert_allclose(t_objs[1].get_position().detach().numpy(),
                               p_objs[1].get_position(), rtol=1e-13, atol=1e-13)
    np.testing.assert_allclose(t_objs[1].bounding_box, p_objs[1].bounding_box, rtol=1e-13,
                               atol=1e-13)


def test_leaves_of_interleaved_chain_shapes_keep_their_slots():
    """Leaves whose factor chains alternate between shapes compose in one
    group per shape; each row lands in its own slot, equal to the object's
    own world matrix."""
    theta = traced([0.3, 0.7])
    with t_fresh_ids():
        spheres = [
            t_comp.Sphere(1.0).move_x(theta[0]),
            t_comp.Sphere(1.0).rotate_z(theta[1], units="rad"),
            t_comp.Sphere(theta[1]).move_x(theta[1]),
            t_comp.Sphere(1.0).rotate_z(theta[0], units="rad").move_y(2.0),
            t_comp.Sphere(2.0).rotate_z(theta[0], units="rad"),
        ]
        scene = t_compile(spheres, device="cpu", dtype=torch.float64)
    for slot, sphere in enumerate(spheres):
        for key, own in (("world", sphere.get_world_transform()), ("prim", sphere.prim_params)):
            torch.testing.assert_close(scene.params[key][slot].detach(),
                                       torch.as_tensor(own).detach(), rtol=0, atol=0)


class AtenCount(TorchDispatchMode):
    """Counts the aten ops dispatched inside it, views apart."""

    def __init__(self):
        super().__init__()
        self.ops = 0
        self.views = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.is_view:
            self.views += 1
        else:
            self.ops += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("n", [4, 8, 16])
@pytest.mark.parametrize("radii", ["shared", "per_lenslet"])
def test_traced_rebuild_runs_a_few_ops_per_leaf(n, radii):
    """At most 4 non-view aten ops per leaf plus 200, in the forward and in
    its backward."""
    theta = traced(2.0 if radii == "shared" else np.full(n * n, 2.0))
    forward, backward = AtenCount(), AtenCount()
    with forward, t_fresh_ids():
        scene = t_compile(mla(TORCH, theta, n), device="cpu", dtype=torch.float64)
    leaves = scene.spec.n_leaves
    assert leaves == 2 * n * n + 1
    with backward:
        (scene.params["world"].sum() + scene.params["prim"].sum()).backward()
    assert forward.ops <= 4 * leaves + 200, (forward.ops, leaves)
    assert backward.ops <= 4 * leaves + 200, (backward.ops, leaves)
    assert torch.isfinite(theta.grad).all() and (theta.grad != 0).all()

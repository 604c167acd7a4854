"""Port parity at float64: core.operations, primitives, interval and
network CSG, sorting networks — each against the JAX package on the same
NumPy inputs (rtol = atol = 1e-12 unless stated)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyrayt_tpu.core import csg as j_csg
from pyrayt_tpu.core import intervals as j_iv
from pyrayt_tpu.core import operations as j_ops
from pyrayt_tpu.core import primitives as j_prim
from pyrayt_tpu.ops import sortnet as j_sortnet
from pyrayt_tpu_torch.core import csg as t_csg
from pyrayt_tpu_torch.core import intervals as t_iv
from pyrayt_tpu_torch.core import operations as t_ops
from pyrayt_tpu_torch.core import primitives as t_prim
from pyrayt_tpu_torch.ops import sortnet as t_sortnet

TOL = dict(rtol=1e-12, atol=1e-12)


def T(x):
    return torch.as_tensor(np.asarray(x), dtype=torch.float64)


def J(x):
    return jnp.asarray(np.asarray(x), dtype=jnp.float64)


def close(t, j, **tol):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), **(tol or TOL))


def random_rays(n=200, seed=0):
    """(2, 4, n) homogeneous rays with every edge case the intersectors
    branch on: axis-parallel, zero and tiny directions."""
    rng = np.random.default_rng(seed)
    pos = np.concatenate((rng.uniform(-2, 2, (3, n)), np.ones((1, n))))
    d = rng.normal(size=(3, n))
    d[:, :10] = 0.0  # dead rays
    d[0, 10:20] = 0.0  # parallel to each axis plane
    d[1, 20:30] = 0.0
    d[2, 30:40] = 0.0
    d[:2, 40:50] = 0.0  # along z
    d[:, 50:55] *= 1e-10  # tiny directions
    dirs = np.concatenate((d, np.zeros((1, n))))
    pos[:3, 55:60] = 0.0  # at the origin
    return np.stack((pos, dirs))


def test_affine_inverse_matches_jax_and_inverts():
    rng = np.random.default_rng(1)
    m = np.tile(np.eye(4), (5, 1, 1))
    m[:, :3, :] = rng.normal(size=(5, 3, 4))
    close(t_ops.affine_inverse(T(m)), j_ops.affine_inverse(J(m)), rtol=1e-12, atol=1e-10)
    np.testing.assert_allclose(
        t_ops.affine_inverse(T(m)).numpy() @ m, np.tile(np.eye(4), (5, 1, 1)), atol=1e-10
    )


def test_safe_sqrt_and_normalize():
    x = np.array([-1.0, 0.0, 1e-300, 4.0])
    close(t_ops.safe_sqrt(T(x)), j_ops.safe_sqrt(J(x)))
    v = np.random.default_rng(2).normal(size=(4, 9))
    v[:, 0] = 0.0
    close(t_ops.safe_normalize(T(v)), j_ops.safe_normalize(J(v)))
    xg = T(np.array([0.0, 2.0])).requires_grad_()
    t_ops.safe_sqrt(xg).sum().backward()
    assert torch.isfinite(xg.grad).all()


def test_binomial_root_edge_conventions():
    # generic, negative discriminant, linear, constant inside / outside
    a = np.array([1.0, 1.0, 0.0, 0.0, 0.0, 1e-9])
    b = np.array([0.0, 0.0, 2.0, 0.0, 0.0, 3.0])
    c = np.array([-4.0, 4.0, -4.0, -1.0, 1.0, 1.0])
    t = t_ops.binomial_root(T(a), T(b), T(c))
    close(t, j_ops.binomial_root(J(a), J(b), J(c)))
    assert t[0, 3] == -np.inf and t[1, 3] == np.inf
    assert t[0, 4] == np.inf and t[1, 4] == np.inf
    close(
        t_ops.smallest_positive_root(T(a), T(b), T(c)),
        j_ops.smallest_positive_root(J(a), J(b), J(c)),
    )


def test_reflect_and_refract_with_tir():
    rng = np.random.default_rng(3)
    v = np.concatenate((rng.normal(size=(3, 64)), np.zeros((1, 64))))
    n = np.concatenate((rng.normal(size=(3, 64)), np.zeros((1, 64))))
    n /= np.linalg.norm(n, axis=0)
    n1 = rng.choice([1.0, 1.5], 64)
    n2 = rng.choice([1.0, 1.33, 1.7], 64)
    close(t_ops.reflect(T(v), T(n)), j_ops.reflect(J(v), J(n)))
    close(t_ops.reflect(T(v[:, 0]), T(n[:, 0])), j_ops.reflect(J(v[:, 0]), J(n[:, 0])))
    close(t_ops.reflect(T(v), T(n[:, 0])), j_ops.reflect(J(v), J(n[:, 0])))
    td, ti = t_ops.refract(T(v), T(n), T(n1), T(n2), n_global=1.2)
    jd, ji = j_ops.refract(J(v), J(n), J(n1), J(n2), n_global=1.2)
    close(td, jd)
    close(ti, ji)
    # some rays went through TIR (kept n1) and some refracted
    assert (ti.numpy() == n1).any() and (ti.numpy() != n1).any()


@pytest.mark.parametrize("type_code", [0, 1, 2, 3, 4])
def test_intersectors_match_jax(type_code):
    rays = random_rays(seed=type_code)
    params = {
        0: [1.3, 0, 0, 0, 0, 0],
        1: [0.5, 1.2, 0, 0, 0, 0],
        2: [2.0, 1.5, 0, 0, 0, 0],
        3: [-1.0, 1.2, -0.5, 0.7, -1.5, 1.1],
        4: [0.9, -0.8, 1.1, 1.0, 0, 0],
    }[type_code]
    t = t_prim.leaf_intersect(type_code, T(rays), T(params))
    j = j_prim.leaf_intersect(type_code, J(rays), J(params))
    np.testing.assert_array_equal(np.isinf(t.numpy()), np.isinf(np.asarray(j)))
    close(t, j)
    # object-space hit points on the surface -> normals, raw and unit
    pts = rays[0] + np.where(np.isfinite(t.numpy()[0]), t.numpy()[0], 0.0) * rays[1]
    close(
        t_prim.leaf_normal(type_code, T(pts), T(params)),
        j_prim.leaf_normal(type_code, J(pts), J(params)),
    )
    raw_t = t_prim.leaf_normal_raw3(type_code, [T(pts[i]) for i in range(3)], T(params))
    jp = J(params)[None]
    raw_j = j_prim.leaf_normal_raw3(type_code, [J(pts[i]) for i in range(3)], jp, 0)
    for a, b in zip(raw_t, raw_j):
        close(torch.broadcast_to(a, (pts.shape[1],)), jnp.broadcast_to(b, (pts.shape[1],)))


def test_cylinder_caps_and_uncapped_normals():
    pts = np.array([[0.3, 0.0, 0.2], [0.1, 0.9, 0.0], [1.1, -0.8, 0.4], [1.0, 1.0, 1.0]])
    for capped in (1.0, 0.0):
        params = [0.9, -0.8, 1.1, capped, 0, 0]
        close(
            t_prim.leaf_normal(4, T(pts), T(params)),
            j_prim.leaf_normal(4, J(pts), J(params)),
        )


def test_sorting_networks_match_jax():
    for m in (2, 3, 4, 6, 8, 12, 16):
        assert t_sortnet.batcher_pairs(m) == j_sortnet.batcher_pairs(m)
    x = np.random.default_rng(4).normal(size=(6, 11))
    x[2, :3] = x[4, :3]  # ties
    close(t_sortnet.sort_rows(T(x)), j_sortnet.sort_rows(J(x)))
    keys = [T(r) for r in x]
    ids = [torch.full((11,), i, dtype=torch.int32) for i in range(6)]
    tk, (tid,) = t_sortnet.sort_rows_with_payloads(keys, (ids,), stable=True)
    jk, (jid,) = j_sortnet.sort_rows_with_payloads(
        [J(r) for r in x], ([jnp.full((11,), i, jnp.int32) for i in range(6)],), stable=True
    )
    for a, b in zip(tid, jid):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("op", ["UNION", "INTERSECT", "DIFFERENCE"])
def test_network_csg_matches_jax(op):
    rng = np.random.default_rng(5)
    l_hits = np.sort(rng.uniform(-1, 3, (2, 40)), axis=0)
    r_hits = np.sort(rng.uniform(-1, 3, (4, 40)), axis=0)
    r_hits[:, :5] = np.inf
    l_hits[1, 5:10] = r_hits[0, 5:10]  # coincident events
    l_ids = np.zeros((2, 40), np.int32)
    r_ids = np.ones((4, 40), np.int32)
    th, ti = t_csg.csg_combine_with_ids(
        T(l_hits), torch.as_tensor(l_ids), T(r_hits), torch.as_tensor(r_ids),
        t_csg.Operation[op],
    )
    jh, ji = j_csg.csg_combine_with_ids(
        J(l_hits), jnp.asarray(l_ids), J(r_hits), jnp.asarray(r_ids), j_csg.Operation[op]
    )
    close(th, jh)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    close(
        t_csg.array_csg(T(l_hits), T(r_hits), t_csg.Operation[op]),
        j_csg.array_csg(J(l_hits), J(r_hits), j_csg.Operation[op]),
    )


def test_interval_trees_match_jax():
    rng = np.random.default_rng(6)
    hits = [np.sort(rng.uniform(-1, 2, (2, 30)), axis=0) for _ in range(4)]
    hits[2][:, :4] = np.inf
    tree = ("difference", ("difference", ("intersect", ("leaf", 0), ("leaf", 1)),
                                          ("leaf", 2)), ("leaf", 3))
    assert t_iv.tree_supports_intervals(tree) and j_iv.tree_supports_intervals(tree)
    assert not t_iv.tree_supports_intervals(("union", ("leaf", 0), ("leaf", 1)))
    t_out = t_iv.eval_tree_intervals(tree, t_iv.leaf_intervals_from_hits([T(h) for h in hits]))
    j_out = j_iv.eval_tree_intervals(tree, j_iv.leaf_intervals_from_hits([J(h) for h in hits]))
    assert len(t_out) == len(j_out) == 4
    for t_iv_, j_iv_ in zip(t_out, j_out):
        for a, b in zip(t_iv_, j_iv_):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)

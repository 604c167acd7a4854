"""Vector math core of the PyTorch port.

PyTorch counterparts of ``pyrayt_tpu.core.operations``.  The conventions
are load-bearing for CSG and are kept exactly:

  * quadratic solvers return BOTH roots, shape ``(2, n)``
  * a miss (negative discriminant) is encoded as ``+inf`` for both roots
  * the linear case (``a ~ 0``) duplicates the single root ``-c/b``
  * the constant case (``a ~ 0`` and ``b ~ 0``) returns ``(+inf, +inf)``,
    or ``(-inf, +inf)`` when ``c <= 0`` (ray fully inside the solid)

``isclose`` uses the same defaults as ``numpy``/``jnp``/``torch``
(rtol 1e-5, atol 1e-8).  Guards sit on the arguments of ``sqrt`` and of
divisions, so autograd through these functions stays NaN-free.
"""

from __future__ import annotations

import math

import torch

__all__ = [
    "isclose",
    "safe_sqrt",
    "safe_normalize",
    "affine_inverse",
    "transform_rays",
    "smallest_positive_root",
    "binomial_root",
    "element_wise_dot",
    "reflect",
    "refract",
]

INF = math.inf

# Full-precision float32 matrix products: transform_rays is a matmul that
# the sources apply to every ray, and a TF32 product (or the TPU's bf16
# default, which once quantized every transform of the JAX package) keeps
# only ~3 decimal digits.  Both switches are set explicitly, not left to
# PyTorch's defaults.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def isclose(a, b, rtol=1e-5, atol=1e-8):
    """``|a - b| <= atol + rtol * |b|`` (``numpy.isclose`` semantics);
    ``b`` may be a Python number or a broadcastable tensor."""
    if not isinstance(b, torch.Tensor):
        b = torch.as_tensor(b, dtype=a.dtype, device=a.device)
    return torch.isclose(a, b.to(a.dtype).expand_as(a), rtol=rtol, atol=atol)


def transform_rays(tx, x):
    """``tx @ x`` for homogeneous transforms (full float32: no TF32)."""
    return torch.matmul(tx, x)


def affine_inverse(matrices):
    """Closed-form inverse of affine ``(..., 4, 4)`` transforms whose last
    row is ``(0, 0, 0, 1)``: the 3x3 block inverts by adjugate over
    determinant, the translation follows."""
    m = matrices
    a = m[..., :3, :3]
    t = m[..., :3, 3]

    def _cof(i0, i1, j0, j1):
        return a[..., i0, j0] * a[..., i1, j1] - a[..., i0, j1] * a[..., i1, j0]

    c00 = _cof(1, 2, 1, 2)
    c01 = -_cof(1, 2, 0, 2)
    c02 = _cof(1, 2, 0, 1)
    c10 = -_cof(0, 2, 1, 2)
    c11 = _cof(0, 2, 0, 2)
    c12 = -_cof(0, 2, 0, 1)
    c20 = _cof(0, 1, 1, 2)
    c21 = -_cof(0, 1, 0, 2)
    c22 = _cof(0, 1, 0, 1)
    det = a[..., 0, 0] * c00 + a[..., 0, 1] * c01 + a[..., 0, 2] * c02

    adj = torch.stack(
        (
            torch.stack((c00, c10, c20), dim=-1),
            torch.stack((c01, c11, c21), dim=-1),
            torch.stack((c02, c12, c22), dim=-1),
        ),
        dim=-2,
    )
    a_inv = adj / det[..., None, None]
    t_inv = -torch.einsum("...ij,...j->...i", a_inv, t)

    top = torch.cat((a_inv, t_inv[..., None]), dim=-1)  # (..., 3, 4)
    last = torch.zeros_like(m[..., 3:, :])
    last[..., 0, 3] = 1.0
    return torch.cat((top, last), dim=-2)


def _sum_rows(x):
    """Sum over a small leading axis, row by row (the JAX package's order)."""
    total = x[0]
    for i in range(1, x.shape[0]):
        total = total + x[i]
    return total


def _norm_rows(x):
    return torch.sqrt(_sum_rows(x * x))


def safe_sqrt(x):
    """``sqrt(max(0, x))`` with a zero (not inf/NaN) gradient at ``x <= 0``."""
    positive = x > 0
    return torch.where(positive, torch.sqrt(torch.where(positive, x, 1.0)), 0.0)


def safe_normalize(vectors, dim=0, eps=0.0):
    """Normalize along ``dim``; zero vectors stay zero (no NaN)."""
    if dim == 0 and vectors.ndim >= 1:
        sq = _sum_rows(vectors * vectors)[None]
    else:
        sq = torch.sum(vectors * vectors, dim=dim, keepdim=True)
    zero = sq <= eps * eps if eps else sq == 0
    norm = torch.sqrt(torch.where(zero, 1.0, sq))
    return torch.where(zero, vectors, vectors / norm)


def smallest_positive_root(a, b, c):
    """Smallest positive root of ``a x^2 + b x + c = 0``; ``+inf`` when none."""
    disc = b**2 - 4 * a * c
    root = safe_sqrt(disc)
    denom = 2 * a + isclose(a, 0)
    polyroots = torch.stack(((-b + root), (-b - root))) / denom
    nearest = torch.where(
        polyroots[1] >= 0, torch.min(polyroots, dim=0).values, polyroots[0]
    )
    return torch.where((disc >= 0) & (nearest >= 0), nearest, INF)


def binomial_root(a, b, c, disc=None):
    """Both roots of ``a x^2 + b x + c = 0`` with the CSG edge conventions
    (see the module docstring).  Returns shape ``(2,) + a.shape``."""
    disc = b**2 - 4 * a * c if disc is None else disc
    linear_cases = isclose(a, 0)
    root = safe_sqrt(disc)

    denom = 2 * a + linear_cases
    polyroots = torch.stack(((-b + root), (-b - root))) / denom
    polyroots = torch.where(disc >= 0, polyroots, INF)

    # the linear division is live only where (a ~ 0, b !~ 0); elsewhere the
    # denominator is 1 so a tiny b cannot overflow the backward pass
    live_linear = linear_cases & ~isclose(b, 0)
    linear_root = -c / torch.where(live_linear, b, 1.0)
    polyroots = torch.where(linear_cases, linear_root[None], polyroots)

    c_terms_only = linear_cases & isclose(b, 0)
    polyroots = torch.where(c_terms_only, INF, polyroots)
    row0 = torch.where(c_terms_only & (c <= 0), -INF, polyroots[0])
    return torch.stack((row0, polyroots[1]))


def element_wise_dot(mat_1, mat_2, dim=0):
    """Column-wise (dim=0) or row-wise (dim=1) dot product."""
    if mat_1.ndim == 1:
        return torch.dot(mat_1, mat_2)
    if dim == 0:
        return _sum_rows(mat_1 * mat_2)
    return torch.sum(mat_1 * mat_2, dim=dim)


def reflect(vectors, normals):
    """Reflect ``vectors`` across unit ``normals`` (single/single,
    many/single and many/many; columns are vectors)."""
    if vectors.ndim == 1 and normals.ndim == 1:
        return vectors - normals * 2 * torch.dot(vectors, normals)
    if normals.ndim == 1:
        dots = torch.einsum("ij,i->j", vectors, normals)
        return vectors - 2 * normals[:, None] * dots
    dots = element_wise_dot(vectors, normals, dim=0)
    return vectors - 2 * normals * dots


def refract(vectors, normals, n1, n2, n_global=1.0):
    """Vector Snell refraction with enter/exit and TIR handling.

    ``v . n > 0`` means the ray exits the medium: the normal flips and the
    destination index becomes ``n_global``.  Total internal reflection
    returns the reflected vector and keeps ``n1``.  Returns
    ``(unit directions, new per-ray index)``.
    """
    vectors = safe_normalize(vectors, dim=0)

    cos_theta1_p = element_wise_dot(vectors, normals, dim=0)
    cos_theta1_n = -cos_theta1_p
    exiting = cos_theta1_p > 0

    if not isinstance(n2, torch.Tensor):
        n2 = torch.as_tensor(n2, dtype=vectors.dtype, device=vectors.device)
    n2_local = torch.where(exiting, n_global, n2)
    normals = torch.where(exiting, -normals, normals)
    r = n1 / n2_local
    cos_theta1 = torch.where(exiting, cos_theta1_p, cos_theta1_n)

    radicand = 1 - (r**2) * (1 - cos_theta1**2)
    cos_theta2 = safe_sqrt(radicand)

    refracted = torch.where(
        radicand > 0,
        r * vectors + (r * cos_theta1 - cos_theta2) * normals,
        vectors + 2 * cos_theta1 * normals,
    )
    refracted = safe_normalize(refracted, dim=0)
    n_refracted = torch.where(radicand > 0, n2_local, n1)
    return refracted, n_refracted

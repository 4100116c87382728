"""Closed-form symmetric eigensolvers for tiny batched matrices.

``jnp.linalg.eigh`` on [N, 3, 3] lowers to an iterative batched Jacobi sweep
— needlessly slow for the surface-normal pass (one 3x3 per map point).
These are the analytic alternatives: pure elementwise math, fully fused
by XLA, no iteration.

3x3: trigonometric (Cardano) eigenvalues + eigenvector from the product
``(A - l1 I)(A - l2 I)`` whose columns span the l0 eigenspace.
2x2: direct angle form.
"""
from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

__all__ = ["sym_eig3_smallest", "sym_eig2_smallest"]


def sym_eig3_smallest(A: jax.Array) -> Tuple[jax.Array, jax.Array]:
    """Smallest-eigenvalue eigenvector of symmetric A [..., 3, 3].

    Returns ``(eigenvalues [..., 3] ascending, eigenvector [..., 3])``.
    Degenerate (isotropic) neighborhoods fall back to +z.
    """
    q = jnp.trace(A, axis1=-2, axis2=-1) / 3.0
    eye = jnp.eye(3, dtype=A.dtype)
    B = A - q[..., None, None] * eye
    p2 = jnp.sum(B * B, axis=(-2, -1)) / 6.0
    p = jnp.sqrt(jnp.maximum(p2, 1e-30))
    detB = jnp.linalg.det(B / p[..., None, None])
    r = jnp.clip(detB / 2.0, -1.0, 1.0)
    phi = jnp.arccos(r) / 3.0
    two_pi_3 = 2.0 * jnp.pi / 3.0
    l2 = q + 2.0 * p * jnp.cos(phi)                 # largest
    l0 = q + 2.0 * p * jnp.cos(phi + two_pi_3)      # smallest
    l1 = 3.0 * q - l0 - l2
    evals = jnp.stack([l0, l1, l2], axis=-1)

    C = (A - l1[..., None, None] * eye) @ (A - l2[..., None, None] * eye)
    norms = jnp.sum(C * C, axis=-2)  # [..., 3] column norms^2
    best = jnp.argmax(norms, axis=-1)
    v = jnp.take_along_axis(C, best[..., None, None], axis=-1)[..., 0]
    vn = jnp.linalg.norm(v, axis=-1, keepdims=True)
    degenerate = (vn[..., 0] < 1e-12) | (p < 1e-12)
    fallback = jnp.zeros_like(v).at[..., 2].set(1.0)
    v = jnp.where(degenerate[..., None], fallback,
                  v / jnp.maximum(vn, 1e-30))
    return evals, v


def sym_eig2_smallest(A: jax.Array) -> Tuple[jax.Array, jax.Array]:
    """Smallest-eigenvalue eigenvector of symmetric A [..., 2, 2]."""
    a = A[..., 0, 0]
    b = A[..., 0, 1]
    c = A[..., 1, 1]
    tr = a + c
    d = jnp.sqrt(jnp.maximum((a - c) ** 2 + 4 * b * b, 0.0))
    l0 = (tr - d) / 2.0
    l1 = (tr + d) / 2.0
    evals = jnp.stack([l0, l1], axis=-1)
    theta = 0.5 * jnp.arctan2(2 * b, a - c)  # principal (largest) direction
    v = jnp.stack([-jnp.sin(theta), jnp.cos(theta)], axis=-1)
    return evals, v

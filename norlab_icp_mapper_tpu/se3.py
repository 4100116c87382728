"""SE(3)/SE(2) rigid-transform utilities (JAX, float32).

JAX replacement for the reference's ``RigidTransformation`` usage
(``Mapper.cpp:22,197,221``, ``Map.cpp:14,523-525``): apply a homogeneous
(D+1)x(D+1) transform to point positions and rotate covariant descriptors
(normals), plus the exp/log maps needed by the Gauss-Newton minimizer that
replaces libpointmatcher's error minimizers.

All functions are jit-friendly (static shapes, no Python branching on traced
values).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

__all__ = [
    "apply", "apply_points", "exp_se3", "log_se3", "exp_se2",
    "quat_to_rot", "compose", "inverse", "identity",
]


def identity(dim: int = 3) -> jax.Array:
    return jnp.eye(dim + 1, dtype=jnp.float32)


def inverse(T: jax.Array) -> jax.Array:
    """Closed-form inverse of a rigid homogeneous transform."""
    d = T.shape[-1] - 1
    R = T[..., :d, :d]
    t = T[..., :d, d]
    Rt = jnp.swapaxes(R, -1, -2)
    ti = -(Rt @ t[..., None])[..., 0]
    top = jnp.concatenate([Rt, ti[..., None]], axis=-1)
    bottom = jnp.zeros_like(T[..., :1, :]).at[..., 0, d].set(1.0)
    return jnp.concatenate([top, bottom], axis=-2)


def compose(A: jax.Array, B: jax.Array) -> jax.Array:
    return A @ B


def apply_points(T: jax.Array, points: jax.Array) -> jax.Array:
    """Apply (D+1)x(D+1) transform T to points [N, D]."""
    d = points.shape[-1]
    R = T[:d, :d]
    t = T[:d, d]
    return points @ R.T + t


def apply(T: jax.Array, batch):
    """Transform a PointBatch: positions map affinely; ``normals`` (and any
    descriptor listed in ``_COVARIANT``) rotate (reference
    ``RigidTransformation`` rotates covariant descriptors too)."""
    d = batch.dim
    R = T[:d, :d]
    new_pos = apply_points(T, batch.positions)
    desc = dict(batch.descriptors)
    for name in _COVARIANT:
        if name in desc and desc[name].shape[1] == d:
            desc[name] = desc[name] @ R.T
    return batch.replace(positions=new_pos, descriptors=desc)


_COVARIANT = ("normals", "observationDirections")


def _skew(w: jax.Array) -> jax.Array:
    wx, wy, wz = w[0], w[1], w[2]
    z = jnp.zeros((), w.dtype)
    return jnp.array([[z, -wz, wy], [wz, z, -wx], [-wy, wx, z]])


def exp_se3(xi: jax.Array) -> jax.Array:
    """SE(3) exponential map. ``xi = [v(3), w(3)]`` -> 4x4 transform.

    Uses Rodrigues with small-angle-safe Taylor branches (jnp.where), so it
    is differentiable and jit-safe at theta=0.
    """
    v, w = xi[:3], xi[3:]
    theta2 = jnp.dot(w, w)
    small = theta2 < 1e-4  # theta < 0.01: Taylor beats f32 trig cancellation
    # safe-where: sanitize the argument of the non-small branch so reverse-
    # and forward-mode AD never see 0/0 (both branches are differentiated)
    theta2_safe = jnp.where(small, 1.0, theta2)
    theta_safe = jnp.sqrt(theta2_safe)
    W = _skew(w)
    W2 = W @ W
    half = 0.5 * theta_safe
    A = jnp.where(small, 1.0 - theta2 / 6.0,
                  jnp.sin(theta_safe) / theta_safe)
    # half-angle form: 1 - cos t = 2 sin^2(t/2), cancellation-free in f32
    B = jnp.where(small, 0.5 - theta2 / 24.0,
                  2.0 * jnp.sin(half) * jnp.sin(half) / theta2_safe)
    C = jnp.where(small, 1.0 / 6.0 - theta2 / 120.0, (1.0 - A) / theta2_safe)
    R = jnp.eye(3, dtype=xi.dtype) + A * W + B * W2
    V = jnp.eye(3, dtype=xi.dtype) + B * W + C * W2
    t = V @ v
    T = jnp.eye(4, dtype=xi.dtype)
    T = T.at[:3, :3].set(R).at[:3, 3].set(t)
    return T


def log_se3(T: jax.Array) -> jax.Array:
    """SE(3) log map: 4x4 -> [v(3), w(3)]. Small-angle safe."""
    R = T[:3, :3]
    t = T[:3, 3]
    # angle via atan2(sin, cos): well-conditioned at theta≈0, unlike arccos
    # (arccos loses ~sqrt(eps) there, ~3e-4 in float32)
    w_hat = jnp.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    s2 = jnp.dot(w_hat, w_hat)
    small = s2 < 4e-4  # theta < 0.01: Taylor beats f32 trig cancellation
    s2_safe = jnp.where(small, 1.0, s2)
    sin_theta = 0.5 * jnp.sqrt(s2_safe)  # poisoned in the small branch
    cos_theta = jnp.clip((jnp.trace(R) - 1.0) / 2.0, -1.0, 1.0)
    theta_big = jnp.arctan2(sin_theta, cos_theta)
    # the small branch must avoid sqrt(s2): d/ds2 sqrt blows up at 0 and
    # poisons AD. Downstream small-branch math only needs theta^2 = s2/4.
    theta2 = jnp.where(small, 0.25 * s2, theta_big * theta_big)
    theta_safe = jnp.where(small, 1.0, theta_big)
    scale = jnp.where(small, 0.5 + theta2 / 12.0,
                      theta_safe / (2.0 * jnp.sin(theta_safe)))
    w = scale * w_hat
    W = _skew(w)
    W2 = W @ W
    half = 0.5 * theta_safe
    A = jnp.where(small, 1.0 - theta2 / 6.0, jnp.sin(theta_safe) / theta_safe)
    # half-angle form avoids 1-cos cancellation (NaN source at theta~2e-4)
    B = jnp.where(small, 0.5 - theta2 / 24.0,
                  2.0 * jnp.sin(half) * jnp.sin(half)
                  / (theta_safe * theta_safe))
    # V^{-1} = I - W/2 + (1/theta^2)(1 - A/(2B)) W^2
    coef = jnp.where(small, 1.0 / 12.0 + theta2 / 720.0,
                     (1.0 - A / (2.0 * B)) / (theta_safe * theta_safe))
    Vinv = jnp.eye(3, dtype=T.dtype) - 0.5 * W + coef * W2
    v = Vinv @ t
    return jnp.concatenate([v, w])


def exp_se2(xi: jax.Array) -> jax.Array:
    """SE(2) exponential map. ``xi = [vx, vy, w]`` -> 3x3 transform."""
    v = xi[:2]
    w = xi[2]
    c, s = jnp.cos(w), jnp.sin(w)
    R = jnp.array([[c, -s], [s, c]], dtype=xi.dtype)
    small = jnp.abs(w) < 1e-2
    w_safe = jnp.where(small, 1.0, w)
    A = jnp.where(small, 1.0 - w * w / 6.0, jnp.sin(w_safe) / w_safe)
    B = jnp.where(small, w / 2.0,
                  2.0 * jnp.sin(0.5 * w_safe) * jnp.sin(0.5 * w_safe) / w_safe)
    V = jnp.array([[A, -B], [B, A]], dtype=xi.dtype)
    t = V @ v
    T = jnp.eye(3, dtype=xi.dtype)
    T = T.at[:2, :2].set(R).at[:2, 2].set(t)
    return T


def quat_to_rot(q: jax.Array) -> jax.Array:
    """Quaternion (x, y, z, w) -> 3x3 rotation (normalizes first).

    Matches the convention of the reference example driver
    (``examples/build_map_from_scans_and_trajectory.cpp:167-169``, ROS order).
    """
    q = q / jnp.linalg.norm(q)
    x, y, z, w = q[0], q[1], q[2], q[3]
    return jnp.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
        [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
        [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
    ], dtype=q.dtype)

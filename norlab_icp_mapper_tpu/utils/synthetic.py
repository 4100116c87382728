"""Seeded street scene, lidar scans and trajectory for benchmarks and
smoke runs.

The scene is a street along +x: ground, two building walls, aperiodic
pillars and box-shaped clutter.  Walls and ground alone leave the
along-street direction unconstrained (a point-to-plane solve slides along
the corridor), and REGULAR pillars alias (a slide of one spacing re-aligns
them), so pillar positions, sizes and the clutter are random.

The sensor drives down the street at ``speed`` m per scan, weaving gently
(so yaw changes too), stamped at ``rate_hz``.  Each scan draws
``points_per_scan`` points from the scene's dense surface cloud within
``sensor_range`` of the sensor, adds range noise, and is returned in the
sensor frame.  The scan width defaults to the bundled example's (41,400
points per scan, ROADMAP S1).
"""
from __future__ import annotations

from typing import List, NamedTuple

import numpy as np

__all__ = ["Sequence", "make_sequence", "perturb_poses"]

SENSOR_HEIGHT = 1.8  # m above ground
HALF_WIDTH = 6.0  # walls at y = +-HALF_WIDTH
WALL_HEIGHT = 4.0
# world offset of the street: keeps the ground and walls off the boundaries
# of a world-anchored voxel grid (multiples of 0.1 or 0.15 m), where range
# noise would split one surface over two voxel layers and the map size
# would hinge on millimetre pose differences
ORIGIN = np.array([0.0, 0.0733, 0.0517])


class Sequence(NamedTuple):
    scans: List[np.ndarray]  # f32 [points_per_scan, 3], sensor frame
    poses: List[np.ndarray]  # f32 [4, 4] sensor -> world, ground truth
    stamps_ns: List[int]


def _rect(rng, n, origin, u, v):
    """n uniform points on the parallelogram origin + a*u + b*v."""
    a = rng.random((n, 1))
    b = rng.random((n, 1))
    return origin + a * np.asarray(u) + b * np.asarray(v)


def _scene(rng, x0: float, x1: float, density: float) -> np.ndarray:
    """Dense surface cloud of the street between x0 and x1 (points/m^2 =
    ``density``)."""
    length = x1 - x0
    out = []

    def n_of(area):
        return max(int(area * density), 1)

    w = HALF_WIDTH
    out.append(_rect(rng, n_of(length * 2 * w), [x0, -w, 0.0],
                     [length, 0, 0], [0, 2 * w, 0]))
    for sign in (-1.0, 1.0):
        out.append(_rect(rng, n_of(length * WALL_HEIGHT),
                         [x0, sign * w, 0.0], [length, 0, 0],
                         [0, 0, WALL_HEIGHT]))
    # aperiodic pillars: ~1 per 2 m of street, random side/offset/size
    for x in np.sort(rng.uniform(x0, x1, int(length / 2))):
        side = rng.choice([-1.0, 1.0])
        y = side * rng.uniform(2.0, w - 1.0)
        rad = rng.uniform(0.1, 0.5)
        height = rng.uniform(1.0, 4.0)
        n = n_of(2 * np.pi * rad * height)
        ang = rng.uniform(0, 2 * np.pi, n)
        out.append(np.stack([x + rad * np.cos(ang), y + rad * np.sin(ang),
                             rng.uniform(0, height, n)], 1))
    # box clutter (parked cars, kiosks): 5 faces each, random yaw
    for x in rng.uniform(x0, x1, int(length / 6)):
        side = rng.choice([-1.0, 1.0])
        c = np.array([x, side * rng.uniform(3.0, w - 1.5), 0.0])
        sx, sy, sz = rng.uniform(1.0, 4.0), rng.uniform(0.8, 2.0), \
            rng.uniform(0.8, 2.0)
        yaw = rng.uniform(0, np.pi)
        R = np.array([[np.cos(yaw), -np.sin(yaw), 0],
                      [np.sin(yaw), np.cos(yaw), 0], [0, 0, 1]])
        ex, ey, ez = R @ [sx, 0, 0], R @ [0, sy, 0], np.array([0, 0, sz])
        base = c - ex / 2 - ey / 2
        faces = [(base, ex, ey, sx * sy), (base + ez, ex, ey, sx * sy),
                 (base, ex, ez, sx * sz), (base + ey, ex, ez, sx * sz),
                 (base, ey, ez, sy * sz), (base + ex, ey, ez, sy * sz)]
        for o, u, v, area in faces[1:]:
            out.append(_rect(rng, n_of(area), o, u, v))
    return np.concatenate(out).astype(np.float64)


def _pose(x: float, y: float, yaw: float) -> np.ndarray:
    c, s = np.cos(yaw), np.sin(yaw)
    T = np.eye(4)
    T[:3, :3] = [[c, -s, 0], [s, c, 0], [0, 0, 1]]
    T[:3, 3] = ORIGIN + [x, y, SENSOR_HEIGHT]
    return T


def make_sequence(seed: int = 0, n_scans: int = 40,
                  points_per_scan: int = 41_400, speed: float = 1.0,
                  rate_hz: float = 10.0, sensor_range: float = 25.0,
                  noise_m: float = 0.01) -> Sequence:
    """A seeded street drive: ``n_scans`` scans of exactly
    ``points_per_scan`` points, ``speed`` m apart, stamped at
    ``rate_hz``."""
    rng = np.random.default_rng(seed)
    length = (n_scans - 1) * speed
    # enough surface density that every scan draws distinct points
    area_in_range = 2 * sensor_range * (2 * HALF_WIDTH + 2 * WALL_HEIGHT)
    density = 4.0 * points_per_scan / area_in_range
    world = _scene(rng, -sensor_range, length + sensor_range, density) \
        + ORIGIN

    xs = np.arange(n_scans) * speed
    ys = 0.8 * np.sin(xs / 9.0)
    yaws = np.arctan2(0.8 / 9.0 * np.cos(xs / 9.0), 1.0)
    scans, poses, stamps = [], [], []
    order = np.argsort(world[:, 0])
    world_x = world[order, 0]
    for i, (x, y, yaw) in enumerate(zip(xs, ys, yaws)):
        T = _pose(x, y, yaw)
        lo, hi = np.searchsorted(world_x, [x - sensor_range,
                                           x + sensor_range])
        cand = world[order[lo:hi]]
        d = np.linalg.norm(cand - T[:3, 3], axis=1)
        cand = cand[d < sensor_range]
        pick = rng.choice(len(cand), points_per_scan,
                          replace=len(cand) < points_per_scan)
        pts = cand[pick]
        # range noise along the beam
        ray = pts - T[:3, 3]
        rng_ = np.linalg.norm(ray, axis=1, keepdims=True)
        pts = pts + ray / np.maximum(rng_, 1e-9) * rng.normal(
            0, noise_m, (points_per_scan, 1))
        local = (pts - T[:3, 3]) @ T[:3, :3]
        scans.append(local.astype(np.float32))
        poses.append(T.astype(np.float32))
        stamps.append(int(round(i * 1e9 / rate_hz)))
    return Sequence(scans, poses, stamps)


def perturb_poses(poses, sigma_t: float = 0.10, sigma_r_deg: float = 1.5,
                  seed: int = 7) -> List[np.ndarray]:
    """Pose priors with known noise: every pose but the first (the map
    anchor) is left-multiplied by ``exp`` of a Gaussian twist (sigma_t m
    per axis, sigma_r_deg per axis)."""
    import jax.numpy as jnp
    from .. import se3
    rng = np.random.default_rng(seed)
    sigma_r = np.deg2rad(sigma_r_deg)
    out = [np.asarray(poses[0], np.float32)]
    for p in poses[1:]:
        xi = np.concatenate([rng.normal(0, sigma_t, 3),
                             rng.normal(0, sigma_r, 3)]).astype(np.float32)
        dT = np.asarray(se3.exp_se3(jnp.asarray(xi)), np.float32)
        out.append(dT @ np.asarray(p, np.float32))
    return out

"""Radius-PCA op (ops/pca.py) vs a NumPy oracle, plus the SurfaceNormal
radius mode built on it."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from norlab_icp_mapper_tpu.ops.pca import (
    radius_pca, radius_pca_xla, _radius_pca_sweep)
from norlab_icp_mapper_tpu.points import PointBatch
from norlab_icp_mapper_tpu.filters.core import filter_registry


def numpy_radius_stats(q, r, qmask, rmask, radius):
    n, d = q.shape
    cnt = np.zeros(n, np.float64)
    mean = np.zeros((n, d), np.float64)
    cov = np.zeros((n, d, d), np.float64)
    for i in range(n):
        if not qmask[i]:
            continue
        dist2 = np.sum((r - q[i]) ** 2, axis=1)
        sel = rmask & (dist2 <= radius * radius)
        if sel.sum() == 0:
            continue
        pts = r[sel]
        cnt[i] = sel.sum()
        mean[i] = pts.mean(axis=0)
        c = pts - mean[i]
        cov[i] = c.T @ c / sel.sum()
    return cnt, mean, cov


@pytest.mark.parametrize("dim", [2, 3])
def test_xla_oracle_matches_numpy(rng, dim):
    q = rng.normal(size=(150, dim)).astype(np.float32) * 3
    r = rng.normal(size=(400, dim)).astype(np.float32) * 3
    qm = rng.random(150) > 0.1
    rm = rng.random(400) > 0.1
    cnt, mean, cov = radius_pca_xla(
        jnp.asarray(q), jnp.asarray(r), jnp.asarray(qm), jnp.asarray(rm),
        max_radius=1.0)
    cnt_o, mean_o, cov_o = numpy_radius_stats(q, r, qm, rm, 1.0)
    np.testing.assert_allclose(np.asarray(cnt), cnt_o, atol=1e-3)
    np.testing.assert_allclose(np.asarray(mean), mean_o, atol=1e-4)
    np.testing.assert_allclose(np.asarray(cov), cov_o, atol=1e-4)


def test_sweep_matches_oracle(rng):
    q = rng.normal(size=(500, 3)).astype(np.float32) * 10
    r = rng.normal(size=(900, 3)).astype(np.float32) * 10
    qm = rng.random(500) > 0.2
    rm = rng.random(900) > 0.2
    cnt_x, mean_x, cov_x = radius_pca_xla(
        jnp.asarray(q), jnp.asarray(r), jnp.asarray(qm), jnp.asarray(rm),
        max_radius=2.0)
    cnt_s, mean_s, cov_s, overflow = _radius_pca_sweep(
        jnp.asarray(q), jnp.asarray(r), jnp.asarray(qm), jnp.asarray(rm),
        max_radius=2.0, q_tile=128, W=900, use_pallas=False)
    assert int(overflow) == 0
    np.testing.assert_allclose(np.asarray(cnt_s), np.asarray(cnt_x),
                               atol=1e-3)
    np.testing.assert_allclose(np.asarray(mean_s), np.asarray(mean_x),
                               atol=1e-3)
    np.testing.assert_allclose(np.asarray(cov_s), np.asarray(cov_x),
                               atol=1e-3)


def test_sweep_overflow_counter(rng):
    # all points in one thin x-slab: window W smaller than the candidate
    # span must report overflow
    pts = rng.normal(size=(600, 3)).astype(np.float32)
    pts[:, 0] *= 0.01  # x collapsed -> every ref is a candidate of any tile
    q = jnp.asarray(pts)
    _, _, _, overflow = _radius_pca_sweep(
        q, q, jnp.ones(600, bool), jnp.ones(600, bool),
        max_radius=1.0, q_tile=128, W=256, use_pallas=False)
    assert int(overflow) > 0


@pytest.mark.parametrize("dim", [2, 3])
def test_triton_kernel_matches_oracle_interpret(rng, dim):
    q = rng.normal(size=(300, dim)).astype(np.float32) * 4
    r = rng.normal(size=(700, dim)).astype(np.float32) * 4
    qm = rng.random(300) > 0.1
    rm = rng.random(700) > 0.1
    cnt_x, mean_x, cov_x = radius_pca_xla(
        jnp.asarray(q), jnp.asarray(r), jnp.asarray(qm), jnp.asarray(rm),
        max_radius=1.5)
    cnt_p, mean_p, cov_p, overflow = _radius_pca_sweep(
        jnp.asarray(q), jnp.asarray(r), jnp.asarray(qm), jnp.asarray(rm),
        max_radius=1.5, W=700, use_pallas=True, interpret=True)
    assert int(overflow) == 0
    np.testing.assert_allclose(np.asarray(cnt_p), np.asarray(cnt_x),
                               atol=1e-3)
    np.testing.assert_allclose(np.asarray(mean_p), np.asarray(mean_x),
                               atol=1e-3)
    np.testing.assert_allclose(np.asarray(cov_p), np.asarray(cov_x),
                               atol=1e-3)


def test_radius_pca_centering_far_from_origin(rng):
    # clouds far from the origin: the internal centering must keep the
    # covariance accurate (naive sxx - mean^2 in f32 would be garbage)
    base = np.array([5000.0, -3000.0, 800.0], np.float32)
    local = rng.normal(size=(200, 3)).astype(np.float32) * 0.5
    pts = jnp.asarray(base + local)
    cnt, mean, cov, _ = radius_pca(pts, pts, max_radius=1.0)
    cnt_o, mean_o, cov_o = numpy_radius_stats(
        np.asarray(pts, np.float64), np.asarray(pts, np.float64),
        np.ones(200, bool), np.ones(200, bool), 1.0)
    np.testing.assert_allclose(np.asarray(cnt), cnt_o, atol=1e-2)
    np.testing.assert_allclose(np.asarray(mean), mean_o, rtol=1e-5)
    np.testing.assert_allclose(np.asarray(cov), cov_o, atol=2e-3)


def test_surface_normal_radius_mode_planar(rng):
    # points on the z=0 plane -> normals must be +/-z
    xy = rng.uniform(-5, 5, size=(800, 2)).astype(np.float32)
    pos = np.concatenate([xy, np.zeros((800, 1), np.float32)], axis=1)
    batch = PointBatch.from_numpy(pos)
    f = filter_registry.create("SurfaceNormalDataPointsFilter",
                               {"knn": 5, "maxDist": 1.5})
    out = f.apply(batch)
    normals = np.asarray(out.descriptors["normals"])[np.asarray(out.mask)]
    np.testing.assert_allclose(np.abs(normals[:, 2]), 1.0, atol=1e-3)
    np.testing.assert_allclose(normals[:, :2], 0.0, atol=1e-2)


def test_surface_normal_radius_mode_degenerate(rng):
    # isolated points (no neighbors in radius beyond self) -> +z fallback
    pos = np.array([[0, 0, 0], [100, 0, 0], [0, 100, 0]], np.float32)
    batch = PointBatch.from_numpy(pos)
    f = filter_registry.create("SurfaceNormalDataPointsFilter",
                               {"knn": 3, "maxDist": 1.0})
    out = f.apply(batch)
    normals = np.asarray(out.descriptors["normals"])[:3]
    np.testing.assert_allclose(normals, [[0, 0, 1]] * 3, atol=1e-6)


def test_surface_normal_radius_densities(rng):
    pos = rng.uniform(-2, 2, size=(500, 3)).astype(np.float32)
    batch = PointBatch.from_numpy(pos)
    f = filter_registry.create(
        "SurfaceNormalDataPointsFilter",
        {"knn": 5, "maxDist": 1.0, "keepDensities": 1, "keepNormals": 0})
    out = f.apply(batch)
    dens = np.asarray(out.descriptors["densities"])[:500, 0]
    # interior density ~ n_points / volume of the cube
    interior = np.all(np.abs(pos) < 1.0, axis=1)
    expect = 500 / 4.0 ** 3
    assert np.median(dens[interior]) == pytest.approx(expect, rel=0.35)

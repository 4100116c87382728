"""The seeded street drive (utils/synthetic.py)."""
import numpy as np

from norlab_icp_mapper_tpu.utils.synthetic import (make_sequence,
                                                   perturb_poses)


def test_seeded_and_full_width():
    a = make_sequence(seed=5, n_scans=3)
    b = make_sequence(seed=5, n_scans=3)
    c = make_sequence(seed=6, n_scans=3)
    assert len(a.scans) == 3
    for sa, sb, sc in zip(a.scans, b.scans, c.scans):
        assert sa.shape == (41_400, 3) and sa.dtype == np.float32
        np.testing.assert_array_equal(sa, sb)
        assert not np.array_equal(sa, sc)
    for pa, pb in zip(a.poses, b.poses):
        np.testing.assert_array_equal(pa, pb)


def test_trajectory_and_stamps():
    seq = make_sequence(seed=0, n_scans=5, points_per_scan=1000,
                        sensor_range=20.0)
    assert seq.stamps_ns == [0, 100_000_000, 200_000_000, 300_000_000,
                             400_000_000]  # 10 Hz
    xyz = np.stack([p[:3, 3] for p in seq.poses])
    steps = np.linalg.norm(np.diff(xyz, axis=0), axis=1)
    assert np.all((steps > 0.99) & (steps < 1.05))  # ~1 m apart
    for scan in seq.scans:
        r = np.linalg.norm(scan, axis=1)
        assert r.max() < 20.1 and np.all(np.isfinite(scan))


def test_perturb_poses_scale():
    poses = make_sequence(seed=0, n_scans=30, points_per_scan=100).poses
    noisy = perturb_poses(poses, sigma_t=0.10, sigma_r_deg=1.5, seed=7)
    np.testing.assert_array_equal(noisy[0], poses[0])  # map anchor
    dt = np.array([np.linalg.norm(n[:3, 3] - p[:3, 3])
                   for n, p in zip(noisy[1:], poses[1:])])
    assert 0.05 < np.sqrt(np.mean(dt ** 2)) < 0.6
    again = perturb_poses(poses, sigma_t=0.10, sigma_r_deg=1.5, seed=7)
    for a, b in zip(noisy, again):
        np.testing.assert_array_equal(a, b)

"""Triton sweep kernels compiled for the card against their plain XLA
references (the comparisons phase 2 of chip_smoke.py makes at full width).
Skipped without a GPU; run on a card with

    JAX_PLATFORMS=cuda python -m pytest -m gpu tests/
"""
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def street():
    import chip_smoke
    from norlab_icp_mapper_tpu.utils.synthetic import make_sequence
    seq = make_sequence(seed=1, n_scans=12, points_per_scan=20_000)
    T = seq.poses[6]
    scan = (seq.scans[6] @ T[:3, :3].T + T[:3, 3]).astype(np.float32)
    return scan, chip_smoke.decimated_map(seq)


@pytest.mark.parametrize("k", [1, 3, 6])
def test_matcher_kernel_on_card(gpu, street, k):
    import chip_smoke
    scan, ref = street
    obs = chip_smoke.check_matcher(scan, ref, k, 2.0)
    assert obs["agreement"] == 1.0


def test_angular_kernel_on_card(gpu, rng):
    """2-D inputs, as the DynamicPoints (azimuth, elevation) 1-NN."""
    import chip_smoke
    q = rng.uniform(-3, 3, (30_000, 2)).astype(np.float32)
    r = rng.uniform(-3, 3, (30_000, 2)).astype(np.float32)
    obs = chip_smoke.check_matcher(q, r, 1, 0.02)
    assert obs["agreement"] == 1.0


def test_pca_kernel_on_card(gpu, street):
    import chip_smoke
    _, ref = street
    obs = chip_smoke.check_pca(ref, 1.0)
    assert obs["normal_worst_deg"] <= 0.5

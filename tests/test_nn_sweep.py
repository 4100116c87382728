import numpy as np
import jax.numpy as jnp
import pytest

from norlab_icp_mapper_tpu.ops.nn import _knn_xla
from norlab_icp_mapper_tpu.ops.nn_sweep import sweep_knn


def test_sweep_matches_bruteforce(rng):
    q = jnp.asarray(rng.uniform(-30, 30, size=(700, 3)).astype(np.float32))
    r = jnp.asarray(rng.uniform(-30, 30, size=(3000, 3)).astype(np.float32))
    d_s, i_s, ov = sweep_knn(q, r, k=3, max_radius=2.0, q_tile=128,
                             W=2048, use_pallas=False)
    assert int(ov) == 0
    d_b, i_b = _knn_xla(q, r, k=3, max_radius=jnp.float32(2.0))
    np.testing.assert_array_equal(np.asarray(i_s), np.asarray(i_b))
    both = np.isfinite(np.asarray(d_b))
    np.testing.assert_allclose(np.asarray(d_s)[both], np.asarray(d_b)[both],
                               rtol=1e-3, atol=1e-4)


def test_sweep_masks(rng):
    q = jnp.asarray(np.array([[0, 0, 0], [50, 0, 0]], np.float32))
    r = jnp.asarray(np.array([[0.5, 0, 0], [0.1, 0, 0], [49.9, 0, 0]],
                             np.float32))
    rmask = jnp.asarray([True, False, True])
    qmask = jnp.asarray([True, False])
    d, i, _ = sweep_knn(q, r, query_mask=qmask, ref_mask=rmask, k=1,
                        max_radius=1.0, q_tile=128, W=256, use_pallas=False)
    assert int(i[0, 0]) == 0  # masked nearer ref excluded
    assert int(i[1, 0]) == -1  # masked query


def test_sweep_2d(rng):
    q = jnp.asarray(rng.uniform(-10, 10, size=(200, 2)).astype(np.float32))
    r = jnp.asarray(rng.uniform(-10, 10, size=(800, 2)).astype(np.float32))
    d_s, i_s, _ = sweep_knn(q, r, k=2, max_radius=1.5, q_tile=128,
                            W=1024, use_pallas=False)
    d_b, i_b = _knn_xla(q, r, k=2, max_radius=jnp.float32(1.5))
    np.testing.assert_array_equal(np.asarray(i_s), np.asarray(i_b))


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("k", [1, 3, 6])
def test_sweep_triton_interpret(rng, k, dim):
    """The Triton sweep kernel (Pallas interpreter) against the brute-force
    XLA oracle, with query/ref masks and the radius cap."""
    q = jnp.asarray(rng.uniform(-5, 5, size=(700, dim)).astype(np.float32))
    r = jnp.asarray(rng.uniform(-5, 5, size=(1500, dim)).astype(np.float32))
    qm = jnp.asarray(rng.random(700) > 0.1)
    rm = jnp.asarray(rng.random(1500) > 0.1)
    d_s, i_s, ov = sweep_knn(q, r, qm, rm, k=k, max_radius=1.0, W=1024,
                             use_pallas=True, interpret=True)
    assert int(ov) == 0
    d_b, i_b = _knn_xla(q, r, qm, rm, k=k, max_radius=jnp.float32(1.0))
    d_s, i_s, d_b, i_b = map(np.asarray, (d_s, i_s, d_b, i_b))
    # the kernel's subtract-first d2 and the oracle's expanded form differ
    # in the last bits: near-ties may swap and pairs at d2 ~ radius^2 may
    # flip in/out of the cap; compare away from the boundary shell
    interior = np.isfinite(d_b) & (np.abs(d_b - 1.0) > 1e-4)
    np.testing.assert_allclose(d_s[interior], d_b[interior], atol=1e-4)
    assert (i_s == i_b)[interior].mean() > 0.999
    # masked queries get nothing; masked refs never surface
    assert np.all(i_s[~np.asarray(qm)] == -1)
    assert not np.isin(i_s[i_s >= 0], np.where(~np.asarray(rm))[0]).any()
    # every reported distance is the true distance of its index
    qn, rn = np.asarray(q), np.asarray(r)
    hit = i_s >= 0
    rows = np.nonzero(hit)[0]
    true = np.sum((qn[rows] - rn[i_s[hit]]) ** 2, axis=1)
    np.testing.assert_allclose(d_s[hit], true, atol=1e-5)
    assert np.all(d_s[hit] <= 1.0)


def test_sweep_triton_interpret_overflow(rng):
    # x collapsed: every ref is a candidate for every tile, span >> W;
    # overflowing tiles still return radius-verified neighbours
    pts = rng.normal(size=(600, 3)).astype(np.float32)
    pts[:, 0] *= 0.001
    q = jnp.asarray(pts)
    d, i, ov = sweep_knn(q, q, k=1, max_radius=1.0, W=256, use_pallas=True,
                         interpret=True)
    assert int(ov) > 0
    assert np.all(np.asarray(d)[np.asarray(i) >= 0] <= 1.0)


def test_sweep_overflow_reported(rng):
    # x collapsed: every ref is a candidate for every tile, span >> W
    pts = rng.normal(size=(600, 3)).astype(np.float32)
    pts[:, 0] *= 0.001
    q = jnp.asarray(pts)
    _, _, ov = sweep_knn(q, q, k=1, max_radius=1.0, q_tile=128, W=256,
                         use_pallas=False)
    assert int(ov) > 0


def test_presorted_matches_unsorted(rng):
    """sweep_knn(presorted=presort_ref(...)) must equal the self-sorting
    call — the fused step carries the sorted pack across scans (r4)."""
    import jax.numpy as jnp
    from norlab_icp_mapper_tpu.ops.nn_sweep import sweep_knn, presort_ref
    q = jnp.asarray(rng.uniform(-10, 10, (500, 3)).astype(np.float32))
    r = jnp.asarray(rng.uniform(-10, 10, (2000, 3)).astype(np.float32))
    qm = jnp.asarray(rng.random(500) > 0.1)
    rm = jnp.asarray(rng.random(2000) > 0.1)
    d0, i0, o0 = sweep_knn(q, r, qm, rm, k=3, max_radius=1.5,
                           q_tile=128, W=512, use_pallas=False)
    pre = presort_ref(r, rm)
    d1, i1, o1 = sweep_knn(q, r, qm, rm, k=3, max_radius=1.5,
                           q_tile=128, W=512, use_pallas=False,
                           presorted=pre)
    np.testing.assert_array_equal(np.asarray(i0), np.asarray(i1))
    np.testing.assert_allclose(np.asarray(d0), np.asarray(d1), rtol=1e-6)
    assert int(o0) == int(o1)

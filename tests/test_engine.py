"""The radius-search engine chooser (ops/engine.py) and the GPU engine's
code path driven through the Mapper on the CPU (Triton kernels in the
Pallas interpreter)."""
import os

import jax
import numpy as np
import pytest

from norlab_icp_mapper_tpu.ops import engine
from norlab_icp_mapper_tpu.ops.engine import (Engine, TRITON, XLA,
                                              select_engine)


def test_cpu_selects_xla():
    assert select_engine("cpu") is XLA
    assert select_engine() is XLA  # the tests run on the CPU backend


def test_gpu_selects_triton(monkeypatch):
    assert select_engine("gpu") is TRITON
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    assert select_engine() is TRITON


@pytest.mark.parametrize("backend", ["rocm", "METAL", "neuron"])
def test_unknown_backend_raises(backend):
    with pytest.raises(ValueError, match="no radius-search engine"):
        select_engine(backend)


@pytest.mark.parametrize("eng,sweep", [(XLA, False), (TRITON, True)])
def test_engine_properties(eng, sweep):
    assert eng.sweep == sweep
    assert not eng.interpret
    hash(eng)  # static jit argument


def test_mapper_on_triton_engine_interpret(monkeypatch):
    """A tiny P2Plane drive on the GPU engine's code path: presort pack in
    the fused state, sorted-order solve, Triton matcher / PCA / angular NN
    kernels (interpreted)."""
    from norlab_icp_mapper_tpu import Mapper, PointBatch
    from norlab_icp_mapper_tpu.ops import nn_sweep, pca
    from norlab_icp_mapper_tpu.utils.metrics import ate
    from norlab_icp_mapper_tpu.utils.synthetic import (make_sequence,
                                                       perturb_poses)
    monkeypatch.setitem(engine._BY_BACKEND, "cpu",
                        Engine("triton", interpret=True))
    calls = {"knn": 0, "pca": 0}
    knn_k, pca_k = nn_sweep.sweep_knn_triton, pca.pca_sweep_triton

    def count(name, fn):
        def wrapped(*a, **kw):
            assert kw["interpret"]
            calls[name] += 1
            return fn(*a, **kw)
        return wrapped
    monkeypatch.setattr(nn_sweep, "sweep_knn_triton", count("knn", knn_k))
    monkeypatch.setattr(pca, "pca_sweep_triton", count("pca", pca_k))

    seq = make_sequence(seed=3, n_scans=4, points_per_scan=2500)
    prior = perturb_poses(seq.poses, sigma_t=0.05, sigma_r_deg=1.0)
    m = Mapper(os.path.join(os.path.dirname(__file__), "..", "examples",
                            "config_p2plane.yaml"), is_3d=True)
    for scan, pose, stamp in zip(seq.scans, prior, seq.stamps_ns):
        m.process_input(m.apply_input_filters(PointBatch.from_numpy(scan)),
                        pose, stamp, scan_valid_hint=scan.shape[0])
    assert m._fused_state is not None and "ref_sort" in m._fused_state[0]
    m.drain()
    assert m.icp._ref_presorted is not None
    assert calls["knn"] > 0 and calls["pca"] > 0
    est = np.stack([np.asarray(p)[:3, 3] for p in m.get_trajectory().poses])
    assert np.all(np.isfinite(est))
    truth = np.stack([p[:3, 3] for p in seq.poses])
    prior_xyz = np.stack([p[:3, 3] for p in prior])
    assert ate(est, truth) < ate(prior_xyz, truth)

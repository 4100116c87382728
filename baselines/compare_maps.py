#!/usr/bin/env python
"""Map parity check: our pipeline's map vs the reference-equivalent CPU
baseline on the bundled example sequence.

Reports symmetric nearest-neighbor (chamfer) distance statistics and the
trajectory ATE.  Usage:

    python baselines/compare_maps.py <our_map.vtk> [dataPath]

Trajectory ATE is 0 by construction for the example config
(IdentityErrorMinimizer on both sides); the chamfer statistics are the
parity number.
"""
import json
import os
import sys

import numpy as np
from scipy.spatial import cKDTree

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, os.path.dirname(__file__))


def main(our_map_path, data_path="/root/reference/examples/data"):
    from reference_cpu import run
    from norlab_icp_mapper_tpu.io import read_vtk
    from norlab_icp_mapper_tpu.utils.metrics import ate

    base_pos, _, base_traj, _ = run(data_path)
    ours, _ = read_vtk(our_map_path)

    d_ab, _ = cKDTree(base_pos).query(ours, k=1)
    d_ba, _ = cKDTree(ours).query(base_pos, k=1)
    result = {
        "our_points": int(ours.shape[0]),
        "baseline_points": int(base_pos.shape[0]),
        "chamfer_ours_to_base_mean_m": float(d_ab.mean()),
        "chamfer_ours_to_base_p95_m": float(np.percentile(d_ab, 95)),
        "chamfer_base_to_ours_mean_m": float(d_ba.mean()),
        "chamfer_base_to_ours_p95_m": float(np.percentile(d_ba, 95)),
    }
    traj_path = os.path.join(os.path.dirname(our_map_path), "trajectory.vtk")
    if os.path.exists(traj_path):
        tpos, _ = read_vtk(traj_path)
        ref = np.stack([p[:3, 3] for p in base_traj])
        if tpos.shape[0] == ref.shape[0]:
            result["ate_m"] = ate(tpos[:, :3], ref)
    print(json.dumps(result, indent=1))
    return result


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else "/tmp/out/map.vtk",
         sys.argv[2] if len(sys.argv) > 2 else "/root/reference/examples/data")

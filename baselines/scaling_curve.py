#!/usr/bin/env python
"""Shard-count scaling characterization of the sharded per-scan step.

This script characterizes, on the virtual CPU mesh at S = 1/2/4/8 shards,
the quantities that *determine* scaling efficiency across cards — they are
layout properties, not device-speed properties:

  step_ms        wall ms per fused sharded step (CPU: only meaningful as a
                 sanity trend on this 2-core box, NOT a speedup claim)
  balance        mean/max shard point count — the load-balance bound on NN
                 scaling efficiency (the NN stage is perfectly parallel, so
                 efficiency <= balance)
  comm_kb        bytes moved by collectives per scan (analytic, from
                 shapes): ICP pmin/psum per iteration + insert-gate pmin +
                 the halo all-gather + scalar psums
  compute_mflop  per-shard NN pair work per scan (map_points/S * scan *
                 ~8 flop) — the term the mesh divides

Usage:  python baselines/scaling_curve.py [--stride 8] [--json]

Writes nothing; paste the table into docs/Multichip.md when layouts change.
"""
import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

import numpy as np

DATA = "/root/reference/examples/data"


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--stride", type=int, default=16,
                    help="scan point subsample stride (CPU tractability)")
    ap.add_argument("--json", action="store_true")
    args = ap.parse_args()

    import jax
    jax.config.update("jax_platforms", "cpu")
    os.environ.setdefault("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in os.environ["XLA_FLAGS"]:
        os.environ["XLA_FLAGS"] += " --xla_force_host_platform_device_count=8"
    from norlab_icp_mapper_tpu.utils.compile_cache import \
        enable_compile_cache
    enable_compile_cache()

    from norlab_icp_mapper_tpu import PointBatch
    from norlab_icp_mapper_tpu.io import read_vtk, read_trajectory_csv
    from norlab_icp_mapper_tpu.parallel import (
        make_mesh, ShardedMapConfig, ShardedMapper)

    scans_dir = os.path.join(DATA, "scans")
    files = sorted(f for f in os.listdir(scans_dir) if f.endswith(".vtk"))
    rows = read_trajectory_csv(os.path.join(DATA, "icp_odom.csv"))
    scans, poses = [], []
    for f, (pose, stamp) in zip(files, rows):
        pos, _ = read_vtk(os.path.join(scans_dir, f))
        scans.append(pos[::args.stride])
        poses.append((np.asarray(pose, np.float32), stamp))

    results = []
    for S in (1, 2, 4, 8):
        cfg = ShardedMapConfig(dim=3, cell_size=4.8, voxel_size=0.15,
                               normal_radius=1.0, match_max_dist=2.0,
                               max_iter=1,
                               minimizer="IdentityErrorMinimizer",
                               update_condition="delay", update_value=0.05,
                               halo_capacity=4096)
        mapper = ShardedMapper(make_mesh(S), cfg)
        # build the map once (also warms the compile cache)
        for i, (scan, (pose, stamp)) in enumerate(zip(scans, poses)):
            mapper.process_input(PointBatch.from_numpy(scan), pose,
                                 i * 0.1)
        m = mapper.drain()

        # timed steady-state steps (re-feed scan 7)
        batch = PointBatch.from_numpy(scans[7])
        pose7 = poses[7][0]
        ts = []
        for r in range(3):
            t0 = time.perf_counter()
            mapper.process_input(batch, pose7, 10.0 + 0.1 * r)
            mapper.drain()
            ts.append(time.perf_counter() - t0)
        step_ms = float(np.median(ts)) * 1e3

        # load balance from the final state
        st = jax.device_get(mapper.state["msk"])
        per_shard = st.reshape(S, -1).sum(axis=1)
        balance = float(per_shard.mean() / max(per_shard.max(), 1))

        n_scan = scans[7].shape[0]
        n_map = int(m["count"])
        cap = mapper.state["pos"].shape[1]
        # analytic per-scan collective volume (f32 = 4 B)
        comm = (cfg.max_iter * (n_scan * 4 * 2 + (36 + 6 + 1) * 4)  # pmin+psum
                + n_scan * 4                                # insert-gate pmin
                + (S - 1) * cfg.halo_capacity * (3 + 1) * 4  # halo all-gather
                + 64)                                       # scalar psums
        mflop = n_map / S * n_scan * 8e-6
        results.append({
            "shards": S, "step_ms": round(step_ms, 1),
            "balance": round(balance, 3),
            "comm_kb_per_scan": round(comm / 1024, 1),
            "per_shard_nn_mflop": round(mflop, 1),
            "map_points": n_map, "shard_capacity": cap,
        })
        print(json.dumps(results[-1]) if args.json else results[-1],
              flush=True)


if __name__ == "__main__":
    main()

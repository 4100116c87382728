"""Grid-hash (voxel-bucket) radius-bounded KNN.

The brute-force matcher (``nn.py``) touches every (query, ref) pair — N*M
work.  For radius-capped searches (the ICP matcher's ``maxDist``, the
dynamic-points beam cone, radius-bounded normals) the XLA engine is a
*spatial hash*:

  1. bucket reference points by voxel cell (cell edge >= search radius),
     hashing the 3 int cell coords into ``H`` buckets (power of two),
  2. sort-by-bucket + searchsorted -> CSR starts, then scatter the sorted
     point ids into a dense ``[H, C]`` bucket table (C = per-bucket cap),
  3. per query: gather the 27 (or 9 in 2-D) neighbor buckets' candidates —
     ``27*C`` per query instead of M — verify real distances, k-extract.

Everything is static-shape (H, C fixed), so one compiled program serves any
cloud.  Hash collisions only ADD candidates (distances verify); bucket
overflow beyond C drops candidates — an approximation knob.  ``overflow``
output reports how many points were dropped so callers can bump C.

Exactness guarantee: with ``cell_size >= max_radius`` and no overflow, the
true k nearest within ``max_radius`` are always found.
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp

__all__ = ["grid_hash_knn", "build_grid", "GridTable"]

_P1, _P2, _P3 = 73856093, 19349663, 83492791  # classic spatial-hash primes


def _hash_cells(cells: jax.Array, H: int) -> jax.Array:
    """int32 cell coords [.., D] -> bucket id in [0, H)."""
    d = cells.shape[-1]
    h = cells[..., 0] * _P1
    if d > 1:
        h = h ^ (cells[..., 1] * _P2)
    if d > 2:
        h = h ^ (cells[..., 2] * _P3)
    return (h & (H - 1)).astype(jnp.int32)


@functools.partial(jax.jit, static_argnames=("H", "C"))
def build_grid(ref: jax.Array, ref_mask: jax.Array, cell_size,
               H: int = 1 << 15, C: int = 96):
    """Build the [H, C] bucket table for reference points.

    Returns ``(table i32[H, C] (-1 empty), overflow i32 scalar)``.
    """
    m = ref.shape[0]
    cells = jnp.floor(ref / cell_size).astype(jnp.int32)
    h = _hash_cells(cells, H)
    h = jnp.where(ref_mask, h, H)  # invalid -> sentinel bucket H (dropped)
    order = jnp.argsort(h)
    sh = h[order]
    within = jnp.arange(m, dtype=jnp.int32) - jnp.searchsorted(
        sh, sh, side="left").astype(jnp.int32)
    ok = (sh < H) & (within < C)
    table = jnp.full((H, C), -1, jnp.int32)
    # scatter only valid entries; invalid get an out-of-bounds row and are
    # dropped by mode="drop"
    safe_h = jnp.where(ok, sh, H)
    safe_w = jnp.where(ok, within, 0)
    table = table.at[safe_h, safe_w].set(order.astype(jnp.int32), mode="drop")
    overflow = jnp.sum((sh < H) & (within >= C))
    return table, overflow


def _neighbor_offsets(dim: int):
    import numpy as np
    r = [-1, 0, 1]
    if dim == 2:
        return jnp.asarray([(i, j) for i in r for j in r], dtype=jnp.int32)
    return jnp.asarray([(i, j, l) for i in r for j in r for l in r],
                       dtype=jnp.int32)


@functools.partial(jax.jit, static_argnames=("k", "H", "C", "q_tile"))
def grid_hash_knn(
    query: jax.Array,  # f32[N, D]
    ref: jax.Array,  # f32[M, D]
    table: jax.Array,  # i32[H, C] from build_grid
    cell_size,
    query_mask: Optional[jax.Array] = None,
    k: int = 1,
    max_radius=None,  # defaults to cell_size
    H: int = 1 << 15,
    C: int = 96,
    q_tile: int = 8192,
) -> Tuple[jax.Array, jax.Array]:
    """k nearest ref points within ``max_radius`` using the bucket table.

    Same output contract as ``nn.knn``: ``(d2 [N,k], idx [N,k])``,
    inf/-1 for no match.
    """
    n, dim = query.shape
    if query_mask is None:
        query_mask = jnp.ones((n,), bool)
    if max_radius is None:
        max_radius = cell_size
    offs = _neighbor_offsets(dim)  # [B, D]
    B = offs.shape[0]

    n_pad = -(-n // q_tile) * q_tile
    qp = jnp.pad(query, ((0, n_pad - n), (0, 0)))
    qm = jnp.pad(query_mask, (0, n_pad - n))
    qtiles = qp.reshape(-1, q_tile, dim)
    mtiles = qm.reshape(-1, q_tile)

    refp = jnp.concatenate([ref, jnp.full((1, dim), 1e9, ref.dtype)])  # -1 -> far

    def one_tile(args):
        q, qmask = args
        qcell = jnp.floor(q / cell_size).astype(jnp.int32)  # [T, D]
        ncells = qcell[:, None, :] + offs[None, :, :]  # [T, B, D]
        hb = _hash_cells(ncells, H)  # [T, B]
        cand = table[hb]  # [T, B, C]
        cand = cand.reshape(q_tile, B * C)
        cpos = refp[cand]  # [T, B*C, D] (-1 -> far sentinel row)
        diff = cpos - q[:, None, :]
        d2 = jnp.sum(diff * diff, axis=-1)
        valid = (cand >= 0) & qmask[:, None] & (d2 <= max_radius * max_radius)
        d2 = jnp.where(valid, d2, jnp.inf)
        # k-extraction (no sort)
        best_d = []
        best_i = []
        for t in range(k):
            m = jnp.min(d2, axis=1)
            a = jnp.argmin(d2, axis=1)
            ii = jnp.take_along_axis(cand, a[:, None], axis=1)[:, 0]
            best_d.append(m)
            best_i.append(jnp.where(jnp.isfinite(m), ii, -1))
            if t + 1 < k:
                d2 = d2.at[jnp.arange(q_tile), a].set(jnp.inf)
        return jnp.stack(best_d, axis=1), jnp.stack(best_i, axis=1)

    d, i = jax.lax.map(one_tile, (qtiles, mtiles))
    d = d.reshape(n_pad, k)[:n]
    i = i.reshape(n_pad, k)[:n]
    return d, i

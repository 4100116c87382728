"""Nearest-neighbor correspondence search: the kd-tree replacement.

The reference delegates all KNN to libnabo kd-trees (``KDTreeMatcher`` in
``examples/config.yaml:56-60``; direct ``Nabo::NNS`` at
``PointDistanceMapperModule.cpp:30-36`` and
``DynamicPointsMapperModule.cpp:75-78``).  Pointer-chasing trees map poorly
to accelerators, so unbounded k-NN here is *tiled brute force*: the [N, M]
squared distance matrix is never materialized — reference points stream
through in tiles while a running top-k per query is maintained, a
flash-attention-style schedule, all fused by XLA.  Radius-capped k-NN
(``radius_knn``) runs on the backend's engine (``ops/engine.py``).

Semantics mirror libnabo: squared distances, ``inf`` + index ``-1`` for
no-match (beyond ``max_radius`` or masked), self-matches allowed
(``ALLOW_SELF_MATCH`` is the mode both reference call sites use).
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp

__all__ = ["knn", "nn1"]

_INF = jnp.inf


def _pad_rows(x: jax.Array, target: int, fill: float = 0.0) -> jax.Array:
    n = x.shape[0]
    if n == target:
        return x
    pad = [(0, target - n)] + [(0, 0)] * (x.ndim - 1)
    return jnp.pad(x, pad, constant_values=fill)


def knn(
    query: jax.Array,  # f32[N, D]
    ref: jax.Array,  # f32[M, D]
    query_mask: Optional[jax.Array] = None,  # bool[N]
    ref_mask: Optional[jax.Array] = None,  # bool[M]
    k: int = 1,
    max_radius: Optional[jax.Array] = None,  # scalar, None = unbounded
    ref_tile: int = 4096,
) -> Tuple[jax.Array, jax.Array]:
    """k nearest reference points for every query point.

    Returns ``(dists2 f32[N, k], idx i32[N, k])`` sorted ascending per query.
    Masked-out or out-of-radius results have ``dists2 = inf`` and ``idx = -1``.
    """
    return _knn_xla(query, ref, query_mask, ref_mask, k=k,
                    max_radius=max_radius, ref_tile=ref_tile)


@functools.partial(jax.jit, static_argnames=("k", "ref_tile"))
def _knn_xla(query, ref, query_mask=None, ref_mask=None, k=1,
             max_radius=None, ref_tile: int = 4096):
    n, d = query.shape
    m = ref.shape[0]
    if query_mask is None:
        query_mask = jnp.ones((n,), bool)
    if ref_mask is None:
        ref_mask = jnp.ones((m,), bool)

    n_tiles = max(1, -(-m // ref_tile))
    m_pad = n_tiles * ref_tile
    ref_p = _pad_rows(ref, m_pad)
    ref_mask_p = _pad_rows(ref_mask, m_pad)
    ref_tiles = ref_p.reshape(n_tiles, ref_tile, d)
    ref_mask_tiles = ref_mask_p.reshape(n_tiles, ref_tile)

    q2 = jnp.sum(query * query, axis=1, keepdims=True)  # [N, 1]

    init_d = jnp.full((n, k), _INF, jnp.float32)
    init_i = jnp.full((n, k), -1, jnp.int32)

    def step(carry, inputs):
        best_d, best_i = carry
        tile_idx, r, rm = inputs
        r2 = jnp.sum(r * r, axis=1)  # [Tr]
        # [N, D] @ [D, Tr] at HIGHEST precision: the expanded form
        # q^2 + r^2 - 2qr cancels catastrophically under TF32 / bf16 passes
        cross = jnp.dot(query, r.T,
                        precision=jax.lax.Precision.HIGHEST)  # f32[N, Tr]
        d2 = q2 + r2[None, :] - 2.0 * cross
        d2 = jnp.maximum(d2, 0.0)
        d2 = jnp.where(rm[None, :], d2, _INF)
        gidx = tile_idx * ref_tile + jnp.arange(ref_tile, dtype=jnp.int32)
        # merge running top-k with this tile
        cat_d = jnp.concatenate([best_d, d2], axis=1)
        cat_i = jnp.concatenate(
            [best_i, jnp.broadcast_to(gidx[None, :], d2.shape)], axis=1)
        neg_top, argtop = jax.lax.top_k(-cat_d, k)
        best_d = -neg_top
        best_i = jnp.take_along_axis(cat_i, argtop, axis=1)
        return (best_d, best_i), None

    tile_ids = jnp.arange(n_tiles, dtype=jnp.int32)
    (best_d, best_i), _ = jax.lax.scan(
        step, (init_d, init_i), (tile_ids, ref_tiles, ref_mask_tiles))

    valid = jnp.isfinite(best_d) & query_mask[:, None]
    if max_radius is not None:
        valid = valid & (best_d <= max_radius * max_radius)
    best_d = jnp.where(valid, best_d, _INF)
    best_i = jnp.where(valid, best_i, -1)
    return best_d, best_i


def nn1(query, ref, query_mask=None, ref_mask=None, max_radius=None,
        ref_tile: int = 4096):
    """1-NN convenience wrapper: returns ``(dists2 [N], idx [N])``."""
    d2, idx = knn(query, ref, query_mask, ref_mask, k=1,
                  max_radius=max_radius, ref_tile=ref_tile)
    return d2[:, 0], idx[:, 0]


def radius_knn(query, ref, query_mask=None, ref_mask=None, k: int = 1,
               max_radius=None, gh_H: int = 1 << 15, gh_C: int = 128,
               overflow_tag: str = "", engine=None):
    """Radius-capped KNN on the backend's engine (``ops/engine.py``): the
    sorted sweep (contiguous windows, no gathers) or the spatial grid
    hash, whose 27*C candidate model is 10-100x less work than brute
    force under XLA.  Same output contract as ``knn``.

    Window/bucket overflow (degraded
    matches) is reported through ``utils.tracing.record_overflow`` under
    ``overflow_tag`` when one is given (SURVEY "no silent caps").
    """
    if max_radius is None:
        return knn(query, ref, query_mask, ref_mask, k=k)
    from .engine import select_engine
    engine = engine or select_engine()
    if engine.sweep:
        from .nn_sweep import sweep_knn
        d, idx, overflow = sweep_knn(query, ref, query_mask, ref_mask, k=k,
                                     max_radius=max_radius,
                                     use_pallas=True,
                                     interpret=engine.interpret)
    else:
        from .gridhash import build_grid, grid_hash_knn
        if ref_mask is None:
            ref_mask = jnp.ones((ref.shape[0],), bool)
        table, overflow = build_grid(ref, ref_mask, max_radius,
                                     H=gh_H, C=gh_C)
        d, idx = grid_hash_knn(query, ref, table, max_radius,
                               query_mask=query_mask, k=k,
                               max_radius=max_radius, H=gh_H, C=gh_C)
    if overflow_tag:
        from ..utils.tracing import record_overflow
        record_overflow(overflow_tag, overflow)
    return d, idx

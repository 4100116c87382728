"""Radius-neighborhood PCA statistics: the surface-normal engine.

The surface-normal pass (lpm ``SurfaceNormalDataPointsFilter``,
``examples/config.yaml:26-27``) is the single most expensive stage of the
reference's merge pipeline when reimplemented as k-NN + per-point PCA: a
top-k search pays O(k) min-extraction passes over every candidate block.
But the normal itself only needs the *covariance of the neighborhood*, not
the identity of the k nearest points.  So instead of top-k we accumulate,
per query point, the zeroth/first/second moments of all reference points
within ``max_radius``:

    cnt_i   = sum_j  w_ij
    sx_i    = sum_j  w_ij * x_j
    sxx_i   = sum_j  w_ij * x_j x_j^T          w_ij = [ |x_j - q_i|^2 <= r^2 ]

Three implementations: the brute-force XLA oracle ``radius_pca_xla``
(tiled over all N*M pairs), and the sorted sweep (``_radius_pca_sweep``)
either as XLA window slices or as the Triton kernel ``pca_sweep_triton``,
which walks each query tile's window like the matcher kernel and keeps the
moment sums in registers.

Numerical note: ``cov = sxx/cnt - mean mean^T`` cancels catastrophically
when coordinates are far from the origin (error ~ eps * |x|^2).  Callers
should center the clouds first (``radius_pca`` does this with the query
cloud's masked mean); with local windows of a few hundred meters the
residual error is <1e-3 m^2, far below lidar surface variance.

Semantics vs lpm: lpm fits the PCA to the k nearest neighbors (radius-capped
when maxDist is set); this op fits it to *all* neighbors within the radius.
On a decimated map (points ~0.15 m apart, radius 2 m) both see the same
local surface; the radius form is smoother and has no k-NN tie noise.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from .nn_sweep import (BIG, NUM_STAGES, NUM_WARPS, TQ, TR, W_MAX, planar,
                       sweep_window_walk, tile_windows)

__all__ = ["radius_pca", "radius_pca_xla", "pca_sweep_triton"]


def _n_moments(dim: int) -> int:
    # 1 (count) + D (sum) + D*(D+1)/2 (upper-triangular second moments)
    return 1 + dim + dim * (dim + 1) // 2


def _moment_rows(x, dim: int) -> list:
    """Moment rows ``[1, x_a, x_a^2, x_a x_b (a<b)]`` of points given as
    planar coordinate rows ``x[a]`` (each [T])."""
    rows = [jnp.ones_like(x[0])]
    rows += [x[a] for a in range(dim)]
    rows += [x[a] * x[a] for a in range(dim)]
    for a in range(dim):
        for b in range(a + 1, dim):
            rows.append(x[a] * x[b])
    return rows


def _unpack_stats(acc: jax.Array, dim: int):
    """acc [n_moments, N] -> (cnt [N], mean [N, D], cov [N, D, D])."""
    cnt = acc[0]
    safe = jnp.maximum(cnt, 1.0)
    mean = (acc[1:1 + dim] / safe).T  # [N, D]
    m2 = acc[1 + dim:1 + 2 * dim] / safe  # diag, [D, N]
    cov = jnp.zeros((acc.shape[1], dim, dim), jnp.float32)
    for a in range(dim):
        cov = cov.at[:, a, a].set(m2[a] - mean[:, a] * mean[:, a])
    r = 1 + 2 * dim
    for a in range(dim):
        for b in range(a + 1, dim):
            off = acc[r] / safe - mean[:, a] * mean[:, b]
            cov = cov.at[:, a, b].set(off)
            cov = cov.at[:, b, a].set(off)
            r += 1
    return cnt, mean, cov


# --------------------------------------------------------------------------
# XLA oracle (portable; used on CPU backends and as the test reference)
# --------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnames=("ref_tile",))
def radius_pca_xla(query, ref, query_mask=None, ref_mask=None,
                   max_radius=1.0, ref_tile: int = 4096):
    """Per-query radius-neighborhood moments, tiled XLA implementation.

    Returns ``(cnt f32[N], mean f32[N, D], cov f32[N, D, D])``.  Queries with
    no neighbor in range get cnt=0, mean=0, cov=0.
    """
    n, dim = query.shape
    m = ref.shape[0]
    if query_mask is None:
        query_mask = jnp.ones((n,), bool)
    if ref_mask is None:
        ref_mask = jnp.ones((m,), bool)
    r2 = jnp.float32(max_radius) ** 2

    n_tiles = max(1, -(-m // ref_tile))
    m_pad = n_tiles * ref_tile
    pad = m_pad - m
    ref_p = jnp.pad(ref, ((0, pad), (0, 0)))
    rm_p = jnp.pad(ref_mask, (0, pad))
    ref_tiles = ref_p.reshape(n_tiles, ref_tile, dim)
    rm_tiles = rm_p.reshape(n_tiles, ref_tile)

    q2 = jnp.sum(query * query, axis=1)  # [N]
    nm = _n_moments(dim)

    def step(acc, inputs):
        r, rm = inputs
        r2s = jnp.sum(r * r, axis=1)  # [T]
        cross = jnp.dot(r, query.T,
                        precision=jax.lax.Precision.HIGHEST)  # [T, N]
        d2 = r2s[:, None] + q2[None, :] - 2.0 * cross
        w = ((d2 <= r2) & rm[:, None]).astype(jnp.float32)  # [T, N]
        M = jnp.stack(_moment_rows(r.T, dim))  # [nm, T]
        acc = acc + jnp.dot(M, w, precision=jax.lax.Precision.HIGHEST)
        return acc, None

    acc0 = jnp.zeros((nm, n), jnp.float32)
    acc, _ = jax.lax.scan(step, acc0, (ref_tiles, rm_tiles))
    acc = jnp.where(query_mask[None, :], acc, 0.0)
    return _unpack_stats(acc, dim)


# --------------------------------------------------------------------------
# the Triton kernel
# --------------------------------------------------------------------------

def _pca_kernel(lo_ref, nblk_ref, r2_ref, q_ref, r_ref, acc_out, *, dim, tq,
                tr):
    """Sweep radius-PCA: the matcher kernel's window walk
    (``nn_sweep.sweep_window_walk``) with a moment epilogue.  Per query, the
    ``_n_moments(dim)`` sums accumulate in f32 registers as gated
    multiply-adds over each block — no ``pl.dot``: a TF32 moment product
    would wreck ``cov = sxx/cnt - mean^2``."""
    nm = _n_moments(dim)

    def epilogue(acc, d2, r, off):
        w = (d2 <= r2_ref[0]).astype(jnp.float32)  # [tq, tr]
        rows = _moment_rows(r, dim)
        return tuple(acc[a] + jnp.sum(w * rows[a][None, :], axis=1)
                     for a in range(nm))

    init = tuple(jnp.zeros((tq,), jnp.float32) for _ in range(nm))
    qs, acc = sweep_window_walk(lo_ref, nblk_ref, q_ref, r_ref, init,
                                epilogue, tq=tq, tr=tr, dim=dim)
    for a in range(nm):
        acc_out[a, qs] = acc[a]


@functools.partial(jax.jit, static_argnames=("tq", "interpret"))
def pca_sweep_triton(lo, nblk, r2, qp, rp, *, tq: int = TQ,
                     interpret: bool = False):
    """The Triton sweep-PCA kernel on planar inputs (same window contract
    as ``nn_sweep.sweep_knn_triton``).  Returns the moment sums
    ``acc [n_moments, n]``."""
    dim, n_pad = qp.shape
    kern = functools.partial(_pca_kernel, dim=dim, tq=tq, tr=TR)
    return pl.pallas_call(
        kern,
        grid=(n_pad // tq,),
        out_shape=jax.ShapeDtypeStruct((_n_moments(dim), n_pad),
                                       jnp.float32),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS,
                                             num_stages=NUM_STAGES),
        interpret=interpret,
        name="sweep_pca",
    )(lo, nblk, r2, qp, rp)


# --------------------------------------------------------------------------
# sorted-sweep wrapper (the production entry point)
# --------------------------------------------------------------------------

@functools.partial(jax.jit,
                   static_argnames=("max_radius", "q_tile", "W", "use_pallas",
                                    "interpret", "self_neighborhood"))
def _radius_pca_sweep(query, ref, query_mask, ref_mask, max_radius,
                      q_tile=None, W: int = W_MAX,
                      use_pallas: bool = False, interpret: bool = False,
                      self_neighborhood: bool = False):
    """Sorted-sweep radius PCA: sort both clouds by x, each query tile only
    sees the contiguous ref window within ``[tile_min - r, tile_max + r]``
    (same schedule as ``nn_sweep.sweep_knn``; ``q_tile`` defaults to the
    kernel's tile with ``use_pallas``, else 1024).  Returns
    ``(cnt, mean, cov, overflow_tiles)`` — ``overflow_tiles`` counts query
    tiles whose true candidate span exceeded ``W`` (their stats degrade to
    window-truncated; callers should log it, SURVEY "no silent caps")."""
    n, dim = query.shape
    m = ref.shape[0]
    if q_tile is None:
        q_tile = TQ if use_pallas else 1024
    W = min(W, m)
    r2 = float(max_radius) ** 2
    r = jnp.float32(max_radius)

    ref_x = jnp.where(ref_mask, ref[:, 0], BIG)
    ref_order = jnp.argsort(ref_x)
    ref_s = ref[ref_order]
    ref_mask_s = ref_mask[ref_order]
    ref_xs = ref_x[ref_order]

    if self_neighborhood:
        # query IS ref (surface normals over one cloud): one argsort +
        # one gather serve both sides
        q_order = ref_order
        q_sorted, qm_sorted, qx_sorted = ref_s, ref_mask_s, ref_xs
    else:
        q_x = jnp.where(query_mask, query[:, 0], BIG)
        q_order = jnp.argsort(q_x)
        q_sorted = query[q_order]
        qm_sorted = query_mask[q_order]
        qx_sorted = q_x[q_order]
    n_pad = -(-n // q_tile) * q_tile
    pad = n_pad - n
    q_s = jnp.pad(q_sorted, ((0, pad), (0, 0)), constant_values=BIG)
    qm_s = jnp.pad(qm_sorted, (0, pad))
    qx_s = jnp.pad(qx_sorted, (0, pad), constant_values=BIG)

    lo, span, live, overflow = tile_windows(qx_s, qm_s, ref_xs, r, q_tile, W)
    nm = _n_moments(dim)

    if use_pallas:
        nblk = jnp.where(live, -(-jnp.minimum(span, W) // TR), 0)
        rp = planar(ref_s, ref_mask_s, m + -(-W // TR) * TR)
        qp = planar(q_s, qm_s, n_pad)
        acc_sorted = pca_sweep_triton(
            lo, nblk.astype(jnp.int32), jnp.full((1,), r2, jnp.float32),
            qp, rp, tq=q_tile, interpret=interpret)[:, :n]
    else:
        start = jnp.clip(lo, 0, jnp.maximum(m - W, 0))
        n_tiles = n_pad // q_tile
        q_tiles = q_s.reshape(n_tiles, q_tile, dim)
        qm_tiles = qm_s.reshape(n_tiles, q_tile)

        def one_tile(args):
            qt, qmt, s0, lv = args

            def live_fn(_):
                win = jax.lax.dynamic_slice(ref_s, (s0, 0), (W, dim))
                wm = jax.lax.dynamic_slice(ref_mask_s, (s0,), (W,))
                q2 = jnp.sum(qt * qt, axis=1)
                r2s = jnp.sum(win * win, axis=1)
                cross = jnp.dot(win, qt.T,
                                precision=jax.lax.Precision.HIGHEST)
                d2 = r2s[:, None] + q2[None, :] - 2.0 * cross
                w = ((d2 <= r2) & wm[:, None]
                     & qmt[None, :]).astype(jnp.float32)
                M = jnp.stack(_moment_rows(win.T, dim))
                return jnp.dot(M, w, precision=jax.lax.Precision.HIGHEST)

            def dead_fn(_):
                return jnp.zeros((nm, q_tile), jnp.float32)

            return jax.lax.cond(lv, live_fn, dead_fn, None)

        acc_t = jax.lax.map(one_tile, (q_tiles, qm_tiles, start, live))
        acc_sorted = jnp.moveaxis(acc_t, 1, 0).reshape(nm, n_pad)[:, :n]
    # un-sort queries
    inv = jnp.zeros((n,), jnp.int32).at[q_order].set(
        jnp.arange(n, dtype=jnp.int32))
    acc = acc_sorted[:, inv]
    acc = jnp.where(query_mask[None, :], acc, 0.0)
    cnt, mean, cov = _unpack_stats(acc, dim)
    return cnt, mean, cov, overflow


def radius_pca(query, ref, query_mask=None, ref_mask=None, max_radius=1.0,
               engine=None):
    """Radius-neighborhood PCA on the backend's engine
    (``ops.engine.select_engine``): the sorted sweep, or the brute-force
    XLA tiles.

    Returns ``(cnt f32[N], mean f32[N, D], cov f32[N, D, D], overflow i32)``.
    Both clouds are centered on the query cloud's masked mean internally
    (see module docstring on cancellation); outputs are frame-local, i.e.
    ``mean`` is returned in the *original* frame.
    """
    from .engine import select_engine
    engine = engine or select_engine()
    n, dim = query.shape
    self_nn = query is ref and query_mask is ref_mask
    if query_mask is None:
        query_mask = jnp.ones((n,), bool)
    if ref_mask is None:
        ref_mask = query_mask if self_nn else jnp.ones((ref.shape[0],), bool)

    # center on the query cloud's masked mean (cancellation mitigation)
    qsum = jnp.sum(jnp.where(query_mask[:, None], query, 0.0), axis=0)
    qcnt = jnp.maximum(jnp.sum(query_mask.astype(jnp.float32)), 1.0)
    c = qsum / qcnt
    qc = query - c
    rc = ref - c

    if engine.sweep:
        cnt, mean, cov, overflow = _radius_pca_sweep(
            qc, rc, query_mask, ref_mask, float(max_radius),
            use_pallas=True, interpret=engine.interpret,
            self_neighborhood=self_nn)
    else:
        cnt, mean, cov = radius_pca_xla(qc, rc, query_mask, ref_mask,
                                        max_radius)
        overflow = jnp.int32(0)
    return cnt, mean + jnp.where(cnt[:, None] > 0, c[None, :], 0.0), cov, \
        overflow

"""Sorted-sweep windowed KNN: radius-capped search at a fraction of the
brute-force pair count, with contiguous (gather-free) candidate windows.

Idea: sort reference AND query points along one axis (x).  A query tile's
candidates then live in the contiguous ref range whose x lies within
``[tile_min - r, tile_max + r]`` — found with two ``searchsorted``.  Each
query tile runs the brute-force top-k against that window of the sorted
refs, capped at ``W`` refs.  Pair work drops from N*M to N*W.

Two implementations share the wrapper:

  - the GPU kernel (``use_pallas=True``): ONE Pallas launch through Triton
    (``backend="triton"``), one program per query tile of ``tq`` sorted
    queries.  Each program loads its own window start and block count and
    walks its window in blocks of ``tr`` refs with a loop inside the kernel
    (``sweep_window_walk``, shared with the radius-PCA kernel in
    ``ops/pca.py``); the running top-k (k <= 6) stays in registers and only
    ``[k, N]`` is written back.  Distances are exact f32 subtract-first
    squares on the CUDA cores: at D <= 3 a tensor-core dot is the wrong unit,
    and TF32 would misrank neighbours.
  - the portable XLA path (``use_pallas=False``): per-tile ``dynamic_slice``
    windows under ``lax.map``, brute-force top-k per window.

Coordinates are centered on the reference centroid before either path (the
centroid is cached in the presort pack): squared distances are translation
invariant, and small magnitudes keep the f32 error at the map *extent*
instead of the map *position*.

Exactness: guaranteed when every tile's true candidate span fits in ``W``.
The third return value ``overflow`` counts live query tiles whose true
candidate span exceeded ``W`` — those tiles degrade to
nearest-within-window (still radius-verified).  Callers must surface it
(SURVEY "no silent caps"); ``ops.nn.radius_knn`` forwards it to
``utils.tracing.record_overflow``.
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

__all__ = ["sweep_knn", "presort_ref", "sweep_window_walk", "BIG", "W_MAX"]

BIG = 1.0e9  # coordinate sentinel for invalid / padding points
_HUGE = 1.0e30  # distance sentinel inside the kernel

# GPU kernel tiling: ``tq`` sorted queries per program, ``tr`` refs per
# window block (powers of two, as Triton requires).  Small query tiles keep
# each tile's x-span — and so its window — narrow.
TQ = 8
TR = 512
NUM_WARPS = 4
NUM_STAGES = 2
W_MAX = 16384  # default cap on a query tile's window (refs)
_PLANAR_PAD = W_MAX + TR  # window slack of the cached planar ref


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def planar(points: jax.Array, mask: Optional[jax.Array],
           width: int) -> jax.Array:
    """[N, D] + mask -> planar [D, width] with invalid / padding columns at
    BIG (their distance to any real point exceeds every radius)."""
    n, d = points.shape
    pts = points if mask is None else jnp.where(mask[:, None], points, BIG)
    return jnp.full((d, width), BIG, jnp.float32).at[:, :n].set(pts.T)


@jax.jit
def presort_ref(ref: jax.Array, ref_mask: jax.Array):
    """Sort refs by x, invalid refs to the end (x -> +BIG), CENTERED on the
    valid-ref centroid.  The pack ``(ref_s, ref_mask_s, ref_xs, ref_order,
    ref_planar, center)`` feeds ``sweep_knn``'s ``presorted`` argument: the
    reference cloud is static across GN iterations (and across scans until
    a merge), so the sort is hoisted out of the solve loop.

    All spatial fields are centered: ``sweep_knn`` subtracts the same
    ``center`` from the queries, which leaves every pairwise distance
    unchanged while keeping coordinate magnitudes at the map *extent* (tens
    of m) instead of the map *position* (can be km)."""
    m = ref.shape[0]
    maskf = ref_mask.astype(jnp.float32)
    denom = jnp.maximum(jnp.sum(maskf), 1.0)
    center = jnp.sum(jnp.where(ref_mask[:, None], ref, 0.0), axis=0) / denom
    ref_c = ref - center
    ref_x = jnp.where(ref_mask, ref_c[:, 0], BIG)
    ref_order = jnp.argsort(ref_x).astype(jnp.int32)
    ref_s = ref_c[ref_order]
    ref_mask_s = ref_mask[ref_order]
    ref_xs = ref_x[ref_order]
    ref_planar = planar(ref_s, ref_mask_s, _round_up(m, TR) + _PLANAR_PAD)
    return (ref_s, ref_mask_s, ref_xs, ref_order, ref_planar, center)


def tile_windows(qx_s, qm_s, ref_xs, r, tile: int, W: int):
    """Per query tile of the sorted queries: the first candidate ref
    ``lo``, the candidate span ``hi - lo``, liveness, and the overflow count
    (live tiles whose span exceeds ``W``)."""
    n_tiles = qx_s.shape[0] // tile
    qx_t = qx_s.reshape(n_tiles, tile)
    qm_t = qm_s.reshape(n_tiles, tile)
    tile_min = jnp.min(jnp.where(qm_t, qx_t, BIG), axis=1)
    tile_max = jnp.max(jnp.where(qm_t, qx_t, -BIG), axis=1)
    lo = jnp.searchsorted(ref_xs, tile_min - r).astype(jnp.int32)
    hi = jnp.searchsorted(ref_xs, tile_max + r).astype(jnp.int32)
    live = jnp.any(qm_t, axis=1)
    overflow = jnp.sum((live & ((hi - lo) > W)).astype(jnp.int32))
    return lo, hi - lo, live, overflow


# --------------------------------------------------------------------------
# the Triton kernel
# --------------------------------------------------------------------------

def sweep_window_walk(lo_ref, nblk_ref, q_ref, r_ref, init, epilogue, *,
                      tq: int, tr: int, dim: int):
    """Shared body of the sweep kernels: load this program's ``tq`` sorted
    queries, then walk its ref window in blocks of ``tr`` refs.  Each block
    gets exact f32 subtract-first squared distances ``d2 [tq, tr]`` and is
    folded into the carry by ``epilogue(carry, d2, r_rows, offset)``.
    Returns ``(query slice, final carry)``."""
    i = pl.program_id(0)
    qs = pl.ds(pl.multiple_of(i * tq, tq), tq)
    q = [q_ref[d, qs] for d in range(dim)]
    start = lo_ref[i]

    def block(j, carry):
        off = start + j * tr
        r = [r_ref[d, pl.ds(off, tr)] for d in range(dim)]
        d2 = jnp.zeros((tq, tr), jnp.float32)
        for d in range(dim):
            dd = q[d][:, None] - r[d][None, :]
            d2 = d2 + dd * dd
        return epilogue(carry, d2, r, off)

    return qs, jax.lax.fori_loop(0, nblk_ref[i], block, init)


def _knn_kernel(lo_ref, nblk_ref, r2_ref, q_ref, r_ref, d_out, i_out, *, k,
                tq, tr, dim):
    """Running top-k per query, sorted ascending, kept in registers.

    k == 1: one min + argmin per block.  k > 1: pairs beyond the radius are
    dropped first, then up to k rounds extract the block minimum and insert
    it into the sorted list; the rounds stop as soon as no query's block
    minimum beats its current k-th best (usually after one or two rounds
    once the nearest blocks have been seen)."""
    cols = jax.lax.broadcasted_iota(jnp.int32, (tq, tr), 1)

    def insert(bd, bi, v, vi):
        bd, bi = list(bd), list(bi)
        for t in range(k):
            lt = v < bd[t]
            bd[t], v = jnp.where(lt, v, bd[t]), jnp.where(lt, bd[t], v)
            bi[t], vi = jnp.where(lt, vi, bi[t]), jnp.where(lt, bi[t], vi)
        return tuple(bd), tuple(bi)

    def epilogue(carry, d2, r, off):
        bd, bi = carry
        if k == 1:
            m = jnp.min(d2, axis=1)
            a = jnp.argmin(d2, axis=1).astype(jnp.int32) + off
            upd = m < bd[0]
            return ((jnp.where(upd, m, bd[0]),),
                    (jnp.where(upd, a, bi[0]),))
        d2 = jnp.where(d2 <= r2_ref[0], d2, _HUGE)

        def more(s):
            t, _, m, bd_, _ = s
            beats = jnp.sum((m < bd_[k - 1]).astype(jnp.int32))
            return (t < k) & (beats > 0)

        def extract(s):
            t, d2_, m, bd_, bi_ = s
            a = jnp.argmin(d2_, axis=1).astype(jnp.int32)
            bd_, bi_ = insert(bd_, bi_, m, a + off)
            d2_ = jnp.where(cols == a[:, None], _HUGE, d2_)
            return t + 1, d2_, jnp.min(d2_, axis=1), bd_, bi_

        _, _, _, bd, bi = jax.lax.while_loop(
            more, extract, (0, d2, jnp.min(d2, axis=1), bd, bi))
        return bd, bi

    init = (tuple(jnp.full((tq,), _HUGE, jnp.float32) for _ in range(k)),
            tuple(jnp.full((tq,), -1, jnp.int32) for _ in range(k)))
    qs, (bd, bi) = sweep_window_walk(lo_ref, nblk_ref, q_ref, r_ref, init,
                                     epilogue, tq=tq, tr=tr, dim=dim)
    for t in range(k):
        d_out[t, qs] = bd[t]
        i_out[t, qs] = bi[t]


@functools.partial(jax.jit, static_argnames=("k", "tq", "interpret"))
def sweep_knn_triton(lo, nblk, r2, qp, rp, *, k: int, tq: int = TQ,
                     interpret: bool = False):
    """The Triton sweep kernel on planar inputs.

    ``lo``/``nblk``: i32[n_tiles] window start (sorted-ref index) and block
    count (of ``TR``-ref blocks) per query tile; ``r2``: f32[1] squared
    radius; ``qp``: f32[D, n_tiles*tq] sorted queries; ``rp``:
    f32[D, >= max(lo + nblk*TR)] sorted refs.  Returns
    ``(d2 [k, n], idx [k, n])`` with idx into the sorted refs, -1 / HUGE
    where fewer than k candidates were seen."""
    dim, n_pad = qp.shape
    kern = functools.partial(_knn_kernel, k=k, tq=tq, tr=TR, dim=dim)
    return pl.pallas_call(
        kern,
        grid=(n_pad // tq,),
        out_shape=[jax.ShapeDtypeStruct((k, n_pad), jnp.float32),
                   jax.ShapeDtypeStruct((k, n_pad), jnp.int32)],
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS,
                                             num_stages=NUM_STAGES),
        interpret=interpret,
        name="sweep_knn",
    )(lo, nblk, r2, qp, rp)


# --------------------------------------------------------------------------
# wrapper
# --------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnames=("k", "q_tile", "W",
                                             "use_pallas", "interpret",
                                             "assume_sorted"))
def sweep_knn(
    query: jax.Array,  # f32[N, D]
    ref: jax.Array,  # f32[M, D]
    query_mask: Optional[jax.Array] = None,
    ref_mask: Optional[jax.Array] = None,
    k: int = 1,
    max_radius=2.0,
    q_tile: Optional[int] = None,  # query tile; default TQ (kernel) or
                                   # 1024 (XLA path)
    W: int = W_MAX,
    use_pallas: bool = False,
    interpret: bool = False,
    presorted=None,
    assume_sorted: bool = False,
                  # True: `query` is ALREADY in ascending-x (sweep) order
                  # with invalid rows at positions the mask marks — skips
                  # the per-call query gather AND returns results in the
                  # same sorted order (no un-sort).  The ICP engine sorts
                  # its reading once per solve and keeps the whole GN loop
                  # in sweep order (every consumer is an order-invariant
                  # reduction), saving two [N,*] gathers per iteration.
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Radius-capped KNN via the sorted sweep.

    Returns ``(dists2 [N, k], idx [N, k], overflow i32)`` — ``overflow`` is
    the number of live query tiles whose candidate span exceeded ``W``.
    ``presorted`` optionally supplies :func:`presort_ref`'s output (must
    have been built from the same ``ref``/``ref_mask``).  ``use_pallas``
    selects the Triton kernel (``interpret=True`` runs it in the Pallas
    interpreter, for CPU tests)."""
    n, dim = query.shape
    m = ref.shape[0]
    if q_tile is None:
        q_tile = TQ if use_pallas else 1024
    if query_mask is None:
        query_mask = jnp.ones((n,), bool)
    if ref_mask is None:
        ref_mask = jnp.ones((m,), bool)
    W = min(W, m)
    r = jnp.float32(max_radius)

    if presorted is None:
        presorted = presort_ref(ref, ref_mask)
    ref_s, ref_mask_s, ref_xs, ref_order, ref_planar, center = presorted

    # center + sort queries by x; invalid queries to the end
    query = query - center
    q_x = jnp.where(query_mask, query[:, 0], BIG)
    n_pad = -(-n // q_tile) * q_tile
    pad = n_pad - n
    if assume_sorted:
        q_order = inv = None
    else:
        q_order = jnp.argsort(q_x)
        inv = jnp.zeros((n,), jnp.int32).at[q_order].set(
            jnp.arange(n, dtype=jnp.int32))
        query, query_mask, q_x = query[q_order], query_mask[q_order], \
            q_x[q_order]
    q_s = jnp.pad(query, ((0, pad), (0, 0)), constant_values=BIG)
    qm_s = jnp.pad(query_mask, (0, pad))
    qx_s = jnp.pad(q_x, (0, pad), constant_values=BIG)

    lo, span, live, overflow = tile_windows(qx_s, qm_s, ref_xs, r, q_tile, W)

    if use_pallas:
        nblk = jnp.where(live, -(-jnp.minimum(span, W) // TR), 0)
        need = m + -(-W // TR) * TR  # lo <= m, nblk * TR <= ceil(W/TR)*TR
        if ref_planar.shape[1] < need:
            ref_planar = jnp.pad(
                ref_planar, ((0, 0), (0, need - ref_planar.shape[1])),
                constant_values=BIG)
        qp = planar(q_s, qm_s, n_pad)
        d_t, i_t = sweep_knn_triton(
            lo, nblk.astype(jnp.int32), (r * r).reshape(1), qp, ref_planar,
            k=k, tq=q_tile, interpret=interpret)
        d_sorted = d_t[:, :n].T  # [N, k]
        i_sorted = i_t[:, :n].T
        valid = (i_sorted >= 0) & (d_sorted <= r * r) & qm_s[:n, None]
        d_sorted = jnp.where(valid, d_sorted, jnp.inf)
        i_sorted = jnp.where(valid, i_sorted, -1)
    else:
        from .nn import _knn_xla
        start = jnp.clip(lo, 0, jnp.maximum(m - W, 0))
        n_tiles = n_pad // q_tile
        q_tiles = q_s.reshape(n_tiles, q_tile, dim)
        qm_tiles = qm_s.reshape(n_tiles, q_tile)

        def one_tile(args):
            qt, qmt, s0, lv = args

            def live_fn(_):
                win = jax.lax.dynamic_slice(ref_s, (s0, 0), (W, dim))
                wm = jax.lax.dynamic_slice(ref_mask_s, (s0,), (W,))
                d, i = _knn_xla(qt, win, qmt, wm, k=k,
                                max_radius=jnp.float32(max_radius))
                return d, jnp.where(i >= 0, i + s0, -1)

            def dead(_):
                return (jnp.full((q_tile, k), jnp.inf, jnp.float32),
                        jnp.full((q_tile, k), -1, jnp.int32))

            return jax.lax.cond(lv, live_fn, dead, None)

        d_t, i_t = jax.lax.map(one_tile, (q_tiles, qm_tiles, start, live))
        d_sorted = d_t.reshape(n_pad, k)[:n]
        i_sorted = i_t.reshape(n_pad, k)[:n]

    # sorted-ref indices -> original ref ids
    safe = jnp.maximum(i_sorted, 0)
    i_orig = jnp.where(i_sorted >= 0, ref_order[safe].astype(jnp.int32), -1)
    if assume_sorted:
        return d_sorted, i_orig, overflow
    # un-sort the queries
    return d_sorted[inv], i_orig[inv], overflow

"""PointBatch: the device-resident replacement for libpointmatcher's ``DataPoints``.

The reference stores point clouds as a dynamically-sized Eigen matrix of
homogeneous features plus named descriptor rows (see reference
``Mapper.h:17`` and uses like ``Map.cpp:160-175``), and resizes freely
(``concatenate`` / ``conservativeResize``).  Dynamic shapes recompile under
XLA, so here a cloud is a *fixed-capacity, validity-masked* pytree:

  - ``positions``  f32[capacity, dim]   (dim = 2 or 3)
  - ``mask``       bool[capacity]       (True = real point)
  - ``descriptors`` dict[str, f32[capacity, k]]  (e.g. ``normals`` [C,3],
    ``probabilityDynamic`` [C,1])

Per-point sensor time rides as an ordinary f32 descriptor (``t``); absolute
nanosecond timestamps live host-side (Trajectory), since JAX x64 is off.

Capacities are bucketed (next power-of-two-ish) so growth is a re-jit
boundary rather than a per-step recompile.  All device passes (filters,
mapper modules, ICP) consume and produce PointBatch without changing
capacity; compaction happens at explicit boundaries.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["PointBatch", "bucket_capacity", "concatenate", "insert"]

_MIN_CAPACITY = 256


def bucket_capacity(n: int) -> int:
    """Round ``n`` up to a capacity bucket (quarter-power-of-two steps,
    min 256: 256, 320, 384, 448, 512, 640, ...).

    Bucketing keeps the number of distinct compiled shapes logarithmic in the
    largest cloud seen, the static-shape answer to the reference's free
    ``conservativeResize`` (``Map.cpp:169``).  Quarter steps cap padding
    waste at 25% (pure powers of two waste up to 2x, which directly inflates
    every capacity-proportional pass: sorts, scatters, elementwise filters).
    """
    if n <= _MIN_CAPACITY:
        return _MIN_CAPACITY
    p = 1 << (int(n).bit_length() - 1)  # largest power of two <= n
    step = p // 4
    return -(-n // step) * step


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class PointBatch:
    """Fixed-capacity masked point cloud (pytree).

    Functional analog of libpointmatcher ``DataPoints`` as used by the
    reference mapper (features + named descriptors + time channel).
    """

    positions: jax.Array  # f32[C, dim]
    mask: jax.Array  # bool[C]
    descriptors: Dict[str, jax.Array] = dataclasses.field(default_factory=dict)

    # ---------------------------------------------------------------- meta
    @property
    def capacity(self) -> int:
        return self.positions.shape[0]

    @property
    def dim(self) -> int:
        return self.positions.shape[1]

    def count(self) -> jax.Array:
        """Number of valid points (traced scalar)."""
        return jnp.sum(self.mask.astype(jnp.int32))

    def has_descriptor(self, name: str) -> bool:
        return name in self.descriptors

    # ------------------------------------------------------------ builders
    @staticmethod
    def from_numpy(
        positions: np.ndarray,
        descriptors: Optional[Dict[str, np.ndarray]] = None,
        capacity: Optional[int] = None,
    ) -> "PointBatch":
        """Build a padded PointBatch from host arrays of n real points."""
        positions = np.asarray(positions, dtype=np.float32)
        n, dim = positions.shape
        cap = capacity if capacity is not None else bucket_capacity(n)
        if cap < n:
            raise ValueError(f"capacity {cap} < point count {n}")
        pos = np.zeros((cap, dim), dtype=np.float32)
        pos[:n] = positions
        mask = np.zeros((cap,), dtype=bool)
        mask[:n] = True
        desc = {}
        for name, v in (descriptors or {}).items():
            v = np.asarray(v, dtype=np.float32)
            if v.ndim == 1:
                v = v[:, None]
            d = np.zeros((cap, v.shape[1]), dtype=np.float32)
            d[:n] = v
            desc[name] = jnp.asarray(d)
        return PointBatch(jnp.asarray(pos), jnp.asarray(mask), desc)

    @staticmethod
    def empty(capacity: int, dim: int = 3,
              descriptor_dims: Optional[Dict[str, int]] = None) -> "PointBatch":
        desc = {
            name: jnp.zeros((capacity, k), dtype=jnp.float32)
            for name, k in (descriptor_dims or {}).items()
        }
        return PointBatch(
            jnp.zeros((capacity, dim), dtype=jnp.float32),
            jnp.zeros((capacity,), dtype=bool),
            desc,
        )

    # -------------------------------------------------------------- export
    def to_numpy(self) -> Dict[str, np.ndarray]:
        """Compact to host arrays holding only the valid points.

        Returns dict with 'positions' and one entry per descriptor. Order of
        surviving points is preserved.
        """
        mask = np.asarray(self.mask)
        out = {"positions": np.asarray(self.positions)[mask]}
        for name, v in self.descriptors.items():
            out[name] = np.asarray(v)[mask]
        return out

    # ------------------------------------------------------- functional ops
    def with_mask(self, new_mask: jax.Array) -> "PointBatch":
        return dataclasses.replace(self, mask=new_mask & self.mask)

    def replace(self, **kw) -> "PointBatch":
        return dataclasses.replace(self, **kw)

    def with_descriptor(self, name: str, value: jax.Array) -> "PointBatch":
        if value.ndim == 1:
            value = value[:, None]
        desc = dict(self.descriptors)
        desc[name] = value
        return dataclasses.replace(self, descriptors=desc)

    def compact(self) -> "PointBatch":
        """Move valid points to the front (stable), keeping capacity.

        Cumsum + scatter (O(C), no sort) — the device-side analog of the
        reference's in-place shuffles (e.g. ``Map.cpp:158-175``).  Invalid
        slots are zero-filled.
        """
        cap = self.capacity
        dest = jnp.cumsum(self.mask.astype(jnp.int32)) - 1
        tgt = jnp.where(self.mask, dest, cap)  # cap = out of bounds -> drop
        pos = jnp.zeros_like(self.positions).at[tgt].set(
            self.positions, mode="drop")
        mask = jnp.zeros_like(self.mask).at[tgt].set(self.mask, mode="drop")
        desc = {
            k: jnp.zeros_like(v).at[tgt].set(v, mode="drop")
            for k, v in self.descriptors.items()
        }
        return PointBatch(pos, mask, desc)

    def gather(self, idx: jax.Array) -> "PointBatch":
        """Reindex all channels by ``idx`` (mask gathered too)."""
        desc = {k: v[idx] for k, v in self.descriptors.items()}
        return PointBatch(self.positions[idx], self.mask[idx], desc)

    def pad_to(self, capacity: int) -> "PointBatch":
        """Grow capacity (no-op if already >=). Padded tail is masked out."""
        if capacity <= self.capacity:
            return self
        extra = capacity - self.capacity
        pos = jnp.concatenate(
            [self.positions, jnp.zeros((extra, self.dim), self.positions.dtype)])
        mask = jnp.concatenate([self.mask, jnp.zeros((extra,), bool)])
        desc = {
            k: jnp.concatenate([v, jnp.zeros((extra, v.shape[1]), v.dtype)])
            for k, v in self.descriptors.items()
        }
        return PointBatch(pos, mask, desc)

    def align_descriptors(self, names, dims) -> "PointBatch":
        """Ensure descriptors ``names`` exist (zero-filled if missing)."""
        desc = dict(self.descriptors)
        for name, k in zip(names, dims):
            if name not in desc:
                desc[name] = jnp.zeros((self.capacity, k), jnp.float32)
        return dataclasses.replace(self, descriptors=desc)


def insert(dst: PointBatch, src: PointBatch) -> PointBatch:
    """Write ``src``'s valid points into ``dst``'s free slots, in order.

    The fixed-capacity replacement for the reference's growing
    ``DataPoints::concatenate`` (``PointDistanceMapperModule.cpp:49``,
    ``OctreeMapperModule.cpp:35``): ``dst`` is compacted (valid points to
    the front, order preserved), then ``src``'s valid points are scattered
    into slots ``[count, count + n_src)``.  Capacity of the result equals
    ``dst.capacity`` — so the whole merge can live under ``lax.cond`` inside
    one fused per-scan XLA program.  The caller must size ``dst`` with
    enough headroom; points past capacity are dropped.

    Descriptor sets are unioned; channels missing on either side zero-fill.
    """
    cap = dst.capacity
    names = sorted(set(dst.descriptors) | set(src.descriptors))
    dims = {
        n: (dst.descriptors[n] if n in dst.descriptors
            else src.descriptors[n]).shape[1]
        for n in names
    }
    dst = dst.align_descriptors(names, [dims[n] for n in names])
    src = src.align_descriptors(names, [dims[n] for n in names])

    dst = dst.compact()
    n = jnp.sum(dst.mask.astype(jnp.int32))
    n_src = jnp.sum(src.mask.astype(jnp.int32))
    # SURVEY "no silent caps": points dropped past capacity are counted
    # (emitted when a tracing sink is installed; headroom sizing in
    # Map.update_local_point_cloud / the fused path keeps this at 0)
    from .utils.tracing import record_overflow
    record_overflow("points_insert", jnp.maximum(n + n_src - cap, 0))
    slot = jnp.cumsum(src.mask.astype(jnp.int32)) - 1
    tgt = jnp.where(src.mask, n + slot, cap)  # cap -> dropped

    pos = dst.positions.at[tgt].set(src.positions, mode="drop")
    mask = dst.mask.at[tgt].set(src.mask, mode="drop")
    desc = {
        k: dst.descriptors[k].at[tgt].set(src.descriptors[k], mode="drop")
        for k in names
    }
    return PointBatch(pos, mask, desc)


def concatenate(a: PointBatch, b: PointBatch, capacity: Optional[int] = None) -> PointBatch:
    """Concatenate two batches into a batch of given capacity.

    Valid points of ``a`` come first, then valid points of ``b`` (matches
    reference ``DataPoints::concatenate`` ordering used by e.g.
    ``PointDistanceMapperModule.cpp:49``).  Descriptor sets are unioned;
    missing channels zero-fill.  Result is compacted.
    """
    cap = capacity if capacity is not None else a.capacity + b.capacity
    names = sorted(set(a.descriptors) | set(b.descriptors))
    dims = {}
    for n in names:
        if n in a.descriptors:
            dims[n] = a.descriptors[n].shape[1]
        else:
            dims[n] = b.descriptors[n].shape[1]
    a = a.align_descriptors(names, [dims[n] for n in names])
    b = b.align_descriptors(names, [dims[n] for n in names])

    pos = jnp.concatenate([a.positions, b.positions])
    mask = jnp.concatenate([a.mask, b.mask])
    desc = {n: jnp.concatenate([a.descriptors[n], b.descriptors[n]]) for n in names}
    merged = PointBatch(pos, mask, desc).compact()
    if cap >= merged.capacity:
        return merged.pad_to(cap)
    # shrink: keep first `cap` slots (caller guarantees they hold all valid pts)
    idx = jnp.arange(cap)
    return merged.gather(idx)

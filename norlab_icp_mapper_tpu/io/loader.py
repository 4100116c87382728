"""Prefetching scan loader.

The data-loader side of the runtime: scans parse on background threads
(native C++ parser when available) and upload to device ahead of the
pipeline, so per-scan host IO overlaps device compute — the analog of
the reference driving IO from a separate thread (``Map.cpp:29-57``).
"""
from __future__ import annotations

import concurrent.futures
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

from . import read_point_cloud
from ..points import PointBatch

__all__ = ["ScanLoader"]


class ScanLoader:
    """Iterate ``(PointBatch, extra)`` over scan files with lookahead."""

    def __init__(self, paths: Sequence[str],
                 extras: Optional[Sequence] = None,
                 prefetch: int = 2, capacity: Optional[int] = None,
                 workers: int = 2):
        self.paths = list(paths)
        self.extras = list(extras) if extras is not None else [None] * len(paths)
        assert len(self.extras) == len(self.paths)
        self.prefetch = max(1, prefetch)
        self.capacity = capacity
        self._pool = concurrent.futures.ThreadPoolExecutor(max_workers=workers)

    def _load(self, path: str) -> Tuple[PointBatch, int]:
        pos, desc = read_point_cloud(path)
        return (PointBatch.from_numpy(pos, desc, capacity=self.capacity),
                pos.shape[0])

    def __len__(self) -> int:
        return len(self.paths)

    def __iter__(self) -> Iterator[Tuple[PointBatch, int, object]]:
        """Yields ``(batch, n_valid, extra)`` — ``n_valid`` is the real
        (pre-padding) point count, the map-headroom hint for
        ``Mapper.process_input(scan_valid_hint=...)``."""
        futures: List = []
        idx = 0
        n = len(self.paths)
        for _ in range(min(self.prefetch, n)):
            futures.append(self._pool.submit(self._load, self.paths[idx]))
            idx += 1
        for i in range(n):
            batch, n_valid = futures.pop(0).result()
            if idx < n:
                futures.append(self._pool.submit(self._load, self.paths[idx]))
                idx += 1
            yield batch, n_valid, self.extras[i]

    def close(self):
        self._pool.shutdown(wait=False)

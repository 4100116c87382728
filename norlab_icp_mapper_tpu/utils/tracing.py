"""Tracing / profiling / metrics.

The reference has no tracing beyond stdout notices (SURVEY.md section 5);
libpointmatcher's only hook is the inspector (disabled in the example
config).  Here observability is first-class:

  - ``StageTimer``: lightweight wall-clock stage timers with device sync,
    aggregated into percentiles (the "ICP iteration ms p50" bench metric).
  - ``trace(name)``: context manager combining the timer with a
    ``jax.profiler.TraceAnnotation`` so stages show up in device profiles.
  - ``start_profiler(logdir)`` / ``stop_profiler``: wraps
    ``jax.profiler.start_trace`` for on-demand device profiles.
  - ``IterationInspector``: the VTKFileInspector equivalent — records
    per-iteration (residual, overlap) and optionally dumps the transformed
    reading cloud per iteration for offline visualization.
"""
from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict, List, Optional

import jax
import numpy as np

__all__ = ["StageTimer", "trace", "start_profiler", "stop_profiler",
           "IterationInspector", "set_overflow_sink", "record_overflow",
           "overflow_totals"]


# --------------------------------------------------------------------- caps
# SURVEY "no silent caps": every capacity-bounded op (sweep windows, grid
# buckets, insert headroom) reports its overflow counter here.  The sink is
# OFF by default (record_overflow traces to nothing); installing one makes
# subsequently-traced programs emit an async host callback per call site.
# NOTE: already-compiled programs keep the behavior they were traced with —
# install the sink before building the mapper/engine you want to observe.

_overflow_sink = None
_overflow_totals: Dict[str, int] = defaultdict(int)


def set_overflow_sink(fn) -> None:
    """Install ``fn(name: str, value: int)`` as the overflow sink (None to
    disable).  Pass ``set_overflow_sink(accumulate_overflow)`` to count into
    ``overflow_totals()``."""
    global _overflow_sink
    _overflow_sink = fn


def accumulate_overflow(name: str, value: int) -> None:
    _overflow_totals[name] += int(value)


def overflow_totals() -> Dict[str, int]:
    return dict(_overflow_totals)


def record_overflow(name: str, value) -> None:
    """Report a traced overflow counter (no-op unless a sink is installed
    at trace time; emits an async ``jax.debug.callback`` otherwise)."""
    if _overflow_sink is None:
        return

    def _emit(v, _n=name):
        sink = _overflow_sink
        if sink is not None:
            sink(_n, int(v))

    jax.debug.callback(_emit, value)


class StageTimer:
    def __init__(self, sync: bool = True):
        self.sync = sync
        self.records: Dict[str, List[float]] = defaultdict(list)

    @contextlib.contextmanager
    def stage(self, name: str, result=None):
        t0 = time.perf_counter()
        out = {}
        try:
            yield out
        finally:
            if self.sync and out.get("result") is not None:
                jax.block_until_ready(out["result"])
            self.records[name].append(time.perf_counter() - t0)

    def summary(self) -> Dict[str, Dict[str, float]]:
        out = {}
        for name, vals in self.records.items():
            v = np.asarray(vals) * 1e3
            out[name] = {
                "count": len(vals),
                "p50_ms": float(np.percentile(v, 50)),
                "p90_ms": float(np.percentile(v, 90)),
                "total_ms": float(v.sum()),
            }
        return out

    def report(self) -> str:
        lines = [f"{'stage':<24}{'n':>6}{'p50 ms':>10}{'p90 ms':>10}{'total ms':>11}"]
        for name, s in sorted(self.summary().items(),
                              key=lambda kv: -kv[1]["total_ms"]):
            lines.append(f"{name:<24}{s['count']:>6}{s['p50_ms']:>10.1f}"
                         f"{s['p90_ms']:>10.1f}{s['total_ms']:>11.0f}")
        return "\n".join(lines)


@contextlib.contextmanager
def trace(name: str):
    with jax.profiler.TraceAnnotation(name):
        yield


def start_profiler(logdir: str):
    jax.profiler.start_trace(logdir)


def stop_profiler():
    jax.profiler.stop_trace()


class IterationInspector:
    """Per-registration diagnostics (lpm ``VTKFileInspector`` analog).

    The jitted solve returns only final stats; for per-iteration dumps the
    engine is run with ``max_iter=1`` repeatedly by ``inspect_registration``
    — a debug path, not the production solve.
    """

    def __init__(self, dump_dir: Optional[str] = None):
        self.dump_dir = dump_dir
        self.history: List[Dict[str, float]] = []

    def record(self, iteration: int, overlap: float, residual: float,
               cloud=None):
        self.history.append({"iteration": iteration, "overlap": overlap,
                             "residual": residual})
        if self.dump_dir is not None and cloud is not None:
            from ..io.vtk import write_vtk
            import os
            os.makedirs(self.dump_dir, exist_ok=True)
            data = cloud.to_numpy()
            desc = {k: v for k, v in data.items() if k != "positions"}
            write_vtk(
                f"{self.dump_dir}/iter_{iteration:03d}.vtk",
                data["positions"], desc)

"""Multi-host entry: jax.distributed init + process-spanning mesh helpers.

BASELINE.json configs[4] / SURVEY §2.10: multi-host runs at N>=2 hosts are
first-class.  The sharded-map programs (``distributed.py``,
``sharded_map.py``) are already host-count-agnostic — ``shard_map`` over a
mesh built from ``jax.devices()`` spans processes transparently, collectives
ride ICI within a host and DCN across hosts.  What a multi-host launch
additionally needs is:

  1. ``initialize()`` — one call per process before first device use
     (wraps ``jax.distributed.initialize``; env-var driven so the same
     binary works under any launcher),
  2. globally-sharded array construction from per-process data
     (``make_global_array``: ``jax.make_array_from_callback`` so each
     process materializes only ITS shards — a plain ``device_put`` would
     need every process to address every device),
  3. replicated-input discipline: scan/pose/stamp args must be identical
     on every process (they are plain numpy — jit replicates them).

Validated by ``tests/test_multihost.py``: two real OS processes, each with
4 virtual CPU devices, form one 8-shard mesh and run the full sharded
per-scan step; poses must agree bitwise across processes.
"""
from __future__ import annotations

import os
from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

__all__ = ["initialize", "global_mesh", "make_global_array",
           "process_count", "process_index"]


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> None:
    """Connect this process to the multi-host run.

    Must be called BEFORE the first device use (backend init).  Arguments
    default to the standard env vars (``JAX_COORDINATOR_ADDRESS``,
    ``JAX_NUM_PROCESSES``, ``JAX_PROCESS_ID``) so one entry point works
    under mpirun/srun/k8s launchers (on GPU machines nothing is
    auto-detected: pass them or set the env vars).  No-op for single-process runs
    (num_processes == 1 and no coordinator configured).
    """
    coordinator_address = coordinator_address or os.environ.get(
        "JAX_COORDINATOR_ADDRESS")
    if num_processes is None and "JAX_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["JAX_NUM_PROCESSES"])
    if process_id is None and "JAX_PROCESS_ID" in os.environ:
        process_id = int(os.environ["JAX_PROCESS_ID"])
    if coordinator_address is None and (num_processes or 1) == 1:
        return  # single process: nothing to coordinate
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id)


def process_count() -> int:
    return jax.process_count()


def process_index() -> int:
    return jax.process_index()


def global_mesh(axis: str = "cells") -> Mesh:
    """One mesh axis over ALL devices of ALL processes."""
    return Mesh(np.array(jax.devices()), (axis,))


def make_global_array(full: np.ndarray, mesh: Mesh,
                      axis: str = "cells") -> jax.Array:
    """Build a leading-axis-sharded global array from host data.

    ``full`` is the full global value (every process passes the same one);
    each process materializes only the shards its local devices own —
    this is how the sharded map state is (re)loaded on a pod without any
    process addressing remote HBM.
    """
    sharding = NamedSharding(mesh, P(axis))
    return jax.make_array_from_callback(full.shape, sharding,
                                        lambda idx: full[idx])

"""Which implementation runs the radius-capped searches on this backend.

Every radius search of the hot path — the ICP matcher, the DynamicPoints
angular 1-NN, the radius PCA of SurfaceNormal and the sharded solve and
insert gate — asks ``select_engine()`` once while it is traced:

  - ``"triton"`` (GPU): the sorted sweep with its Pallas kernels compiled
    through Triton (``ops/nn_sweep.py``, ``ops/pca.py``);
  - ``"xla"`` (CPU): the spatial grid hash (``ops/gridhash.py``) for k-NN
    and brute-force XLA tiles for PCA and the sharded 1-NN.

An engine is hashable, so jitted functions take it as a static argument.
``interpret=True`` runs the Triton kernels in the Pallas interpreter; no
backend selects it, tests pass it explicitly.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import jax

__all__ = ["Engine", "XLA", "TRITON", "select_engine"]


@dataclasses.dataclass(frozen=True)
class Engine:
    name: str
    interpret: bool = False

    @property
    def sweep(self) -> bool:
        """Sorted-sweep Triton kernels (else grid hash / brute-force XLA)."""
        return self.name == "triton"


XLA = Engine("xla")
TRITON = Engine("triton")

_BY_BACKEND = {"cpu": XLA, "gpu": TRITON}


def select_engine(backend: Optional[str] = None) -> Engine:
    """The engine for ``backend`` (default: ``jax.default_backend()``)."""
    backend = backend or jax.default_backend()
    try:
        return _BY_BACKEND[backend]
    except KeyError:
        raise ValueError(
            f"no radius-search engine for backend {backend!r}; "
            f"supported: {sorted(_BY_BACKEND)}") from None

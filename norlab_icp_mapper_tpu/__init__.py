"""norlab_icp_mapper_tpu — a 2-D/3-D lidar ICP mapping framework in JAX.

Brand-new JAX/XLA/Pallas implementation with the capability surface of
norlab-ulaval/norlab_icp_mapper (+ the libpointmatcher features that mapper
exercises): scan filtering, scan-to-map ICP registration, conditional map
merge through MapperModules, rolling-window tiled map with cell eviction,
and trajectory recording.  See SURVEY.md for the structural analysis of the
reference and the design mapping.
"""

import jax as _jax

# Geometry pipelines are cancellation-sensitive (expanded-form distances,
# normal equations, pose composition).  On NVIDIA GPUs f32 matmuls may run
# in TF32 (about three decimal digits), which injects ~1e-3 relative error
# into 3x3/4x4 transform math — force full f32 everywhere.
_jax.config.update("jax_default_matmul_precision", "highest")

from .points import PointBatch, concatenate, bucket_capacity
from .trajectory import Trajectory
from .cell_manager import CellManager, RAMCellManager, HardDriveCellManager
from .mapper import Mapper
from .map import Map
from .filters import FilterChain, filter_registry
from .mapper_modules import mapper_module_registry
from .icp.engine import ICPEngine, ICPResult
from . import se3, io

__version__ = "0.1.0"

__all__ = [
    "PointBatch", "concatenate", "bucket_capacity", "Trajectory",
    "CellManager", "RAMCellManager", "HardDriveCellManager", "Mapper", "Map",
    "FilterChain", "filter_registry", "mapper_module_registry", "ICPEngine",
    "ICPResult", "se3", "io",
]

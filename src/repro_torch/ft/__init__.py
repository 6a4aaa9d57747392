"""repro_torch.ft — fault tolerance: health, stragglers, chaos, elastic
re-meshing.  The monitors are numpy and `time` only, as in the reference
package; `elastic` re-meshes a logical grid of ranks and restores the
trainer from its checkpoint."""
from .chaos import CORRUPT_VALUE, ChaosInjector
from .elastic import (LogicalMesh, elastic_remesh, logical_mesh,
                      survivors_mesh)
from .health import HealthMonitor, NodeState
from .straggler import StragglerWatchdog

__all__ = ["CORRUPT_VALUE", "ChaosInjector", "HealthMonitor", "LogicalMesh",
           "NodeState", "StragglerWatchdog", "elastic_remesh",
           "logical_mesh", "survivors_mesh"]

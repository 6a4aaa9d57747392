"""repro_torch.ft — fault tolerance of the join loop: health, stragglers,
chaos.  numpy and `time` only, as in the reference package (whose
`ft/elastic.py` re-meshes a JAX trainer and is not ported)."""
from .chaos import CORRUPT_VALUE, ChaosInjector
from .health import HealthMonitor, NodeState
from .straggler import StragglerWatchdog

__all__ = ["CORRUPT_VALUE", "ChaosInjector", "HealthMonitor", "NodeState",
           "StragglerWatchdog"]

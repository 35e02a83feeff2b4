"""Fault-tolerance substrate of the port (``repro.distributed``
counterpart): the liveness and straggler policies the serving engine runs
on its step clock.  The JAX package's mesh and sharding modules, and its
elastic-training supervisor, wait for later slices."""
from repro_torch.distributed.fault_tolerance import (HeartbeatMonitor,
                                                     StragglerPolicy)

__all__ = ["HeartbeatMonitor", "StragglerPolicy"]
